"""The port's train step on (data, model) meshes of ranks against the
reference's one-device trainer: the dense and grouped-query archs on 2x1,
1x2 and 2x2, ZeRO on against off bit for bit, the train sharding rules
spec for spec against ``repro.distributed.sharding``, checkpoints that a
mesh run and a one-device run resume from each other, a faulted mesh run
resumed bit-equal to an unfaulted one, and the CLI's mesh shapes.

One module-scoped spawn of 2x2 gloo ranks runs every mesh job
(``tests/torch_train_mesh_checks.py``); the one-device halves of the
checkpoint checks run here, before and after it.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.distributed import FaultAt, sharding  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import MeshShape, MeshShapeError  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, ShardLayout,  # noqa: E402
                                     init_opt_state, tree_leaves)
from repro_torch.train import steps  # noqa: E402
import torch_threads  # noqa: E402
import torch_train_checks as checks  # noqa: E402
import torch_train_mesh_checks as mc  # noqa: E402

torch_threads.use_threads(2)

ARCHS = ("gpt2-124m", "qwen3-1.7b")
#: every arch, for the sharding rules
ALL = ("gpt2-124m", "qwen3-1.7b", "deepseek-moe-16b", "mamba2-370m",
       "jamba-1.5-large-398b", "deepseek-v2-lite-16b", "olmo-1b",
       "qwen2.5-14b", "qwen3-32b", "internvl2-76b", "whisper-large-v3")
MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))


def _job(ckpt_dir, steps, **kw):
    return launch.TrainJob(arch="gpt2-124m", smoke=True, steps=steps,
                           batch=4, seq=16, device="cpu", ckpt_dir=ckpt_dir,
                           log_every=1, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_mesh")
    dirs = {k: str(root / k) for k in ("to_one", "from_one", "faulted",
                                       "clean")}
    data_cfg = pipeline.with_role_hashes(pipeline.DataConfig())
    # the one-device half before the mesh: a checkpoint at step 2
    launch.train(_job(dirs["from_one"], 2, ckpt_every=2), data_cfg=data_cfg)
    jobs = [mc.steps_job(arch, arch) for arch in ARCHS]
    jobs += [
        {"name": "to_one", "kind": "train", "mesh": "2x1",
         "job": _job(dirs["to_one"], 2, ckpt_every=2),
         "data_cfg": data_cfg},
        {"name": "from_one", "kind": "train", "mesh": "2x1",
         "job": _job(dirs["from_one"], 4, ckpt_every=2),
         "data_cfg": data_cfg},
        {"name": "faulted", "kind": "train", "mesh": "2x1",
         "job": _job(dirs["faulted"], 4, ckpt_every=1),
         "hook": FaultAt(2), "data_cfg": data_cfg},
        {"name": "clean", "kind": "train", "mesh": "2x1",
         "job": _job(dirs["clean"], 4, ckpt_every=1),
         "data_cfg": data_cfg},
    ]
    out = mc.spawn_jobs(jobs)
    # the one-device half after the mesh: resume its step-2 checkpoint
    out["to_one_resumed"] = launch.train(_job(dirs["to_one"], 4,
                                              ckpt_every=2),
                                         data_cfg=data_cfg)
    out["one_device"] = launch.train(_job(None, 4), data_cfg=data_cfg)
    return out


@pytest.fixture(scope="module")
def refs():
    return {arch: mc.ref_run(arch) for arch in ARCHS}


# -- the steps against the reference -------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", mc.SHAPES)
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "no-zero"])
def test_mesh_step_equals_the_reference(runs, refs, arch, shape, zero):
    """Two steps' params, m, v, master, loss, grad_norm and moe_aux
    against the reference's one-device step on the same batches."""
    mc.assert_equals_the_reference(runs[arch][(shape, zero)], refs[arch],
                                   arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", mc.SHAPES)
def test_zero_on_equals_zero_off_bit_for_bit(runs, arch, shape):
    """The gathered states and metrics, and every rank's digest of its
    own shards (the card phase's check)."""
    mc.assert_bit_equal(runs[arch][(shape, True)],
                        runs[arch][(shape, False)])
    assert runs[arch][(shape, "zero_bit_equal")] is True


@pytest.mark.parametrize("shape", ["2x1", "2x2"])
def test_zero_shards_the_optimizer_state_over_data(runs, shape):
    """Under ZeRO a rank holds about 1/D of its state's bytes."""
    got = runs["qwen3-1.7b"]
    on, off = got[(shape, True)]["opt_bytes"], got[(shape, False)][
        "opt_bytes"]
    assert on < 0.6 * off
    assert got[(shape, True)]["opt_bytes_without_zero"] == off


def test_a_step_reduces_gradients_once_a_dtype(runs):
    """On 2x1 a ZeRO step's collectives over ``data`` are the token
    count, the flat gradient reduce-scatter, the norm and the loss sums
    and the parameters' all-gather: a handful a step, not one a leaf."""
    c = runs["gpt2-124m"][("2x1", True)]["counters"]
    n_leaves = len(tree_leaves(runs["gpt2-124m"][("2x1", True)]["params"]))
    assert 0 < c["calls"] <= 2 * 6 < n_leaves


# -- the rules -----------------------------------------------------------------


def _abstract(d, m):
    return jax.sharding.AbstractMesh((d, m), ("data", "model"))


def _walk(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists; a tuple or a
    ``NamedSharding`` is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _pad(spec, n):
    spec = tuple(getattr(spec, "spec", spec))
    return (None,) * (n - len(spec)) + spec


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_rules_equal_the_reference(arch, shape):
    """``param_shardings``, ``zero_shard_spec`` and
    ``opt_state_shardings`` (ZeRO on and off) on the full config's
    per-layer leaves, spec for spec against the reference's functions on
    the same leaves; and each stacked reference leaf's param spec is its
    layers' spec behind the stack dim."""
    from repro.train import steps as ref_steps

    rcfg = ref_configs.get_config(arch)
    cfg = port_configs.get_config(arch)
    shapes = mc.port_shape_tree(rcfg, cfg)
    leaves = dict(_walk(shapes))
    amesh, mesh = _abstract(*shape), MeshShape(*shape)
    ref_p = dict(_walk(ref_sharding.param_shardings(shapes, amesh)))
    ours_p = sharding.param_shardings(shapes, mesh)
    got = dict(_walk(ours_p))
    assert set(got) == set(ref_p) == set(leaves)
    for path, leaf in leaves.items():
        n = len(leaf.shape)
        if not path.endswith("conv_x_b"):
            # the port's table splits the per-layer conv bias as the
            # reference's rule splits its stacked one (checked below)
            assert _pad(got[path], n) == _pad(ref_p[path], n), path
        assert _pad(sharding.zero_shard_spec(got[path], leaf.shape, mesh),
                    n) == _pad(ref_sharding.zero_shard_spec(
                        jax.sharding.PartitionSpec(*_pad(got[path], n)),
                        leaf.shape, amesh), n), path
    for zero in (True, False):
        ref_o = dict(_walk(ref_sharding.opt_state_shardings(
            shapes, ref_sharding.param_shardings(shapes, amesh), amesh,
            zero=zero)))
        ours_o = dict(_walk(sharding.opt_state_shardings(
            shapes, ours_p, mesh, zero=zero)))
        for path, leaf in leaves.items():
            n = len(leaf.shape)
            if not path.endswith("conv_x_b"):
                assert _pad(ours_o[path], n) == _pad(ref_o[path], n), \
                    (path, zero)
    # the reference's stacked leaves: the same split behind the stack dim
    stacked = jax.eval_shape(lambda k: ref_steps.init_model(k, rcfg),
                             jax.random.PRNGKey(0))
    stacked_leaves = dict(_walk(stacked))
    for path, s in _walk(ref_sharding.param_shardings(stacked, amesh)):
        if "blocks" not in path.split("/")[0]:
            continue
        leaf = stacked_leaves[path]
        spec = _pad(s, len(leaf.shape))
        assert spec[0] is None, path
        assert spec[1:] == _pad(sharding.spec_for_path(
            path, leaf.shape[1:], mesh), len(leaf.shape) - 1), path


def test_a_ranks_leaves_are_blocks_of_the_full_tree():
    """``ShardLayout.cut_params``/``cut_state`` on every rank of a 2x2
    mesh tile the full trees, and the state's blocks are the params'
    blocks cut again over ``data``."""
    a = checks.arch("qwen3-1.7b")
    full = a.params()
    for d_i in range(2):
        for m_i in range(2):
            mesh = _FakeRank(2, 2, d_i, m_i)
            lay = ShardLayout(full, mesh, zero=True)
            p = lay.cut_params(full, "cpu")
            for leaf, spec, whole in zip(tree_leaves(p),
                                         tree_leaves(lay.p_specs),
                                         tree_leaves(full)):
                assert leaf.shape == sharding.local_shape(
                    tuple(whole.shape), spec, mesh)


def test_a_rank_draws_its_shards_a_block_at_a_time():
    """``steps.init_shards`` on every rank of a 2x2 mesh, ZeRO on and off,
    equals the full seeded init cut to the rank, params and optimizer
    state bit for bit; ``steps.param_shapes`` gives the full tree's
    shapes and dtypes; and the init hands its blocks over one at a time,
    none of them near the whole model."""
    cfg = port_configs.get_smoke_config("qwen3-1.7b")
    full = steps.init_model(cfg, seed=5, device="cpu")
    shapes = steps.param_shapes(cfg, device="cpu")
    for s, f in zip(tree_leaves(shapes), tree_leaves(full)):
        assert (s.device.type, s.shape, s.dtype) == ("meta", f.shape,
                                                      f.dtype)
    opt_cfg = AdamWConfig()
    full_opt = init_opt_state(full, opt_cfg)
    for d_i in range(2):
        for m_i in range(2):
            for zero in (True, False):
                lay = ShardLayout(shapes, _FakeRank(2, 2, d_i, m_i),
                                  zero=zero)
                got = steps.init_shards(cfg, lay, opt_cfg, seed=5,
                                        device="cpu")
                want = {"params": lay.cut_params(full, "cpu"),
                        "opt": lay.cut_state(full_opt, "cpu")}
                for key in ("m", "v", "master"):
                    assert all(torch.equal(g, w) for g, w in zip(
                        tree_leaves(got["opt"][key]),
                        tree_leaves(want["opt"][key]))), (key, zero)
                assert all(torch.equal(g, w) for g, w in zip(
                    tree_leaves(got["params"]),
                    tree_leaves(want["params"])))
    sizes = []

    def place(path, block):
        sizes.append(sum(t.numel() for t in tree_leaves(block)))
        return block

    steps.init_model(cfg, seed=5, device="cpu", place=place)
    assert sum(sizes) == sum(t.numel() for t in tree_leaves(full))
    assert len(sizes) > 2 * cfg.n_layers and max(sizes) < sum(sizes) / 2


class _FakeRank(MeshShape):
    def __init__(self, data, model, d_i, m_i):
        super().__init__(data, model)
        self.index = {"data": d_i, "model": m_i}

    def axis_index(self, name):
        return self.index.get(name, 0)


# -- checkpoints and faults ------------------------------------------------------


def _params(out):
    return [torch.as_tensor(np.asarray(t)) for t in tree_leaves(
        out["state"]["params"])]


def test_a_mesh_checkpoint_resumes_on_one_device(runs):
    """A 2x1 run's step-2 checkpoint (the unsharded layout), resumed by a
    one-device run to step 4, lands where four one-device steps do."""
    got, want = runs["to_one_resumed"], runs["one_device"]
    assert got["history"][0]["step"] == 2  # resumed, not restarted
    for g, w in zip(_params(got), _params(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **mc.STATE)


def test_a_one_device_checkpoint_resumes_on_a_mesh(runs):
    got, want = runs["from_one"], runs["one_device"]
    assert got["history"][0]["step"] == 2
    for g, w in zip(_params(got), _params(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **mc.STATE)
    np.testing.assert_allclose(got["final_metrics"]["loss"],
                               want["final_metrics"]["loss"], **mc.STATE)


def test_a_mesh_run_reports_its_steps_and_collectives(runs):
    """The trainer on a mesh logs each step's host-clock ms and counts
    its collectives over the steps."""
    clean = runs["clean"]
    assert [h["step"] for h in clean["history"]] == [0, 1, 2, 3]
    assert len(clean["step_ms"]) == 4 and min(clean["step_ms"]) > 0
    assert clean["collectives"]["calls"] > 0
    assert clean["collectives"]["bytes"] > 0


def test_a_run_without_its_state_returns_none():
    out = launch.train(_job(None, 1), keep_state=False)
    assert out["state"] is None and out["step_ms"][0] > 0


@pytest.mark.parametrize("arch, layers, ok", [
    ("qwen3-1.7b", 1, True), ("deepseek-moe-16b", 2, True),
    ("qwen3-1.7b", 0, False), ("whisper-large-v3", 2, False)])
def test_layers_cuts_a_decoder_lm(arch, layers, ok):
    job = launch.TrainJob(arch=arch, layers=layers, device="cpu")
    if not ok:
        with pytest.raises(ValueError):
            launch.job_configs(job)
        return
    cfg = launch.job_configs(job)[0]
    assert cfg.n_layers == layers
    assert cfg.d_model == port_configs.get_smoke_config(arch).d_model


def test_a_faulted_mesh_run_resumes_bit_equal(runs):
    faulted, clean = runs["faulted"], runs["clean"]
    assert faulted["restarts"] == 1 and clean["restarts"] == 0
    for key in ("params", "opt"):
        for f, c in zip(tree_leaves(faulted["state"][key]),
                        tree_leaves(clean["state"][key])):
            np.testing.assert_array_equal(np.asarray(f), np.asarray(c))
    assert faulted["final_metrics"] == clean["final_metrics"]


# -- the CLI's mesh shapes -------------------------------------------------------


@pytest.mark.parametrize("kw, shape", [
    ({"mesh": "2x2"}, (2, 2)), ({"model_axis": 2}, (1, 2)),
    ({"mesh": "2x2", "model_axis": 2}, (2, 2)), ({}, (1, 1))])
def test_mesh_shape_of_a_job(kw, shape):
    assert launch.mesh_shape(launch.TrainJob(**kw)) == shape


@pytest.mark.parametrize("kw", [
    {"mesh": "2x2", "model_axis": 4},  # --mesh and --model-axis disagree
    {"mesh": "3x1"},                   # batch 8 over 3 data ranks
    {"mesh": "1x3"},                   # gpt2 smoke: nothing splits on 3
    {"mesh": "4x1", "microbatches": 4},
    {"mesh": "2-2"},
])
def test_a_mesh_the_rules_cannot_split_raises(kw):
    job = launch.TrainJob(device="cpu", **kw)
    with pytest.raises(MeshShapeError):
        launch.check_mesh(job, launch.job_configs(job)[0])
    argv = ["--device", "cpu"] + [a for k, v in kw.items() for a in (
        "--" + k.replace("_", "-"), str(v))]
    assert launch.main(argv) == 2


def test_rank_rows_tile_each_microbatch():
    batch = {"x": np.arange(8)[:, None] * np.ones((1, 3))}
    for mb in (1, 2):
        parts = [pipeline.rank_rows(batch, r, 2, mb)["x"] for r in range(2)]
        per = 8 // mb
        for i in range(mb):
            got = np.concatenate([p[i * per // 2:(i + 1) * per // 2]
                                  for p in parts])
            np.testing.assert_array_equal(got, batch["x"][i * per:
                                                          (i + 1) * per])


def test_role_hashes_carry_this_processs_batches():
    cfg = port_configs.get_smoke_config("internvl2-76b")
    shape = ShapeConfig("s", 16, 4, "train")
    plain = pipeline.global_batch(cfg, shape, pipeline.DataConfig(seed=3), 5)
    carried = pipeline.global_batch(
        cfg, shape, pipeline.with_role_hashes(pipeline.DataConfig(seed=3)), 5)
    for k in plain:
        np.testing.assert_array_equal(plain[k], carried[k])
