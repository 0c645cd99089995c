"""The port's serving mesh, sharding rules and collectives, held against
the reference's ``repro.launch.mesh`` and ``repro.distributed.sharding``.

The reference's rules are read in a subprocess with four forced host
devices (the conftest forbids forcing devices in-process, and an
``AbstractMesh`` has no ``devices``, which ``serve_param_shardings``
reads), for the smoke and full parameter trees of the served archs (the
two dense ones and deepseek-moe, whose expert stacks split their experts)
on 1x1, 2x1, 1x2 and 2x2; the port's rules must give the same specs exactly.
Parameters cut by ``params_from_numpy(mesh=)`` must concatenate to the
full tree bit for bit.  The collectives run over gloo in spawned ranks;
their sums are exact here (small integers).
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.launch.mesh import MeshShapeError as RefMeshShapeError  # noqa
from repro.launch.mesh import parse_mesh as ref_parse_mesh  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, MeshShapeError,  # noqa: E402
                                     ServeMesh, make_serve_mesh,
                                     parse_mesh)
from repro_torch.models import transformer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((1, 1), (2, 1), (1, 2), (2, 2))
ARCHS = ("gpt2-124m", "qwen3-1.7b", "deepseek-moe-16b", "mamba2-370m",
         "jamba-1.5-large-398b")
BATCHES = (1, 2, 3, 4, 8)
TIMEOUT = 120

_REF_SPECS = """
import json, jax
import repro.configs as c
from repro.distributed import sharding as sh
from repro.launch.mesh import make_serve_mesh
from repro.models import transformer
from repro.train import steps

def entries(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]

def walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v

out = {}
for arch in ("gpt2-124m", "qwen3-1.7b", "deepseek-moe-16b", "mamba2-370m",
             "jamba-1.5-large-398b"):
    for kind in ("smoke", "full"):
        cfg = (c.get_smoke_config(arch) if kind == "smoke"
               else c.get_config(arch))
        params = jax.eval_shape(lambda k: steps.init_model(k, cfg),
                                jax.random.PRNGKey(0))
        cache = jax.eval_shape(lambda: transformer.init_paged_cache(
            cfg, 4, 64, 8, "int8"))
        for d, m in ((1, 1), (2, 1), (1, 2), (2, 2)):
            mesh = make_serve_mesh(d, m)
            specs = dict(walk(jax.tree.map(
                lambda s: s.spec, sh.serve_param_shardings(params, mesh))))
            out[f"{arch}/{kind}/{d}x{m}"] = {
                "shapes": {p: list(l.shape) for p, l in walk(params)},
                "params": {p: entries(s) for p, s in specs.items()},
                "cache": {k: [list(v.shape), entries(sh.paged_cache_spec(
                    k, v.shape, mesh))]
                    for slot in cache["blocks"].values()
                    for k, v in slot.items()},
                "batch": {b: entries(sh.batch_spec(mesh, b, 2))
                          for b in (1, 2, 3, 4, 8)},
            }
print(json.dumps(out))
"""


def _spec(entries):
    return tuple(tuple(a) if isinstance(a, list) else a for a in entries)


@pytest.fixture(scope="module")
def ref_specs():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, "-c", _REF_SPECS], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


# -- mesh construction and typed errors ---------------------------------------


def test_parse_mesh():
    for spec in ("2x2", "1x1", "8X4"):
        assert parse_mesh(spec) == ref_parse_mesh(spec)


@pytest.mark.parametrize("junk", ["", "2", "2x", "x2", "axb", "2x2x2", "0x2",
                                  "2x0", "-1x2"])
def test_parse_mesh_junk_is_typed(junk):
    with pytest.raises(MeshShapeError) as ours:
        parse_mesh(junk)
    with pytest.raises(RefMeshShapeError) as theirs:
        ref_parse_mesh(junk)
    assert str(ours.value) == str(theirs.value)
    assert ours.value.shape is None


def test_mesh_shape_error_is_value_error():
    assert issubclass(MeshShapeError, ValueError)
    with pytest.raises(ValueError):
        parse_mesh("junk")


def test_make_serve_mesh_without_ranks_names_the_launchers():
    with pytest.raises(MeshShapeError) as ei:
        make_serve_mesh(2, 2, device="cpu")
    msg = str(ei.value)
    assert "launch.serve --mesh" in msg and "mesh_check" in msg
    assert ei.value.shape == (2, 2) and ei.value.n_devices == 1
    with pytest.raises(MeshShapeError, match="non-positive"):
        make_serve_mesh(0, 2, device="cpu")


def test_mesh_shape_axes():
    mesh = MeshShape(2, 4)
    assert mesh.axis_names == ("data", "model")
    assert (mesh.axis_size("data"), mesh.axis_size("model"),
            mesh.axis_size("pod"), mesh.size, str(mesh)) == (2, 4, 1, 8,
                                                             "2x4")
    rank = ServeMesh(2, 4, 6, "gloo", torch.device("cpu"), {})
    assert (rank.axis_index("data"), rank.axis_index("model")) == (1, 2)


def test_backend_is_gloo_without_a_card_a_rank():
    assert mesh_mod.choose_backend("cpu", 4) == "gloo"


# -- the sharding rules against the reference's -------------------------------


def _shape_tree(shapes):
    tree = {}
    for path, shape in shapes.items():
        node = tree
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = types.SimpleNamespace(shape=tuple(shape))
    return tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["smoke", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rules_equal_the_reference(ref_specs, arch, kind, shape):
    ref = ref_specs[f"{arch}/{kind}/{shape[0]}x{shape[1]}"]
    mesh = MeshShape(*shape)
    ours = dict(_walk(sharding.serve_param_shardings(
        _shape_tree(ref["shapes"]), mesh)))
    assert ours == {p: _spec(s) for p, s in ref["params"].items()}
    for path, s in ref["shapes"].items():
        if "mamba" in path.split("/") and min(shape) > 1:
            assert ours[path] == ()  # the serve path's 2-D mamba exception
        else:
            assert sharding.spec_for_path(path, tuple(s), mesh) == ours[path]
    for key, (s, spec) in ref["cache"].items():
        assert sharding.paged_cache_spec(key, tuple(s), mesh) == _spec(spec)
    cache = {k: types.SimpleNamespace(shape=tuple(s))
             for k, (s, _) in ref["cache"].items()}
    assert sharding.paged_cache_shardings(cache, mesh) == {
        k: _spec(spec) for k, (_, spec) in ref["cache"].items()}
    for b, spec in ref["batch"].items():
        assert sharding.batch_spec(mesh, int(b), 2) == _spec(spec)
    assert sharding.replicated(mesh) == ()


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_local_slots_follow_batch_spec(shape):
    for batch in BATCHES:
        got = [sharding.local_slots(ServeMesh(*shape, r, "gloo",
                                              torch.device("cpu"), {}),
                                    batch)
               for r in range(shape[0] * shape[1])]
        slots = [list(range(batch))[s] for s in got]
        if batch % shape[0]:
            assert all(s == list(range(batch)) for s in slots)
        else:  # each data row its contiguous block, model ranks alike
            per = batch // shape[0]
            for r, s in enumerate(slots):
                d = r // shape[1]
                assert s == list(range(d * per, (d + 1) * per))


# -- weights carried across ---------------------------------------------------


def _tree(arch):
    cfg = ref_configs.get_smoke_config(arch)
    return jax.tree.map(np.asarray, ref_steps.init_model(
        jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rank_shards_concatenate_to_the_full_tree(arch, shape):
    cfg = port_configs.get_smoke_config(arch)
    tree = _tree(arch)
    full = transformer.params_from_numpy(tree, cfg, "cpu")
    D, M = shape
    shards = [transformer.params_from_numpy(
        tree, cfg, "cpu", mesh=ServeMesh(D, M, r, "gloo",
                                         torch.device("cpu"), {}))
              for r in range(D * M)]
    specs = sharding.serve_param_shardings(full, MeshShape(D, M))
    for path, spec in _walk_all(specs):
        want = _get(full, path)
        # every data row holds the same shards
        for r in range(M, D * M):
            assert torch.equal(_get(shards[r], path),
                               _get(shards[r % M], path)), path
        parts = [_get(shards[m], path) for m in range(M)]
        if "model" in spec:
            got = torch.cat(parts, dim=spec.index("model"))
        else:
            assert all(torch.equal(p, want) for p in parts), path
            got = parts[0]
        assert torch.equal(got, want), path
        assert all(p.is_contiguous() for p in parts)


def _walk_all(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _walk_all(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _get(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_init_lm_shards_are_the_full_init_cut(shape):
    cfg = port_configs.get_smoke_config("qwen3-1.7b")
    full = transformer.init_lm(cfg, seed=3, device="cpu")
    for r in range(shape[0] * shape[1]):
        rank = ServeMesh(*shape, r, "gloo", torch.device("cpu"), {})
        ours = transformer.init_lm(cfg, seed=3, device="cpu", mesh=rank)
        want = sharding.local_params(full, rank)
        for path, leaf in _walk_all(ours):
            assert torch.equal(leaf, _get(want, path)), path


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_paged_cache_splits_heads_keeps_scales(shape):
    cfg = port_configs.get_smoke_config("gpt2-124m")  # 4 KV heads
    mesh = MeshShape(*shape)
    cache = transformer.init_paged_cache(cfg, 2, 64, 8, "cpu",
                                         kv_dtype="int8", mesh=mesh)
    full = transformer.init_paged_cache(cfg, 2, 64, 8, "cpu",
                                        kv_dtype="int8")
    assert cache["k"].shape == full["k"].shape[:3] + (4 // shape[1], 16)
    assert cache["k_scale"].shape == full["k_scale"].shape
    assert all(not t.any() for t in cache.values())


# -- collectives over spawned gloo ranks -------------------------------------


def _collectives(mesh):
    x = torch.full((2, 3), float(mesh.rank + 1))
    out = {}
    for axis in ("data", "model"):
        out[axis] = {
            "gather": mesh.gather(x * 10 + mesh.axis_index(axis), axis,
                                  dim=1).tolist(),
            "sum": mesh.sum(x, axis).tolist(),
            "max": mesh.max(x, axis).tolist(),
        }
    out["counters"] = mesh.comm.counters()
    out["backend"] = mesh.backend
    return out


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 gives up")
    mesh.sum(torch.ones(1), "data")  # would wait for rank 1 forever
    return "unreachable"


def test_collectives_over_a_2x2_mesh_of_gloo_ranks():
    got = mesh_mod.spawn(_collectives, 2, 2, device="cpu", timeout=TIMEOUT)
    # rank 0 at (0, 0): data column {0, 2}, model row {0, 1}
    assert got["data"]["sum"] == [[4.0] * 3] * 2
    assert got["data"]["max"] == [[3.0] * 3] * 2
    assert got["data"]["gather"] == [[10.0] * 3 + [31.0] * 3] * 2
    assert got["model"]["sum"] == [[3.0] * 3] * 2
    assert got["model"]["max"] == [[2.0] * 3] * 2
    assert got["model"]["gather"] == [[10.0] * 3 + [21.0] * 3] * 2
    assert got["backend"] == "gloo"
    assert got["counters"] == {"calls": 6, "bytes": 6 * 24,
                               "host_bytes": 0}


def test_a_failing_rank_stops_the_mesh():
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        mesh_mod.spawn(_fail_on_rank_1, 2, 1, device="cpu", timeout=60)
