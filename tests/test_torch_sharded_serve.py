"""Tensor-parallel serving in the port, mirroring
``tests/test_sharded_serve.py``: the mesh never shows in the tokens.

In process, a one-rank gloo group gives the 1x1 corner: the same engine
code path as every mesh, with streams equal to the unsharded port's and
to the JAX engine's on the reference's weights.  The multi-rank shapes
{2x1, 1x2, 2x2} run as a subprocess through the port's
:mod:`repro_torch.serve.mesh_check`, whose ranks it spawns over gloo; its
streams must equal the unsharded port's and, in f32, the JAX unsharded
engine's for the same traffic, token for token.  With int8 pools the port
attends the new token's quantized row where the JAX cell merges it
unquantized (a difference ROADMAP section 3 tolerates), so there the JAX
engine is held to the first token of each stream only.  The int8 pools
are held by the mesh check's own rule: scales the same bits on every
rank, codes within one step and scales within 1e-2 of the unsharded pools
(data-sharded matmuls and row-parallel sums move K/V by a few ulps before
they are quantized, and a code those ulps flip moves later rows by up to
one quantization step).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import mesh_check  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("gpt2-124m", "qwen3-1.7b", "deepseek-moe-16b")
#: the mesh check's workloads here: six it serves by default and the
#: chunked int8 one with prefix sharing
WORKLOADS = ("gpt2", "qwen3", "moe", "gpt2-int8-shared",
             "qwen3-int8-shared-chunked", "gpt2-spec", "gpt2-spec-adapt")
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        rcfg = ref_configs.get_smoke_config(arch)
        cfg = port_configs.get_smoke_config(arch)
        rp = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
        tree = jax.tree.map(np.asarray, rp)
        _MODELS[arch] = (rcfg, rp, cfg, tree)
    return _MODELS[arch]


@pytest.fixture(scope="module")
def mesh_1x1():
    """A one-rank gloo group in this process and its 1x1 mesh."""
    mesh_mod.init_rank(0, 1, mesh_mod.free_port(), "gloo", timeout=60)
    try:
        yield mesh_mod.make_serve_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _traffic(vocab, n=4, seed=0, prefix_len=0):
    """The reference test's traffic."""
    rng = np.random.default_rng(seed)
    prefix = (rng.integers(0, vocab, size=prefix_len).astype(np.int32)
              if prefix_len else None)
    out = []
    for uid in range(n):
        p = rng.integers(0, vocab, size=int(rng.integers(3, 9))).astype(
            np.int32)
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append((uid, p))
    return out


def _serve(arch, mesh=None, reference=False, hook=None, **kw):
    rcfg, rp, cfg, tree = _model(arch)
    kw = dict(max_batch=2, max_len=64, block_size=8, **kw)
    if reference:
        eng = ref_engine.ServeEngine(rcfg, rp, scheduler="continuous", **kw)
        Req = ref_engine.Request
    else:
        params = transformer.params_from_numpy(tree, cfg, "cpu", mesh=mesh)
        eng = ServeEngine(cfg, params, device="cpu", mesh=mesh, **kw)
        Req = Request
    if hook is not None:
        eng.add_step_hook(hook)
    prefix = 16 if kw.get("share_prefixes") else 0
    for uid, p in _traffic(cfg.vocab, prefix_len=prefix):
        eng.submit(Req(uid=uid, prompt=p, max_new_tokens=6))
    done = eng.run_until_drained()
    return {u: [int(t) for t in r.generated] for u, r in done.items()}, eng


def _assert_like_jax(got, jx, kv_dtype):
    """Equal streams in f32; with int8 pools, equal first tokens."""
    if kv_dtype == "f32":
        assert got == jx
    else:
        assert {u: s[:1] for u, s in got.items()} == \
            {u: s[:1] for u, s in jx.items()}


KWS = [dict(), dict(prefill_chunk=4),
       dict(kv_dtype="int8", share_prefixes=True),
       dict(kv_dtype="int8", share_prefixes=True, prefill_chunk=4)]
KW_IDS = ["f32", "f32-chunked", "int8-shared", "int8-shared-chunked"]


# -- mesh 1x1: the in-process golden corner -----------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw", KWS, ids=KW_IDS)
def test_streams_match_unsharded_and_jax(mesh_1x1, arch, kw):
    base, _ = _serve(arch, **kw)
    jx, _ = _serve(arch, reference=True, **kw)
    got, eng = _serve(arch, mesh=mesh_1x1, **kw)
    assert got == base
    _assert_like_jax(got, jx, kw.get("kv_dtype", "f32"))
    assert eng.mesh_shape == "1x1"
    st = eng.stats()
    assert st["mesh"] == "1x1" and st["mesh_devices"] == 1
    assert st["device_lane_utilization"] == pytest.approx(
        st["slot_utilization"])
    if kw.get("share_prefixes"):
        assert st["shared_block_hits"] > 0


def test_device_lane_utilization_pinned(mesh_1x1):
    _, eng = _serve("gpt2-124m", mesh=mesh_1x1)
    st = eng.stats()
    assert st["device_lane_utilization"] == pytest.approx(
        int(eng.device_busy_lane_steps.sum())
        / (st["fused_steps"] * eng.max_batch))
    _, jeng = _serve("gpt2-124m", reference=True)
    assert st["device_lane_utilization"] == pytest.approx(
        jeng.stats()["device_lane_utilization"])


def test_block_pool_invariants_under_sharded_cow(mesh_1x1):
    checked = [0]

    def check(engine, busy):
        engine._live["pool"].check_invariants()
        checked[0] += 1
        return False

    _, eng = _serve("gpt2-124m", mesh=mesh_1x1, hook=check, kv_dtype="int8",
                    share_prefixes=True)
    assert checked[0] > 0 and eng.stats()["shared_block_hits"] > 0


def test_mesh_requires_continuous(mesh_1x1):
    _, _, cfg, tree = _model("gpt2-124m")
    params = transformer.params_from_numpy(tree, cfg, "cpu")
    with pytest.raises(ValueError, match="continuous"):
        ServeEngine(cfg, params, max_batch=2, max_len=64, scheduler="wave",
                    mesh=mesh_1x1, device="cpu")


def test_mesh_refusals_name_their_items(mesh_1x1):
    _, _, cfg, tree = _model("gpt2-124m")
    params = transformer.params_from_numpy(tree, cfg, "cpu")
    # speculation (1.13) is ported: the reference's message for a
    # missing draft model
    with pytest.raises(ValueError, match="requires a draft model"):
        ServeEngine(cfg, params, spec_k=2, mesh=mesh_1x1, device="cpu")
    enc = dataclasses.replace(cfg, is_encoder_decoder=True)
    with pytest.raises(ValueError, match=r"1\.18"):
        ServeEngine(enc, params, mesh=mesh_1x1, device="cpu")
    with pytest.raises(ValueError, match="'data', 'model'"):
        ServeEngine(cfg, params, mesh=type("M", (), {"axis_names": ("x",)})(),
                    device="cpu")


# -- the cross-mesh check, in a subprocess ------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_streams(name, requests, max_new):
    """The JAX unsharded engine on the mesh check's traffic."""
    _, arch, over = next(w for w in mesh_check.DEFAULT_WORKLOADS
                         if w[0] == name)
    rcfg, rp, _, _ = _model(arch)
    over = dict(over)
    prefix_len = over.pop("shared_prefix_len", 0)
    if "draft" in over:  # the draft's weights are the target's seed's
        dcfg, dp, _, _ = _model(over.pop("draft"))
        over.update(draft_cfg=dcfg, draft_params=dp)
    eng = ref_engine.ServeEngine(rcfg, rp, max_batch=2, max_len=64,
                                 scheduler="continuous", block_size=8,
                                 **over)
    rng = np.random.default_rng(0)
    prefix = (rng.integers(0, rcfg.vocab, size=prefix_len).astype(np.int32)
              if prefix_len else None)
    for uid in range(requests):
        p = rng.integers(0, rcfg.vocab, size=int(rng.integers(3, 10))
                         ).astype(np.int32)
        if prefix is not None:
            p = np.concatenate([prefix, p])
        eng.submit(ref_engine.Request(uid=uid, prompt=p,
                                      max_new_tokens=max_new))
    return {str(u): [int(t) for t in r.generated]
            for u, r in eng.run_until_drained().items()}


@pytest.fixture(scope="module")
def verdict(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    for arch in ARCHS:
        np.savez(d / f"{arch}.npz", **_flat(_model(arch)[3]))
    out = d / "verdict.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.mesh_check", "--device",
         "cpu", "--meshes", "none,1x1,2x1,1x2,2x2", "--workloads",
         ",".join(WORKLOADS), "--requests", "3", "--max-new", "6",
         "--weights", str(d), "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(out.read_text())


def test_cross_mesh_streams_equal_the_jax_engine(verdict):
    assert verdict["ok"], verdict["diffs"]
    assert verdict["shapes"] == ["none", "1x1", "2x1", "1x2", "2x2"]
    assert set(verdict["workloads"]) == set(WORKLOADS)
    assert not verdict["refused"]
    for name, per in verdict["workloads"].items():
        assert len({d["digest"] for d in per.values()}) == 1, (name, per)
        kv_dtype = next(w[2] for w in mesh_check.DEFAULT_WORKLOADS
                        if w[0] == name).get("kv_dtype", "f32")
        _assert_like_jax(verdict["streams"][name], _jax_streams(name, 3, 6),
                         kv_dtype)
        assert per["2x2"]["mesh_devices"] == 4
        assert per["2x1"]["device_lane_utilization"] <= \
            per["none"]["device_lane_utilization"] + 1e-9
        assert per["1x1"]["device_lane_utilization"] == pytest.approx(
            per["none"]["device_lane_utilization"])
        for shape in ("1x1", "2x1", "1x2", "2x2"):
            ranks = per[shape]["ranks"]
            assert len(ranks) == per[shape]["mesh_devices"]
            assert {r["backend"] for r in ranks} == {"gloo"}
            # on the CPU nothing is staged: gloo runs on host tensors
            assert all(r["host_bytes"] == 0 for r in ranks)
            if shape != "1x1":
                assert all(r["calls"] > 0 for r in ranks)


def test_cross_mesh_int8_pools(verdict):
    for name in ("gpt2-int8-shared", "qwen3-int8-shared-chunked"):
        for shape in ("1x1", "2x1", "1x2", "2x2"):
            pools = verdict["workloads"][name][shape]["pools"]
            assert pools["scales_replicated"], (name, shape)
            assert pools["codes_max_diff"] <= 1, (name, shape)
            assert pools["scales_max_rel_diff"] <= \
                mesh_check.INT8_SCALE_RTOL, (name, shape)
        # the 1x1 mesh runs the unsharded arithmetic: bit-equal pools
        one = verdict["workloads"][name]["1x1"]["pools"]
        assert one["codes_differ"] == 0 and one["scales_max_rel_diff"] == 0


def test_mesh_check_refuses_what_the_port_lacks(tmp_path, capsys):
    """The port now lacks none of the mesh check's workloads: the
    speculative ones (1.13) are served by default, on the unsharded
    baseline here, with drafts."""
    assert {"gpt2-spec", "gpt2-spec-adapt"} <= set(mesh_check.SERVED)
    out = tmp_path / "verdict.json"
    code = mesh_check.main(["--device", "cpu", "--meshes", "none",
                            "--workloads", "gpt2-spec,gpt2-spec-adapt",
                            "--out", str(out)])
    verdict = json.loads(out.read_text())
    assert code == 0 and verdict["ok"] and not verdict["refused"]
    for name in ("gpt2-spec", "gpt2-spec-adapt"):
        assert verdict["workloads"][name]["none"]["drafted_tokens"] > 0


def test_cli_mesh_serves_the_unsharded_streams(tmp_path):
    argv = ["--device", "cpu", "--requests", "3", "--max-new", "4"]
    outs = {}
    for mesh in (None, "1x2"):
        out = tmp_path / f"{mesh}.json"
        extra = [] if mesh is None else ["--mesh", mesh]
        assert serve_cli.main(argv + extra + ["--out", str(out)]) == 0
        outs[mesh] = json.loads(out.read_text())
    base, tp = outs[None], outs["1x2"]
    assert [r["tokens"] for r in tp["requests"]] == \
        [r["tokens"] for r in base["requests"]]
    assert tp["mesh"] == "1x2" and tp["mesh_backend"] == "gloo"
    assert [r["local_kv_heads"] for r in tp["mesh_ranks"]] == [2, 2]
    assert tp["stats"]["mesh_devices"] == 2


def test_cross_mesh_where_the_rules_fall_back(tmp_path):
    """1x4: qwen3 smoke's 2 KV heads do not divide over 4 model ranks, so
    the pools stay whole and wk/wv split mid-head (their outputs are
    gathered, the decode runs unsharded on all heads, and each rank keeps
    its rows of the attention output for the row-parallel wo).  4x1: 2
    slots do not divide over 4 data ranks, so every rank computes every
    slot.  The streams still equal the unsharded engine's."""
    out = tmp_path / "verdict.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.mesh_check", "--device",
         "cpu", "--meshes", "none,1x4,4x1", "--workloads",
         "qwen3,qwen3-int8-shared-chunked", "--requests", "3", "--max-new",
         "6", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verdict = json.loads(out.read_text())
    assert verdict["ok"], verdict["diffs"]
    for name, per in verdict["workloads"].items():
        assert len({d["digest"] for d in per.values()}) == 1, (name, per)
        assert per["4x1"]["device_lane_utilization"] == pytest.approx(
            per["none"]["device_lane_utilization"])
    pools = verdict["workloads"]["qwen3-int8-shared-chunked"]["1x4"]["pools"]
    assert pools["scales_replicated"] and pools["codes_max_diff"] <= 1
