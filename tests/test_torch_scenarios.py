"""The port's scenario matrix, traffic and fault plans against
``repro.scenarios``, the contract tests of ``tests/test_scenarios.py``
that run no engine, and the port's CLI.

* Matrix expansion: the same cell ids, traffic keys and seeds as the
  reference for the smoke matrix, the full matrix and one spec on each of
  the chunk, sharing, speculate and mesh axes; a spec's JSON is read by
  both packages.
* Traces: ``sample_trace`` (and ``MalformedPlan.mutate_trace``) equal the
  reference's byte for byte for every cell of ``full_matrix()``.
* The CLI prints the reference CLI's cell ids, gates on the CPU, exits 2
  on a glob that matches nothing, and records its cells in the perf
  ledger with ``--record``.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
import repro.scenarios as ref  # noqa: E402
from repro.scenarios import faults as ref_faults  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.launch.mesh import MeshShapeError  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    ArrivalSpec,
    EosSpec,
    MatrixSpec,
    PromptSpec,
    SLOSpec,
    full_matrix,
    get_plan,
    sample_trace,
    smoke_matrix,
)
from repro_torch.scenarios import faults as port_faults  # noqa: E402
from torch_scenario_checks import (  # noqa: E402
    one_cell as _cell,
    tiny_matrix as _tiny_matrix,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


#: one spec on each axis the smoke matrix leaves at its default
AXES = {
    "chunk": dict(schedulers=["continuous", "wave"], prefill_chunks=[1, 8],
                  prefill_budget=8, faults=["none", "preempt"]),
    "sharing": dict(schedulers=["continuous", "wave"],
                    prompt_sharing=["none", "shared", "shared-off"]),
    "speculate": dict(schedulers=["continuous", "wave"], speculate=[0, 4],
                      prefill_chunks=[1, 4]),
    "mesh": dict(schedulers=["wave", "continuous"],
                 meshes=[None, "1x1", "2x2"],
                 faults=["none", "device-loss"]),
}


def _both(name):
    """(port spec, reference spec) of a named matrix or an AXES spec."""
    if name == "smoke":
        return smoke_matrix(), ref.smoke_matrix()
    if name == "full":
        return full_matrix(), ref.full_matrix()
    d = _tiny_matrix(**AXES[name]).to_dict()
    return MatrixSpec.from_dict(d), ref.MatrixSpec.from_dict(d)


def _keys(cells):
    return [(c.cell_id, c.traffic_key, c.seed, c.ledger_key,
             c.twin().cell_id, c.chunk_twin().cell_id,
             c.sharing_twin().cell_id, c.spec_twin().cell_id,
             c.mesh_twin().cell_id) for c in cells]


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["smoke", "full", *AXES])
def test_cells_equal_the_reference(name):
    port, refm = _both(name)
    mine, theirs = port.cells(), refm.cells()
    assert mine and _keys(mine) == _keys(theirs)
    assert [dataclasses.asdict(c) for c in mine] == [
        dataclasses.asdict(c) for c in theirs]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_json_spec_is_read_by_both_packages(tmp_path, writer):
    spec = _tiny_matrix(**AXES["mesh"], prompt_sharing=["none", "shared"],
                        arrivals=[ArrivalSpec(kind="replay",
                                              steps=(0, 3, 9))])
    d = (spec.to_dict() if writer == "port"
         else ref.MatrixSpec.from_dict(spec.to_dict()).to_dict())
    p = tmp_path / "m.json"
    p.write_text(json.dumps(d))
    assert _keys(MatrixSpec.from_json(str(p)).cells()) == _keys(
        ref.MatrixSpec.from_json(str(p)).cells()) == _keys(spec.cells())
    assert ref.load_matrix(str(p)).to_dict() == d


def _vocab(arch):
    vocab = port_configs.get_smoke_config(arch).vocab
    assert vocab == ref_configs.get_smoke_config(arch).vocab
    return vocab


def _same_trace(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert (a.uid, a.arrive_step, a.max_new_tokens, a.eos_id,
                a.malformed) == (b.uid, b.arrive_step, b.max_new_tokens,
                                 b.eos_id, b.malformed)
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert a.prompt.tobytes() == b.prompt.tobytes()


def test_sample_trace_equals_the_reference_on_the_full_matrix():
    """Every cell of the full matrix: the trace and, for malformed cells,
    the mutated trace, byte for byte."""
    cells = full_matrix().cells()
    ref_cells = ref.full_matrix().cells()
    assert len(cells) == len(ref_cells)
    by_key = {}
    for cell, rcell in zip(cells, ref_cells):
        vocab = _vocab(cell.arch)
        key = (cell.traffic_key, cell.seed, cell.fault)
        if key in by_key:
            continue  # the same traffic and fault: the same trace
        mine = sample_trace(cell, vocab)
        theirs = ref.sample_trace(rcell, vocab)
        _same_trace(mine, theirs)
        if cell.fault == "malformed":
            _same_trace(get_plan("malformed").mutate_trace(mine, cell),
                        ref.get_plan("malformed").mutate_trace(theirs,
                                                               rcell))
        by_key[key] = True
    assert len(by_key) > 100


def test_fault_plans_equal_the_reference():
    assert sorted(port_faults.PLANS) == sorted(ref_faults.PLANS)
    for name, plan in port_faults.PLANS.items():
        rplan = ref_faults.PLANS[name]
        assert dataclasses.asdict(plan) == dataclasses.asdict(rplan)
        assert plan.resilient == rplan.resilient
    for cell, rcell in zip(full_matrix().cells()[:64],
                           ref.full_matrix().cells()[:64]):
        for name in port_faults.PLANS:
            assert get_plan(name).applies_to(cell) == \
                ref.get_plan(name).applies_to(rcell)


# ---------------------------------------------------------------------------
# matrix expansion + seeding (tests/test_scenarios.py)
# ---------------------------------------------------------------------------


def test_expansion_is_deterministic():
    a, b = smoke_matrix().cells(), smoke_matrix().cells()
    assert [c.cell_id for c in a] == [c.cell_id for c in b]
    assert [c.seed for c in a] == [c.seed for c in b]
    assert len(a) == len({c.cell_id for c in a}), "cell ids must be unique"


def test_preempt_skipped_under_wave_scheduler():
    ids = [c.cell_id for c in smoke_matrix().cells()]
    assert any("/continuous/" in i and i.endswith("/preempt") for i in ids)
    assert not any("/wave/" in i and i.endswith("/preempt") for i in ids)


def test_twin_and_cross_scheduler_share_traffic_seed():
    spec = _tiny_matrix(schedulers=["continuous", "wave"],
                        faults=["none", "malformed"])
    cells = {c.cell_id: c for c in spec.cells()}
    assert len({c.seed for c in cells.values()}) == 1, (
        "scheduler and fault must be outside the traffic key"
    )
    faulted = next(c for c in cells.values() if c.fault == "malformed")
    twin = faulted.twin()
    assert twin.fault == "none" and twin.seed == faulted.seed


def test_matrix_spec_json_roundtrip(tmp_path):
    spec = smoke_matrix()
    p = tmp_path / "m.json"
    p.write_text(json.dumps(spec.to_dict()))
    back = MatrixSpec.from_json(str(p))
    assert [c.cell_id for c in back.cells()] == [
        c.cell_id for c in spec.cells()]
    assert [c.seed for c in back.cells()] == [c.seed for c in spec.cells()]


def test_trace_is_reproducible_and_twin_identical():
    cell = _cell("preempt")
    t1, t2 = sample_trace(cell, vocab=256), sample_trace(cell, vocab=256)
    tw = sample_trace(cell.twin(), vocab=256)
    for other in (t2, tw):
        _same_trace(t1, other)


def test_trace_well_formed_by_construction():
    cell = _cell(prompts=[PromptSpec(kind="uniform", lo=4, hi=100)])
    for spec in sample_trace(cell, vocab=256):
        assert 1 <= len(spec.prompt) <= cell.max_len - cell.max_new
        assert 1 <= spec.max_new_tokens <= cell.max_new


def test_arrival_processes():
    rng = np.random.default_rng
    from repro_torch.scenarios.traffic import _arrival_steps

    bursty = _arrival_steps(ArrivalSpec(kind="bursty", burst=2, gap=10),
                            6, rng(0))
    assert bursty == [0, 0, 10, 10, 20, 20]
    replay = _arrival_steps(ArrivalSpec(kind="replay", steps=(5, 0, 9)),
                            5, rng(0))
    assert replay == sorted(replay) and replay[0] == 0
    poisson = _arrival_steps(ArrivalSpec(kind="poisson", rate=0.5),
                             8, rng(0))
    assert poisson[0] == 0 and poisson == sorted(poisson)


def test_eos_cap_distribution():
    cell = _cell(eos=[EosSpec(p_early=0.0)])
    assert all(s.max_new_tokens == cell.max_new
               for s in sample_trace(cell, vocab=64))
    ragged = _cell(eos=[EosSpec(p_early=0.6)], requests=8)
    caps = {s.max_new_tokens for s in sample_trace(ragged, vocab=64)}
    assert min(caps) >= 1 and len(caps) > 1, "p_early=0.6 should go ragged"


def test_slo_check_floors_and_ceilings():
    slo = SLOSpec(min_tok_s=1.0, max_p95_latency_s=2.0,
                  max_ttft_p95_s=2.0, min_slot_utilization=0.5)
    ok = {"tok_s": 5.0, "p95_latency_s": 0.1, "ttft_p95_s": 0.1,
          "slot_utilization": 0.9}
    assert slo.check(ok) == []
    bad = dict(ok, tok_s=0.5, p95_latency_s=9.0)
    msgs = slo.check(bad)
    assert len(msgs) == 2 and any("tok/s" in m for m in msgs)
    assert any("missing" in m for m in slo.check({}))
    assert msgs == ref.SLOSpec(**dataclasses.asdict(slo)).check(bad)


def test_fault_plan_registry():
    assert get_plan("none").name == "none"
    assert get_plan("device-loss").resilient
    assert not get_plan("preempt").resilient
    with pytest.raises(KeyError):
        get_plan("cosmic-ray")


def test_prefill_axis_expansion_and_shared_seed():
    """The chunk axis expands only under the continuous scheduler, tags
    cell ids with ``pc<C>``, and stays OUTSIDE the traffic key: every
    chunk width samples byte-identical traffic."""
    spec = _tiny_matrix(schedulers=["continuous", "wave"],
                        prefill_chunks=[1, 8], prefill_budget=8)
    cells = spec.cells()
    cont = [c for c in cells if c.scheduler == "continuous"]
    wave = [c for c in cells if c.scheduler == "wave"]
    assert sorted(c.prefill_chunk for c in cont) == [1, 8]
    assert [c.prefill_chunk for c in wave] == [1], "wave has no chunked path"
    chunked, = [c for c in cont if c.prefill_chunk == 8]
    plain, = [c for c in cont if c.prefill_chunk == 1]
    assert chunked.cell_id.endswith("/pc8")
    assert "pc" not in plain.cell_id
    assert chunked.prefill_budget == 8 and plain.prefill_budget is None
    assert len({c.seed for c in cells}) == 1, (
        "prefill chunking must not perturb traffic seeds"
    )
    _same_trace(sample_trace(plain, vocab=256),
                sample_trace(chunked, vocab=256))


def test_chunk_twin_is_token_by_token_and_fault_free():
    spec = _tiny_matrix(faults=["preempt"], prefill_chunks=[8],
                        prefill_budget=8)
    cell, = spec.cells()
    twin = cell.chunk_twin()
    assert twin.prefill_chunk == 1 and twin.prefill_budget is None
    assert twin.fault == "none"
    assert twin.seed == cell.seed
    assert "pc" not in twin.cell_id


def test_slo_ttft_steps_ceiling_is_opt_in():
    """max_ttft_p95_steps is opt-in: None never checks (even when the
    metric is absent), a finite ceiling gates the deterministic value."""
    loose = SLOSpec()
    assert loose.check({"tok_s": 9.0, "p95_latency_s": 0.1,
                        "ttft_p95_s": 0.1, "slot_utilization": 0.9}) == []
    tight = SLOSpec(max_ttft_p95_steps=4.0)
    ok = {"tok_s": 9.0, "p95_latency_s": 0.1, "ttft_p95_s": 0.1,
          "slot_utilization": 0.9, "ttft_p95_steps": 3.0}
    assert tight.check(ok) == []
    msgs = tight.check(dict(ok, ttft_p95_steps=9.0))
    assert len(msgs) == 1 and "TTFT steps" in msgs[0]


def test_smoke_matrix_unaffected_by_the_later_axes():
    """The CI smoke matrix stays token by token, unshared, unspeculated
    and unsharded."""
    for c in smoke_matrix().cells():
        assert c.prefill_chunk == 1 and c.prefill_budget is None
        assert "pc" not in c.cell_id
        assert c.prompt_sharing == "none" and not c.share_prefixes
        assert c.spec_k == 0 and c.mesh is None


def test_sharing_axis_expansion_and_shared_traffic():
    """The prompt_sharing axis expands only under the continuous
    scheduler, tags cell ids, keeps the sharing MODE out of the traffic
    key ("shared" and "shared-off" serve byte-identical requests) while
    the traffic SHAPE (bimodal shared prefixes) is in it."""
    spec = _tiny_matrix(schedulers=["continuous", "wave"],
                        prompt_sharing=["none", "shared"])
    cells = spec.cells()
    cont = [c for c in cells if c.scheduler == "continuous"]
    wave = [c for c in cells if c.scheduler == "wave"]
    assert sorted(c.prompt_sharing for c in cont) == ["none", "shared"]
    assert [c.prompt_sharing for c in wave] == ["none"]
    shared, = [c for c in cont if c.prompt_sharing == "shared"]
    plain, = [c for c in cont if c.prompt_sharing == "none"]
    assert shared.cell_id.endswith("/shared")
    assert "shared" not in plain.cell_id
    assert shared.share_prefixes and not plain.share_prefixes
    twin = shared.sharing_twin()
    assert twin.prompt_sharing == "shared-off" and twin.fault == "none"
    assert twin.seed == shared.seed
    assert not twin.share_prefixes
    t_on = sample_trace(shared, vocab=256)
    _same_trace(t_on, sample_trace(twin, vocab=256))
    assert shared.seed != plain.seed
    firsts = {tuple(r.prompt[:4]) for r in t_on}
    assert len(firsts) <= 2, firsts


def test_mesh_axis_expansion_and_shared_traffic():
    spec = _tiny_matrix(schedulers=["wave", "continuous"],
                        meshes=[None, "1x1"])
    cells = spec.cells()
    assert not [c for c in cells if c.mesh and c.scheduler == "wave"]
    meshed = [c for c in cells if c.mesh == "1x1"]
    plain = [c for c in cells if c.mesh is None
             and c.scheduler == "continuous"]
    assert len(meshed) == 1 and len(plain) == 1
    assert meshed[0].traffic_key == plain[0].traffic_key
    assert meshed[0].seed == plain[0].seed
    assert meshed[0].cell_id == plain[0].cell_id + "/m1x1"
    assert meshed[0].mesh_twin().cell_id == plain[0].cell_id
    # junk shapes die at construction (the port's MeshShapeError)
    with pytest.raises(MeshShapeError):
        dataclasses.replace(meshed[0], mesh="2x2x2")
    assert any(c.mesh == "1x1" for c in full_matrix().cells())
    assert all(c.mesh is None for c in smoke_matrix().cells())


def test_speculate_axis_expansion():
    """``tests/test_speculative.py``'s speculate axis: continuous only,
    ``/spec<k>`` in the id, outside the traffic key."""
    spec = _tiny_matrix(speculate=[0, 4], max_len=64)
    cells = spec.cells()
    assert sorted(c.spec_k for c in cells) == [0, 4]
    on, = [c for c in cells if c.spec_k == 4]
    off, = [c for c in cells if c.spec_k == 0]
    assert on.cell_id.endswith("/spec4")
    assert "spec" not in off.cell_id
    assert on.traffic_key == off.traffic_key
    twin = on.spec_twin()
    assert twin.spec_k == 0 and twin.fault == "none"
    assert all(c.spec_k == 0
               for c in _tiny_matrix(schedulers=["wave"],
                                     speculate=[0, 4]).cells())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(*argv, timeout=120, env=None):
    # one thread: beside the other test workers, and with the first call
    # of torch's vector math on one thread (see tests/torch_threads.py)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", **(env or {})}
    return subprocess.run([sys.executable, "-m", "repro_torch.scenarios",
                           *argv], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)


def test_cli_list_prints_the_reference_lines(capsys):
    from repro.scenarios.__main__ import main as ref_main

    assert ref_main(["list", "--matrix", "full"]) == 0
    want = capsys.readouterr().out
    proc = _cli("list", "--matrix", "full")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == want
    assert proc.stderr.strip().endswith(f"{len(want.split())} cells")


def test_cli_gate_on_the_cpu(tmp_path):
    out, md = tmp_path / "report.json", tmp_path / "matrix.md"
    proc = _cli("gate", "--device", "cpu", "--only", "*device-loss",
                "--out", str(out), "--report-md", str(md))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "scenario gate: all cells ok" in proc.stdout
    report = json.loads(out.read_text())
    assert report["kind"] == "scenario_matrix"
    cells = report["cells"]
    assert len(cells) == 4 and all(c["ok"] for c in cells)
    assert all(c["restarts"] >= 1 and c["golden_checked"] for c in cells)
    assert md.read_text().startswith("# Scenario matrix")


def test_cli_gate_fails_on_no_match():
    proc = _cli("gate", "--device", "cpu", "--only", "no-such-cell")
    assert proc.returncode == 2
    assert "no cells match" in proc.stderr


def test_cli_refuses_record(tmp_path):
    """``run --record`` (ROADMAP 1.15, no longer refused) appends one
    perf-ledger run per cell to ``$REPRO_ARTIFACT_DIR/torch/perf``."""
    from repro_torch.perf import Ledger

    proc = _cli("run", "--device", "cpu", "--only", "*gpt2-124m/malformed",
                "--record", env={"REPRO_ARTIFACT_DIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    runs = Ledger(str(tmp_path / "torch" / "perf")).runs()
    assert sorted(k for r in runs for k in r.metrics) == [
        "scenario/poisson0.5/u4-12/eos0.1/continuous/gpt2-124m/malformed",
        "scenario/poisson0.5/u4-12/eos0.1/wave/gpt2-124m/malformed"]
    assert all(r.meta["fault"] == "malformed" for r in runs)
