"""The suite's driver (``python -m repro_torch.suite.run``) and the
quickstart (``repro_torch.examples.quickstart``) on the CPU.

The driver keeps the reference driver's (``benchmarks/run.py``) exit
codes: 0 for ``--list`` and a clean run, 2 for an unknown ``--only`` and
for a malformed ``--baseline`` under ``--gate`` (before any benchmark
runs), 1 for a failed benchmark and for a regression the gate confirms.
It writes one CSV a benchmark and ``summary.json`` and records into the
perf ledger of ``$REPRO_ARTIFACT_DIR``.  The quickstart's train step is
recorded with its backward and update, on copies of the caller's state,
and a second run against the same store records nothing.
"""

import csv
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import ArtifactCache, Workload, analyze  # noqa: E402
from repro_torch.core import hw  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.suite import figures, run  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)


@pytest.fixture()
def artifacts(tmp_path, monkeypatch):
    """A fresh ``$REPRO_ARTIFACT_DIR`` (the perf ledger and the stores)."""
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path / "artifacts"))
    return tmp_path


def test_list_exits_0_and_names_benchmarks_and_apps(capsys):
    assert run.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in figures.ALL:
        assert f"  {name}\n" in out
    assert "  app/QC-simulator\n" in out and "  kernel/gemm\n" in out


def test_unknown_only_exits_2(artifacts, capsys):
    out = artifacts / "out"
    assert run.main(["--device", "cpu", "--only", "fig99",
                     "--out", str(out)]) == 2
    assert "unknown benchmark 'fig99'" in capsys.readouterr().err
    assert not out.exists()


def test_bad_baseline_exits_2_before_any_benchmark(artifacts, monkeypatch):
    ran = []
    monkeypatch.setitem(figures.ALL, "fig7_roofline",
                        lambda: ran.append(1) or [])
    out = artifacts / "out"
    for bad in ("newest", "median:x", "pinned:"):
        assert run.main(["--device", "cpu", "--only", "fig7_roofline",
                         "--gate", "--baseline", bad,
                         "--out", str(out)]) == 2
    assert ran == [] and not out.exists()


def test_table3_writes_csv_and_summary(artifacts):
    out = artifacts / "suite"
    assert run.main(["--device", "cpu", "--only", "table3_decision_tree",
                     "--out", str(out)]) == 0
    with open(out / "table3_decision_tree.csv") as f:
        rows = list(csv.DictReader(f))
    assert rows[-1]["app"] == "AGREEMENT 13/13" and len(rows) == 14
    summary = json.loads((out / "summary.json").read_text())
    assert summary["kind"] == "benchmarks_summary" and summary["schema"] == 1
    assert summary["passed"] == 1 and summary["failed"] == 0
    assert [b["name"] for b in summary["benchmarks"]] == [
        "table3_decision_tree"]
    assert summary["env"]["chip"] == "grace-core"
    assert summary["env"]["torch_version"] == torch.__version__


def test_record_and_gate_exit_codes(artifacts, monkeypatch):
    """fig7 recorded and gated twice (0, 0); then a run whose benchmark
    raises (1, recorded as failed), then one that returns fewer rows than
    its baseline, a regression the gate confirms (1)."""
    from repro_torch.perf import default_ledger

    argv = ["--device", "cpu", "--only", "fig7_roofline", "--record",
            "--gate", "--out", str(artifacts / "out")]
    assert run.main(argv) == 0
    assert run.main(argv) == 0
    real = figures.ALL["fig7_roofline"]

    def broken():
        raise RuntimeError("boom")

    monkeypatch.setitem(figures.ALL, "fig7_roofline", broken)
    assert run.main(argv) == 1
    monkeypatch.setitem(figures.ALL, "fig7_roofline", lambda: real()[:3])
    assert run.main(argv) == 1
    runs = default_ledger().runs()
    assert len(runs) == 4
    assert [r.meta.get("failed") for r in runs] == [0, 0, 1, 0]
    assert {r.env.series_key() for r in runs} == {"grace-core/fp32"}
    assert runs[0].metrics["bench/fig7_roofline"]["rows"] == 13


def test_timed_benchmark_names_its_column_after_the_device(artifacts):
    out = artifacts / "fig6"
    assert run.main(["--device", "cpu", "--only", "fig6_synthetic_spmv",
                     "--out", str(out)]) == 0
    with open(out / "fig6_synthetic_spmv.csv") as f:
        header = next(csv.reader(f))
    assert "wall_s_cpu" in header and "wall_s_cuda" not in header


def test_cuda_without_a_card_raises(artifacts):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        run.main(["--only", "fig7_roofline", "--out",
                  str(artifacts / "out")])


# -- the quickstart -----------------------------------------------------------


def test_quickstart_records_once_then_hits_the_store(tmp_path, capsys):
    store = str(tmp_path / "store")
    first = quickstart.run("cpu", store)
    second = quickstart.run("cpu", store)
    for res in (first, second):
        assert torch.isfinite(torch.tensor(res["loss"]))
        assert res["analysis"].chip == "h100"
    assert (first["recordings"], first["store_hits"]) == (1, 0)
    assert (second["recordings"], second["store_hits"]) == (0, 1)
    assert first["analysis"].to_dict() == second["analysis"].to_dict()
    out = capsys.readouterr().out
    assert "[analysis: 0 recordings, 1 store hits;" in out
    assert quickstart.main(["--device", "cpu", "--store-dir", store]) == 0


def test_recorded_step_counts_backward_and_update_and_leaves_state():
    """The recording of the train step holds its backward (about twice the
    forward's product flops again) and its AdamW update, and leaves the
    caller's params, state and batch as they were."""
    import repro_torch.configs as configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg = configs.get_smoke_config("qwen3-1.7b")
    rc = steps.RunConfig(remat="none")
    params = steps.init_model(cfg, seed=0, device="cpu")
    opt = adamw.init_opt_state(params, rc.opt)
    batch = {k: torch.from_numpy(v.copy()) for k, v in pipeline.global_batch(
        cfg, ShapeConfig("q", 64, 4, "train"), pipeline.DataConfig(),
        0).items()}
    before = [t.clone() for t in tree_leaves([params, opt, batch])]
    step = Workload(name="step", fn=steps.make_train_step(cfg, rc),
                    args=(params, opt, batch))
    fwd = Workload(name="fwd", fn=lambda p, t: transformer.forward(p, cfg, t),
                   args=(params, batch["tokens"]))
    ev = analyze(step, hw.H100, cache=ArtifactCache()).events
    ev_fwd = analyze(fwd, hw.H100, cache=ArtifactCache()).events
    assert 2.5 < ev.mxu_flops / ev_fwd.mxu_flops < 3.5
    assert ev.flops - ev.mxu_flops > 3 * (ev_fwd.flops - ev_fwd.mxu_flops)
    after = tree_leaves([params, opt, batch])
    assert all(torch.equal(a, b) for a, b in zip(before, after))
