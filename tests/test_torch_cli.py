"""``python -m repro_torch.launch.serve`` on the CPU: it serves (chunked
prefill included), writes the reference CLI's report fields, and records
its report in the perf ledger."""

import argparse
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)


def test_cli_serves_on_cpu_and_writes_the_reference_report(tmp_path,
                                                            capsys):
    out = tmp_path / "report.json"
    assert serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "4", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    printed = capsys.readouterr().out
    assert "[continuous] served 3 requests, 12 tokens" in printed
    assert [r["new_tokens"] for r in report["requests"]] == [4, 4, 4]

    # field for field the reference CLI's report (built here from an
    # engine that has not served, which builds no step)
    args = argparse.Namespace(arch="gpt2-124m")
    cfg = ref_configs.get_smoke_config("gpt2-124m")
    ref_engine = RefEngine(cfg, ref_steps.init_model(jax.random.PRNGKey(0),
                                                     cfg))
    want = ref_serve.build_report(args, ref_engine)
    assert set(report) == set(want)
    assert set(report["stats"]) == set(want["stats"])
    assert set(report["requests"][0]) == {
        "uid", "prompt_len", "new_tokens", "tokens", "latency_s", "ttft_s"}
    for key in ("scheduler", "kv_dtype", "share_prefixes", "spec_k", "mesh",
                "temperature", "prefill_chunk"):
        assert report[key] == want[key], key


def test_cli_prompts_follow_the_reference_sampling(tmp_path):
    """Same seed, same prompt lengths as the reference CLI's traffic."""
    out = tmp_path / "report.json"
    serve.main(["--device", "cpu", "--requests", "5", "--max-new", "2",
                "--prompt-lo", "3", "--prompt-hi", "30", "--seed", "4",
                "--max-len", "64", "--no-warmup", "--out", str(out)])
    rng = np.random.default_rng(4)
    lens = []
    for _ in range(5):
        n = int(rng.integers(3, 31))
        rng.integers(0, 256, size=n)
        lens.append(n)
    got = [r["prompt_len"] for r in json.loads(out.read_text())["requests"]]
    assert got == lens


@pytest.mark.parametrize("flags", [
    ["--scheduler", "wave"], ["--draft", "gpt2-124m", "--spec-k", "2"],
    ["--spec-adaptive"], ["--mesh", "2x2", "--draft", "gpt2-124m",
                           "--spec-k", "2"], ["--temperature", "0.8"],
    ["--record"],
])
def test_cli_refuses_unported_options(flags, tmp_path, capsys,
                                      monkeypatch):
    """Every option the reference CLI has is served now.  ``--record``
    (1.15) appends the serve report to the perf ledger under
    ``$REPRO_ARTIFACT_DIR/torch/perf`` and prints the run id.  The wave
    scheduler (1.12) serves, and its report names it.  The speculative
    and sampling flags (1.13) are served, over a mesh too, and land in
    the report; ``--spec-adaptive`` without ``--spec-k`` raises the
    reference engine's error."""
    argv = ["--device", "cpu", "--requests", "2", "--max-new", "3"]
    if flags[0] == "--record":
        from repro_torch.perf import default_ledger

        monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path))
        assert serve.main(argv + flags) == 0
        (run,) = default_ledger().runs()
        assert default_ledger().root == str(tmp_path / "torch" / "perf")
        assert f"recorded serving run {run.run_id} (seq 1)" in \
            capsys.readouterr().out
        assert run.env.series_key() == "grace-core/fp32"
        assert run.meta == {"argv": " ".join(argv + flags),
                            "sources": ["serving"]}
        row = run.metrics["serve/gpt2-124m@continuous"]
        assert row["requests"] == 2 and row["new_tokens"] == 6
        return
    if flags == ["--spec-adaptive"]:
        with pytest.raises(ValueError, match=r"^spec_adaptive requires "
                           r"speculative decoding \(spec_k >= 1\)$"):
            serve.main(argv + flags)
        return
    out = tmp_path / "report.json"
    assert serve.main(argv + flags + ["--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert [r["new_tokens"] for r in report["requests"]] == [3, 3]
    if flags[0] == "--scheduler":
        assert report["scheduler"] == report["stats"]["scheduler"] == "wave"
    elif "--spec-k" in flags:
        assert report["draft"] == "gpt2-124m" and report["spec_k"] == 2
        assert report["stats"]["acceptance_rate"] == 1.0
        if "--mesh" in flags:  # rank 0 printed in its own process
            assert report["mesh"] == "2x2"
        else:
            assert "speculative: draft gpt2-124m k=2, acceptance 1.000" \
                in capsys.readouterr().out
    else:
        assert report["temperature"] == 0.8


@pytest.mark.parametrize("flags", [["--prefill-chunk", "4"],
                                   ["--prefill-budget", "8"]])
def test_cli_serves_chunked_prefill_options(flags, tmp_path):
    """Chunked prefill (ROADMAP 1.9) is ported: the flags the refusal cases
    above used to name are served and land in the report."""
    out = tmp_path / "report.json"
    assert serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                       "3", "--out", str(out)] + flags) == 0
    report = json.loads(out.read_text())
    assert [r["new_tokens"] for r in report["requests"]] == [3, 3]
    assert report[flags[0][2:].replace("-", "_")] == int(flags[1])


@pytest.mark.parametrize("flags", [["--kv-dtype", "int8"],
                                   ["--share-prefixes"]])
def test_cli_serves_quantized_and_shared_options(flags, tmp_path, capsys):
    """Quantized paging and prefix sharing (ROADMAP 1.11) are ported: the
    flags the refusal cases above used to name are served, land in the
    report, and print the reference's dedup line."""
    out = tmp_path / "report.json"
    assert serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "3", "--shared-prefix-len", "16", "--out", str(out)]
                      + flags) == 0
    report = json.loads(out.read_text())
    assert [r["new_tokens"] for r in report["requests"]] == [3, 3, 3]
    assert report["kv_dtype"] == ("int8" if "--kv-dtype" in flags
                                  else "f32")
    assert report["share_prefixes"] == ("--share-prefixes" in flags)
    assert "logical /" in capsys.readouterr().out


def test_cli_dedup_report_matches_the_reference_keys(tmp_path, capsys):
    """``--kv-dtype int8 --share-prefixes --shared-prefix-len 16`` on the
    CPU: every request is served, blocks are shared (dedup ratio > 1),
    and the report carries the reference CLI's keys and dedup counters."""
    out = tmp_path / "report.json"
    assert serve.main(["--device", "cpu", "--kv-dtype", "int8",
                       "--share-prefixes", "--shared-prefix-len", "16",
                       "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "kv_dtype int8, prefix sharing on:" in printed
    report = json.loads(out.read_text())
    stats = report["stats"]
    assert len(report["requests"]) == 8 and report["rejected"] == 0
    assert stats["block_dedup_ratio"] > 1.0
    assert stats["shared_block_hits"] > 0
    assert stats["physical_blocks"] < stats["logical_blocks"]
    assert stats["kv_bytes_stored"] < stats["kv_bytes_served"]
    args = argparse.Namespace(arch="gpt2-124m")
    cfg = ref_configs.get_smoke_config("gpt2-124m")
    ref_engine = RefEngine(cfg, ref_steps.init_model(jax.random.PRNGKey(0),
                                                     cfg),
                           kv_dtype="int8", share_prefixes=True)
    want = ref_serve.build_report(args, ref_engine)
    assert set(report) == set(want)
    assert set(stats) == set(want["stats"])


def test_cli_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--requests", "1"])


def test_launch_serve_counts_rejections_instead_of_crashing(tmp_path):
    """Submit-time RequestTooLong is counted and reported by the serve
    CLI, never a crash, and the ledger row counts the rejections
    (``tests/test_scenarios.py``)."""
    from repro_torch.perf.ledger import metrics_from_serving

    out = tmp_path / "serve.json"
    # every sampled prompt (4..16 tokens) + a 100-token budget overflows
    # the 64-token slot cache: all submissions must be rejected
    assert serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "100", "--max-len", "64", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["rejected"] == 3
    assert len(report["rejections"]) == 3
    assert all("exceeds" in r["reason"] for r in report["rejections"])
    assert report["stats"]["requests"] == 0  # nothing reached the engine
    (_, row), = metrics_from_serving(report).items()
    assert row["rejected"] == 3
