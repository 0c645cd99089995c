"""Perf trajectory ledger + decision-tree regression gate (a port of
:mod:`repro.perf`).

Serve reports (``python -m repro_torch.launch.serve --record``: tok/s,
p50/p95 request latency, slot utilization and the scheduler's exact
counters), scenario cells (``python -m repro_torch.scenarios run
--record``), analysis-service reports (``python -m
repro_torch.serve.analysis_service --record``), benchmark summaries and
tuning reports are ingested into an append-only, content-addressed ledger
of :class:`~repro_torch.perf.ledger.BenchRun` records (stamped with a
:class:`~repro_torch.perf.ledger.RunEnv` fingerprint: chip, dtype, git
SHA, torch and CUDA versions, the card, tuned-config hash).  Baselines are
resolved by policy (``latest`` / ``pinned:<prefix>`` / ``median:<K>``),
regressions are detected with noise-aware per-metric tolerances, and every
confirmed regression is routed back through the paper's Fig. 8 decision
tree and Eq. 2 adapted roofline so the gate reports *why* — a PerfClass
transition with the AI vs AI_IRV quantities that justify it — not just
"slower".

    from repro_torch.perf import capture_env, default_ledger, gate_run

    run = default_ledger().record_sources(serving=report,
                                          env=capture_env(chip="h100"))
    result = gate_run(run, policy="latest")
    sys.exit(result.exit_code)

CLI: ``python -m repro_torch.perf record|compare|gate|report|list``.
"""

from repro_torch.perf.ledger import (  # noqa: F401
    PERF_VERSION,
    BenchRun,
    Ledger,
    RunEnv,
    capture_env,
    default_ledger,
    default_perf_dir,
    device_chip,
    git_sha,
    metrics_from_analysis,
    metrics_from_scenario,
    metrics_from_serving,
    metrics_from_summary,
    metrics_from_tuning,
    tuned_state_hash,
)
from repro_torch.perf.baseline import resolve_baseline  # noqa: F401
from repro_torch.perf.compare import (  # noqa: F401
    SPECS,
    MetricDelta,
    MetricSpec,
    Regression,
    RunComparison,
    compare_runs,
)
from repro_torch.perf.triage import Triage, triage_regressions  # noqa: F401
from repro_torch.perf.gate import (  # noqa: F401
    GateResult,
    export_trajectory,
    format_markdown,
    gate_run,
)
