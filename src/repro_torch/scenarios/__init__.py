"""Scenario-matrix traffic harness of the PyTorch port: declarative
traffic x fault matrices over the port's serve engine, with golden-twin
equivalence and per-cell SLO gating.

Port of ``repro.scenarios``: :mod:`repro_torch.scenarios.matrix` (axes ->
seeded cells), :mod:`repro_torch.scenarios.traffic` (cell -> reproducible
request trace), :mod:`repro_torch.scenarios.faults` (fault plans), and
:mod:`repro_torch.scenarios.runner` (execution, twin diffing, recording
cells in the perf ledger).
CLI: ``python -m repro_torch.scenarios {list,run,gate}``.
"""

from repro_torch.scenarios.faults import (
    PLANS,
    FaultPlan,
    SimulatedDeviceLoss,
    get_plan,
)
from repro_torch.scenarios.matrix import (
    MATRICES,
    SERVE_ARCHS,
    ArrivalSpec,
    EosSpec,
    MatrixSpec,
    PromptSpec,
    Scenario,
    SLOSpec,
    cell_seed,
    full_matrix,
    load_matrix,
    smoke_matrix,
)
from repro_torch.scenarios.runner import (
    CellResult,
    TrafficFeeder,
    format_matrix_markdown,
    record_cell,
    run_cell,
    run_matrix,
)
from repro_torch.scenarios.traffic import RequestSpec, sample_trace

__all__ = [
    "ArrivalSpec", "PromptSpec", "EosSpec", "SLOSpec", "Scenario",
    "MatrixSpec", "MATRICES", "SERVE_ARCHS", "cell_seed", "smoke_matrix",
    "full_matrix", "load_matrix",
    "RequestSpec", "sample_trace",
    "FaultPlan", "PLANS", "get_plan", "SimulatedDeviceLoss",
    "CellResult", "TrafficFeeder", "run_cell", "run_matrix", "record_cell",
    "format_matrix_markdown",
]
