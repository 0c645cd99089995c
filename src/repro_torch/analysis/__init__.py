"""Unified Workload API + one-call SVE analysis pipeline (paper Sec. 3), a
port of :mod:`repro.analysis`.

The paper's end-to-end method — PMU events (Sec. 3.1 / Table 1) -> Eq. 1
metrics (VB, R_ins) -> adapted roofline (Eq. 2) -> Fig. 8 decision tree —
behind two entry points:

* :func:`workload` / :class:`Workload` — describe a unit of work once
  (callable + example args + dtype + analytic cost model) and register it;
* :func:`analyze` / :func:`analyze_sweep` — run the whole pipeline on any
  registered (or ad-hoc) workload in one call, returning a typed
  :class:`SVEAnalysis` report, with the ROI optionally timed on the card.
  A workload without an analytic model is analysed from a recording of
  the operators one run dispatches; sweeps parallelize with ``jobs=N``
  (single-flight recording dedup), and recorded events persist across
  processes in the content-addressed :class:`ArtifactStore`
  (fingerprint = name + arg shapes/dtypes + fn hash), so repeat runs
  record nothing.

    from repro_torch.analysis import analyze, list_workloads

    print(analyze("kernel/gemm").table())
"""

from repro_torch.analysis.workload import (  # noqa: F401
    Workload,
    clear_registry,
    get_workload,
    list_workloads,
    register,
    register_lazy,
    workload,
)
from repro_torch.analysis.store import (  # noqa: F401
    ArtifactStore,
    default_store,
    workload_fingerprint,
)
from repro_torch.analysis.pipeline import (  # noqa: F401
    ArtifactCache,
    DEFAULT_CACHE,
    DEFAULT_STORE,
    SVEAnalysis,
    analyze,
    analyze_compiled,
    analyze_events,
    analyze_sweep,
    format_table,
)
