"""Roofline-guided kernel autotuning with persistent tuning records (a port
of :mod:`repro_torch.tuning`).

The paper's analytic machinery (Eq. 1 vectorization bound, Eq. 2 adapted
roofline) applied as a *search pruner*: every tunable registry kernel
carries a :class:`TuningSpace` over its CUDA kernel's compiled launch
variants (tiles, stages, threads, vectors, splits) and the ELEN-packing
dtype axis; :func:`tune` discards candidates the roofline + shared-memory
models already rule out, times only the survivors on the card, and
persists the winner as a content-addressed :class:`TuningRecord` — so
repeat processes re-tune **zero** times, mirroring the analysis pipeline's
artifact store.

    from repro_torch.tuning import tune

    record = tune("gemm")            # prune -> time -> persist -> apply
    record = tune("gemm")            # store hit: cached=True, no timing

    from repro_torch.kernels.registry import get_kernel
    get_kernel("gemm")               # repr shows the active tuned config

On the CPU, ``tune(..., device="cpu", mode="interpret")`` times the plain
versions.  CLI: ``python -m repro_torch.tuning --help`` (writes a
machine-readable ``tuning.json``).
"""

from repro_torch.tuning.space import (  # noqa: F401
    TuningSpace,
    predicted_config_time_s,
    predicted_time_s,
)
from repro_torch.tuning.records import (  # noqa: F401
    TUNING_VERSION,
    TuningRecord,
    default_tuning_dir,
    default_tuning_store,
    load_record,
    save_record,
    tuning_fingerprint,
)
from repro_torch.tuning.tune import (  # noqa: F401
    format_records,
    load_tuned,
    outlook,
    prune,
    report_dict,
    timing_runs,
    tunable_kernels,
    tune,
    tune_kernels,
)
