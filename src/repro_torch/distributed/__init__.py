"""distributed of the PyTorch port (see repro.distributed)."""

from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    FaultAt,
    FaultToleranceConfig,
    ResilientLoop,
    StragglerDetector,
)
