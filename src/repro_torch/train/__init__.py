"""train of the PyTorch port (see repro.train)."""

from repro_torch.train.steps import (  # noqa: F401
    BASELINE_RUN,
    OPTIMIZED_RUN,
    RunConfig,
    init_model,
    loss_and_grads,
    loss_fn,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    model_forward,
)
