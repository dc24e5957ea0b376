"""The train step of the port (the co-emulation DUT): AdamW, error-feedback
gradient compression, gradient accumulation and the fused clock-gated
window."""
from repro_torch.train.optim import (  # noqa: F401
    OptConfig, adamw_init, adamw_update)
from repro_torch.train.step import (  # noqa: F401
    init_state, make_group_step, make_train_step, state_specs)
