"""The train step of the port (the co-emulation DUT): AdamW, error-feedback
gradient compression, gradient accumulation and the fused clock-gated
window; and the train loop with checkpoints and the verified-snapshot
workflow."""
from repro_torch.train.optim import (  # noqa: F401
    OptConfig, adamw_init, adamw_update)
from repro_torch.train.step import (  # noqa: F401
    init_state, make_group_step, make_train_step, state_specs)
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: F401
