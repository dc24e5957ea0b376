from repro_torch.panicroom.fs import BLOCK, BlockFS  # noqa: F401
from repro_torch.panicroom.syscalls import BSP, SYSCALL_NAMES  # noqa: F401
from repro_torch.panicroom.runner import run_benchmark  # noqa: F401
