"""P-Shell, window scheduler (one client or many, lane batching),
CUDA-graph windows, watchdog, commit stream, co-emulation against a
golden model, coverage, the stall-stack profiler, the ZP-Scope
instrumentation plane and Scale-Down decomposition of the port."""
from repro_torch.core.pshell import (  # noqa: F401
    FifoSpec, ShellConfig, PShell, shell_init, csr_read, csr_write,
    csr_accum, fifo_push, fifo_push_many, drain, group_reset, stack_batches)
from repro_torch.core.schedule import (  # noqa: F401
    WindowScheduler, WindowPlan, DrainBarrier, Client, ClientDriver,
    ClientPolicy, plan_windows, iter_windows)
from repro_torch.core.graphs import WindowGraphs  # noqa: F401
from repro_torch.core.watchdog import Watchdog  # noqa: F401
from repro_torch.core.commit import (  # noqa: F401
    default_shell_config, make_ingest)
from repro_torch.core.coverage import CoverageMap  # noqa: F401
from repro_torch.core.coemu import CoEmulator  # noqa: F401
from repro_torch.core.profiler import Profiler, StallStack  # noqa: F401
from repro_torch.core.scope import (  # noqa: F401
    ScopeSpec, ScopePlane, instrument, digest_tree)
