"""ZP-Farm of the port: multi-device co-emulation farm manager (DESIGN C8
scaled out) — a job queue + device placement + per-slot watchdogs +
straggler eviction + checkpointed requeue + lane batching over one
``WindowScheduler.run_many`` pass (lockstep) or one dispatcher thread and
one CUDA stream per slot (async), plus the ZP-Chaos hardening layer —
:class:`FailurePolicy` (retry budgets, quarantine, slot circuit breakers)
and the deterministic fault-injection harness (``farm/chaos.py``) — the
serializable job registry (``farm/registry.py``) and ZP-Ledger, the
farm's durable journal (``farm/ledger.py``, ``FarmManager(ledger=)``,
``FarmManager.recover``)."""
from repro_torch.core.schedule import LaneBatch  # noqa: F401
from repro_torch.farm.ledger import (  # noqa: F401
    FarmLedger, JobReplay, LedgerState, choose_resume)
from repro_torch.farm.manager import (  # noqa: F401
    FailurePolicy, FarmError, FarmJob, FarmManager, JobSnapshot,
    lane_compatible)
from repro_torch.farm.placement import (  # noqa: F401
    DeviceSlot, enumerate_slots, pick_slot, place, place_stack, slot_stream)
from repro_torch.farm.registry import (  # noqa: F401
    REGISTRY, FactoryRegistry, JobSpec, register)
from repro_torch.farm.telemetry import FarmTelemetry  # noqa: F401
