"""ZP-Farm of the port: a lockstep multi-device co-emulation farm manager
(DESIGN C8 scaled out) — a job queue + device placement + per-slot
watchdogs + straggler eviction + checkpointed requeue + lane batching
over one ``WindowScheduler.run_many`` pass, with the farm's telemetry.

The async mode, the failure policy, the ledger, the registry and ZP-Chaos
are the next slice of the port (``FarmManager`` raises
NotImplementedError for each)."""
from repro_torch.core.schedule import LaneBatch  # noqa: F401
from repro_torch.farm.manager import (  # noqa: F401
    FarmError, FarmJob, FarmManager, JobSnapshot, lane_compatible)
from repro_torch.farm.placement import (  # noqa: F401
    DeviceSlot, enumerate_slots, pick_slot, place, place_stack)
from repro_torch.farm.telemetry import FarmTelemetry  # noqa: F401
