"""Serializable farm job descriptions (ZP-Ledger's registry half).

A :class:`FarmJob` is built from closures — engine, window stream,
verifier, sink — which a crashed process cannot resurrect from a
journal, and a remote host cannot receive over a wire. A
:class:`JobSpec` is the durable form the ROADMAP's multi-host item
named as its missing prerequisite: a registered factory NAME plus
JSON-able kwargs. ``spec.build()`` calls the factory, which returns the
job's live parts (engine, windows, state, shell, verify, on_drain,
plumbing, barriers) as a dict; the spec itself round-trips through
``to_json``/``from_json`` and is what ``FarmManager.submit_spec``
journals, so ``FarmManager.recover`` can re-instantiate the job in a
fresh process.

Factories register by name::

    @register("zp.my_board")
    def my_board(arch: str, n_windows: int = 8):
        ...build closures...
        return dict(engine=..., windows=..., state=..., on_drain=...)

Durable state (checkpoint directory, retry budget, lane key, scope
spec) lives on the spec — NOT inside the factory — so a recovered
process re-attaches to the same on-disk snapshot store the dead one
published to.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional


class FactoryRegistry:
    """Name -> job-parts factory map.

    Duplicate registration under a different function is an ERROR unless
    ``override=True``: two modules silently fighting over one name would
    make ``recover()`` rebuild a journaled job with whichever factory
    imported last — a wrong-board-from-the-journal class of bug.
    Re-registering the SAME function (same module + qualname) stays
    idempotent so test re-imports and module reloads stay cheap."""

    def __init__(self):
        self._factories: Dict[str, Callable[..., dict]] = {}

    def register(self, name: str, fn: Optional[Callable] = None, *,
                 override: bool = False):
        """``register("name", fn)`` or ``@register("name")``."""
        if fn is None:
            def deco(f):
                self._put(str(name), f, override)
                return f
            return deco
        self._put(str(name), fn, override)
        return fn

    def _put(self, name: str, fn: Callable, override: bool):
        old = self._factories.get(name)
        if (old is not None and not override
                and (getattr(old, "__module__", None),
                     getattr(old, "__qualname__", None))
                != (getattr(fn, "__module__", None),
                    getattr(fn, "__qualname__", None))):
            raise ValueError(
                f"job factory {name!r} is already registered to "
                f"{getattr(old, '__module__', '?')}."
                f"{getattr(old, '__qualname__', '?')}; pass override=True "
                f"to replace it")
        self._factories[name] = fn

    def get(self, name: str) -> Callable[..., dict]:
        try:
            return self._factories[str(name)]
        except KeyError:
            raise KeyError(
                f"unknown job factory {name!r}; registered: "
                f"{sorted(self._factories)} — a recovering process must "
                f"import the module that registers it before "
                f"FarmManager.recover") from None

    def names(self):
        return sorted(self._factories)


#: The process-wide default registry ``JobSpec.build`` and
#: ``FarmManager.recover`` resolve against.
REGISTRY = FactoryRegistry()


def register(name: str, fn: Optional[Callable] = None, *,
             override: bool = False):
    """Register a factory in the module-level :data:`REGISTRY`."""
    return REGISTRY.register(name, fn, override=override)


#: FarmJob init fields a factory may return. Everything else (budget,
#: lane key, snapshot store, scope) is spec-owned and durable.
_FACTORY_FIELDS = frozenset({
    "engine", "windows", "state", "shell", "verify", "on_drain",
    "drain_fn", "stack_fn", "reset", "barriers", "capture"})


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """The durable description of one farm job."""
    name: str
    factory: str
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    max_requeues: int = 1
    lane_key: Optional[str] = None
    snapshot_dir: Optional[str] = None  # non-None: on-disk CheckpointManager
    snapshot_keep: int = 3
    scope: Optional[Dict[str, Any]] = None  # ScopeSpec kwargs

    def __post_init__(self):
        # Fail at CONSTRUCTION, naming the bad key: a non-JSON kwarg
        # (device array, closure, module) would otherwise surface as an
        # opaque to_json failure at submit — or worse, a job journaled
        # as spec=null that recovery can only dead-letter.
        if not isinstance(self.kwargs, dict):
            raise TypeError(f"JobSpec.kwargs must be a dict, "
                            f"got {type(self.kwargs).__name__}")
        for k, v in self.kwargs.items():
            try:
                json.dumps(v)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"JobSpec {self.name!r}: kwargs[{k!r}] is not "
                    f"JSON-serializable ({type(v).__name__}): {e}"
                ) from None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        json.dumps(d)   # fail at SUBMIT time, not in the recovery path
        return d

    @classmethod
    def from_json(cls, d: dict) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def build(self, registry: Optional[FactoryRegistry] = None):
        """Instantiate the live :class:`FarmJob` this spec describes."""
        from repro_torch.farm.manager import FarmJob  # circular-free
        reg = registry if registry is not None else REGISTRY
        parts = reg.get(self.factory)(**dict(self.kwargs))
        if not isinstance(parts, dict) or "engine" not in parts:
            raise TypeError(
                f"factory {self.factory!r} must return a dict of FarmJob "
                f"parts including 'engine', got {type(parts)!r}")
        bad = set(parts) - _FACTORY_FIELDS
        if bad:
            raise TypeError(f"factory {self.factory!r} returned unknown "
                            f"FarmJob fields {sorted(bad)}")
        store = None
        if self.snapshot_dir is not None:
            from repro_torch.checkpoint.manager import CheckpointManager
            store = CheckpointManager(self.snapshot_dir,
                                      keep=self.snapshot_keep)
        scope = None
        if self.scope is not None:
            from repro_torch.core.scope import ScopeSpec
            scope = ScopeSpec(**self.scope)
        return FarmJob(name=self.name, max_requeues=self.max_requeues,
                       lane_key=self.lane_key, snapshot_store=store,
                       scope=scope, spec=self, **parts)
