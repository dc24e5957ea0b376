"""Static board certification: run a DUT engine once on FAKE tensors
(``torch._subclasses.FakeTensorMode``: shapes, dtypes and devices, no
storage) and read what that one trace shows for the hazard classes behind
the farm's bugs. Nothing is compiled, dispatched or allocated on a card.

The engine contract under test is the farm's:

    engine(state, shell, batch_stack) -> (state', shell_snapshot, ys)

Certification turns the job's initial trees into fake tensors
(``from_tensor``: the metadata only, no copy; leaves that already are fake
keep their mode, so a board can be certified as it would run on a card
this host does not have) and calls the engine once under the fake mode,
with a recorder on top of it that sees every operator first. Parameters
the engine closes over stay real and are read as fakes by the mode; a
write to one lands on its fake, never on the tensor. The kernel wrappers
(``kernels/*/ops.py``) take their traced branch on fake CUDA tensors:
they check their shapes, return an output of the kernel's shape and note
the call (``CertReport.kernels``), and launch nothing.
:func:`no_dispatch_guard` makes the trace-only property checkable: it
fails on any counted kernel launch, kernel build, CUDA-graph replay or
change of the card's allocated bytes inside its block.

A ``WindowGraphs`` engine is certified through its ``.engine``: calling it
would replay (or capture) a CUDA graph, which is a dispatch.

Rule catalog (``RULES``), the reference's hazards restated for eager
PyTorch (a rule keeps its ID where the hazard is the same):

=======  ========  ===========================================================
rule     severity  hazard
=======  ========  ===========================================================
ZC100    error     the engine cannot be traced on fake tensors, or the job
                   has no engine (certification cannot see inside it)
ZC101    error     a host sync inside the window body: ``.item()``,
                   ``int(t)``, ``bool(t)``, ``.tolist()``, ``torch.equal``,
                   a data-dependent output shape (``nonzero``), a copy from
                   a CUDA tensor to the host (``.cpu()``, ``.numpy()``),
                   ``torch.cuda.synchronize`` or a Stream/Event
                   ``.synchronize`` — every window then waits for the card
ZC102    error     an in-place write to the shell (arg 1) or the window
                   stack (arg 2): the shell snapshot must survive the
                   dispatch until its deferred drain, the stack for replay
ZC103    error     an in-place write to the state (arg 0) where the farm
                   keeps no copy to replay from: not a zero-arg factory,
                   and the job may run lane-packed (a ``lane_key``), where
                   a leaf shared by identity across lanes is handed to the
                   engine uncopied. Solo runs dispatch from a replay copy
ZC104    error     the carry-out's tree structure, shapes or dtypes differ
                   from the carry-in's: window k's carry is window k+1's
                   input, so a drifting carry changes every window
ZC105    warning   a bare Python number in the state or shell comes out as
                   a tensor (the carry changes type after one window)
ZC106    warning   an RNG stream reused or shared: the global default
                   generator sampled in the window body (shared by every
                   slot thread and lane, so draws interleave), or a
                   generator re-seeded or restored inside it (unless the
                   seed depends on the step, every window draws the same)
ZC107    error     a ``ScopeSpec(fuse=True)`` plane over an engine that
                   writes its state in place: the fused counter update
                   reads the window's outputs inside the same dispatch
=======  ========  ===========================================================
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import (DynamicOutputShapeException,
                                           FakeTensor, FakeTensorMode)
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

from repro_torch.core.graphs import WindowGraphs
from repro_torch.kernels import traced_cost, traced_counts
from repro_torch.utils import tree_leaves, tree_map, tree_structure

#: rule id -> (severity, one-line catalog entry)
RULES = {
    "ZC100": ("error", "engine not traceable on fake tensors"),
    "ZC101": ("error", "host sync inside the window body"),
    "ZC102": ("error", "in-place write to the shell or the window stack"),
    "ZC103": ("error", "in-place state write with no replay copy"),
    "ZC104": ("error", "carry-out structure/shape/dtype mismatch"),
    "ZC105": ("warning", "bare Python number in the carry becomes a tensor"),
    "ZC106": ("warning", "RNG stream reused or shared across slots"),
    "ZC107": ("error", "fused scope plane over an in-place engine"),
}

_aten = torch.ops.aten
#: operators whose result is a host value: each is a host sync on a card
_HOST_VALUE = {_aten._local_scalar_dense: 0, _aten.equal: False,
               _aten.is_nonzero: False}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One certification finding: a rule hit with its evidence."""
    rule: str
    severity: str
    summary: str
    detail: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self):
        return f"{self.rule} [{self.severity}] {self.summary}"


@dataclasses.dataclass
class CertReport:
    """The certification verdict for one board. ``kernels``: the kernel
    wrapper calls one window would make, by kernel name; ``writes``: the
    input leaves the engine writes in place (``state/...``, ``shell/...``,
    ``stack/...``)."""
    name: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    writes: List[str] = dataclasses.field(default_factory=list)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        if not self.findings:
            return f"{self.name}: certified clean"
        parts = ", ".join(str(f) for f in self.findings)
        verdict = "CERTIFY FAIL" if self.errors else "certified with warnings"
        return f"{self.name}: {verdict} — {parts}"


def _finding(rule: str, summary: str, detail: str = "") -> Finding:
    severity, _ = RULES[rule]
    return Finding(rule=rule, severity=severity, summary=summary,
                   detail=detail)


# ------------------------------------------------------------ recording --
class _Recorder(TorchDispatchMode):
    """Sits on top of the fake mode ``mode`` and sees each operator first:
    every real tensor argument (a parameter the engine closes over) goes
    on as its fake, so the fake mode never computes on a real tensor (it
    does, on the card too, for an operator with no fake argument); host
    syncs (answered with a placeholder so the trace goes on); the
    storages operators write in place (inference tensors keep no version
    counter, so writes are read from the operators' schemas); samples
    drawn from the global default generator."""

    def __init__(self, mode: FakeTensorMode):
        super().__init__()
        self.mode = mode
        self.syncs: List[str] = []
        self.default_rng: List[str] = []
        self.reseeds: List[str] = []
        self.written: set = set()       # StorageWeakRefs written in place

    def _fake(self, t):
        return t if isinstance(t, FakeTensor) else self.mode.from_tensor(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map_only(torch.Tensor, self._fake,
                                     (args, kwargs or {}))
        packet = func.overloadpacket
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                value = (kwargs.get(arg.name) if arg.kwarg_only
                         or i >= len(args) else args[i])
                for t in (value if isinstance(value, (list, tuple))
                          else (value,)):
                    if torch.is_tensor(t):
                        self.written.add(StorageWeakRef(t.untyped_storage()))
        if packet in _HOST_VALUE:
            self.syncs.append(f"{packet.__name__} (a host value: .item(), "
                              "int(), bool(), .tolist(), torch.equal)")
            x = args[0]
            if packet is not _aten._local_scalar_dense:
                return _HOST_VALUE[packet]
            if x.dtype == torch.bool:
                return False
            return 0j if x.is_complex() else (
                0.0 if x.is_floating_point() else 0)
        if packet in (_aten._to_copy, _aten.copy_):
            src, dst = ((args[0], kwargs.get("device"))
                        if packet is _aten._to_copy else (args[1], args[0]))
            dst = getattr(dst, "device", dst)
            if torch.is_tensor(src) and src.device.type == "cuda" \
                    and dst is not None and torch.device(dst).type == "cpu":
                self.syncs.append(f"{packet.__name__} from {src.device} to "
                                  "the host (.cpu(), .to('cpu'), .numpy())")
        if torch.Tag.nondeterministic_seeded in func.tags \
                and _default_generator(func, args, kwargs):
            self.default_rng.append(packet.__name__)
        try:
            return func(*args, **kwargs)
        except DynamicOutputShapeException:
            # the output's shape depends on the values (nonzero, a boolean
            # mask): the card must send it back before the host goes on
            self.syncs.append(f"{packet.__name__} (an output shape read "
                              "back from the card)")
            raise


def _default_generator(func, args, kwargs) -> bool:
    """True where a random operator draws from the global generator (its
    ``generator`` argument is absent or None)."""
    for i, arg in enumerate(func._schema.arguments):
        if arg.name == "generator":
            value = (kwargs.get("generator") if arg.kwarg_only
                     or i >= len(args) else args[i])
            return value is None
    return True


# host-side calls a window body must not make (ZC101) and global seeding
# (ZC106); while a thread certifies, its calls are recorded and skipped
# (certification seeds nothing and waits for nothing); other threads' go
# through untouched
_SYNC_CALLS = (("torch.cuda", torch.cuda, "synchronize"),
               ("torch.cuda.Stream", torch.cuda.Stream, "synchronize"),
               ("torch.cuda.Event", torch.cuda.Event, "synchronize"))
_SEED_CALLS = (("torch", torch, "manual_seed"),
               ("torch", torch, "seed"),
               ("torch", torch, "set_rng_state"),
               ("torch.random", torch.random, "manual_seed"),
               ("torch.random", torch.random, "seed"),
               ("torch.random", torch.random, "set_rng_state"),
               ("torch.cuda", torch.cuda, "manual_seed"),
               ("torch.cuda", torch.cuda, "manual_seed_all"),
               ("torch.cuda", torch.cuda, "seed"),
               ("torch.cuda", torch.cuda, "set_rng_state"))
_ACTIVE = threading.local()     # .rec: the certifying thread's recorder
_SENTINEL = 0x2F6E_C3A1_9B47_5D0B   # a private generator's seed (ZC106)
_NP_DTYPES = {torch.float16: np.float16, torch.float32: np.float32,
              torch.float64: np.float64, torch.int8: np.int8,
              torch.int16: np.int16, torch.int32: np.int32,
              torch.int64: np.int64, torch.uint8: np.uint8,
              torch.bool: np.bool_}
_PATCH_LOCK = threading.Lock()
_PATCH_DEPTH = [0]
_ORIGINALS: dict = {}


def _numpy_probe(real):
    def numpy(self, *args, **kwargs):
        rec = getattr(_ACTIVE, "rec", None)
        if rec is None or not isinstance(self, FakeTensor):
            return real(self, *args, **kwargs)
        rec.syncs.append(".numpy() (a host copy)")
        return np.zeros(tuple(self.shape),
                        _NP_DTYPES.get(self.dtype, np.float32))
    return numpy


def _data_ptr_probe(real):
    def data_ptr(self):
        if getattr(_ACTIVE, "rec", None) is not None \
                and isinstance(self, FakeTensor):
            # a raw pointer feeds a launch the trace cannot see (a ctypes
            # call outside a kernel wrapper): refuse it, never hand one out
            raise RuntimeError("a raw data pointer of a traced tensor "
                               "(a launch outside the kernel wrappers)")
        return real(self)
    return data_ptr


def _host_data_probe(real):
    def make(data, *args, device=None, **kwargs):
        if getattr(_ACTIVE, "rec", None) is None or device is None \
                or torch.is_tensor(data) \
                or torch.device(device).type == "cpu":
            return real(data, *args, device=device, **kwargs)
        # built on the host, then moved by a traced copy: made directly on
        # a card, the tensor would be allocated there before the trace
        return real(data, *args, **kwargs).to(device)
    return make


def _probe(owner, name, real, kind):
    def call(*args, **kwargs):
        rec = getattr(_ACTIVE, "rec", None)
        if rec is None:
            return real(*args, **kwargs)
        if kind == "sync":
            rec.syncs.append(f"{owner}.{name}()")
        else:
            rec.reseeds.append(f"{owner}.{name}()")
        return None
    return call


@contextlib.contextmanager
def _certifying(rec: _Recorder):
    """Mark the calling thread as certifying (its host syncs and global
    seeding calls are recorded into ``rec`` and skipped)."""
    with _PATCH_LOCK:
        if _PATCH_DEPTH[0] == 0:
            for owner, mod, name in _SYNC_CALLS + _SEED_CALLS:
                real = getattr(mod, name)
                _ORIGINALS[(id(mod), name)] = (mod, name, real)
                kind = "sync" if (owner, mod, name) in _SYNC_CALLS \
                    else "seed"
                setattr(mod, name, _probe(owner, name, real, kind))
            for owner, name, probe in (
                    (torch.Tensor, "numpy", _numpy_probe),
                    (torch.Tensor, "data_ptr", _data_ptr_probe),
                    (torch, "tensor", _host_data_probe),
                    (torch, "as_tensor", _host_data_probe)):
                real = getattr(owner, name)
                _ORIGINALS[(id(owner), name)] = (owner, name, real)
                setattr(owner, name, probe(real))
        _PATCH_DEPTH[0] += 1
    outer = getattr(_ACTIVE, "rec", None)
    _ACTIVE.rec = rec
    try:
        yield
    finally:
        _ACTIVE.rec = outer
        with _PATCH_LOCK:
            _PATCH_DEPTH[0] -= 1
            if _PATCH_DEPTH[0] == 0:
                for mod, name, real in _ORIGINALS.values():
                    setattr(mod, name, real)
                _ORIGINALS.clear()


# ---------------------------------------------------------------- fakes --
def _fake_mode(trees) -> FakeTensorMode:
    """The fake mode of the first already-fake leaf, else a new one."""
    for x in tree_leaves(trees):
        if isinstance(x, FakeTensor):
            return x.fake_mode
    # an operator without a fake implementation raises (ZC100) instead of
    # running for real on zero-filled inputs
    return FakeTensorMode(allow_non_fake_inputs=True,
                          allow_fallback_kernels=False)


def _fake_tree(tree, mode: FakeTensorMode):
    """Each tensor leaf as a fake of it (no copy); a ``torch.Generator``
    leaf as a private generator (the engine may seed it; the job's own
    stays as it was). Fake operators draw nothing, so the private one's
    stream is never read: it starts from a seed of its own, and any state
    it ends in other than that one was seeded or restored by the body."""
    def leaf(x):
        if isinstance(x, FakeTensor):
            return x
        if torch.is_tensor(x):
            return mode.from_tensor(x)
        if isinstance(x, torch.Generator):
            return torch.Generator(device=x.device).manual_seed(_SENTINEL)
        return x
    return tree_map(leaf, tree)


def _fake_stack(stack, mode: FakeTensorMode, device):
    """The window stack as the farm hands it to the engine: each array
    leaf a tensor on the job's ``device`` (the state's; ``place_stack``),
    here a fake of its shape and dtype there."""
    def leaf(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not torch.is_tensor(x) or isinstance(x, FakeTensor):
            return x
        if device is None or x.device == device:
            return mode.from_tensor(x)
        with mode:
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device=device)
    return tree_map(leaf, stack)


def _walk_paths(t, path: str, out: List[str]) -> None:
    if isinstance(t, dict):
        for k, v in t.items():
            _walk_paths(v, f"{path}/{k}", out)
    elif isinstance(t, (tuple, list)):
        for i, v in enumerate(t):
            _walk_paths(v, f"{path}/{i}", out)
    else:
        out.append(path)


def _paths(tree, prefix: str) -> List[str]:
    """Leaf labels in ``tree_leaves`` order."""
    out: List[str] = []
    _walk_paths(tree, prefix, out)
    return out


def _describe(x) -> str:
    if torch.is_tensor(x):
        dtype = str(x.dtype).replace("torch.", "")
        return f"{dtype}{list(x.shape)}"
    return type(x).__name__


# ------------------------------------------------------ carry contract --
def _compare_carry(label: str, tree_in, tree_out) -> List[Finding]:
    if tree_structure(tree_in) != tree_structure(tree_out):
        return [_finding(
            "ZC104", f"{label} carry tree structure changed across the "
            "window",
            f"in {tree_structure(tree_in)}, out {tree_structure(tree_out)}:"
            " the scheduler feeds window k's carry into window k+1")]
    findings = []
    for path, a, b in zip(_paths(tree_in, label), tree_leaves(tree_in),
                          tree_leaves(tree_out)):
        if torch.is_tensor(a):
            if not torch.is_tensor(b) or a.shape != b.shape \
                    or a.dtype != b.dtype:
                findings.append(_finding(
                    "ZC104", f"{label} carry leaf {path} drifts "
                    f"{_describe(a)} -> {_describe(b)}",
                    "a shape or dtype drift in the window carry changes "
                    "every window's input (and each new shape captures or "
                    "compiles anew)"))
        elif isinstance(a, (bool, int, float, complex, np.generic)) \
                and torch.is_tensor(b):
            if tuple(b.shape) == np.shape(a):
                findings.append(_finding(
                    "ZC105", f"{label} carry leaf {path} is a bare "
                    f"{type(a).__name__} that comes out as {_describe(b)}",
                    "the carry changes type after the first window; seed "
                    "the state with tensors of the dtype it keeps"))
            else:
                findings.append(_finding(
                    "ZC104", f"{label} carry leaf {path} drifts "
                    f"{_describe(a)} -> {_describe(b)}",
                    "a shape drift in the window carry"))
    return findings


# ---------------------------------------------------------------- trace --
@dataclasses.dataclass
class Trace:
    """One engine call on fake tensors (:func:`trace_engine`): the fake
    ``(state, shell, stack)`` it was handed and their leaves, the
    generators among them with their states before the call, what it
    returned or raised, the recorder's findings, and the kernel calls
    (by name) and their summed cost (``kernels.note_traced``)."""
    fakes: tuple
    ins: list
    gens: list
    out: Any
    failure: Optional[BaseException]
    rec: _Recorder
    kernels: Dict[str, int]
    kernel_cost: Dict[str, float]


def trace_engine(engine: Callable, state, shell, stack, *,
                 top: Optional[TorchDispatchMode] = None) -> Trace:
    """Call ``engine`` once on fakes of ``state``/``shell``/``stack``
    (real or already-fake leaves) under the fake mode, with the recorder
    on top of it and ``top`` (a dispatch mode, e.g. the roofline's cost
    counter) above both, so that ``top`` sees every operator first.
    Nothing is launched, built or allocated on a card; parameters the
    engine closes over are read as their fakes, and a write to one lands
    on its fake. A ``WindowGraphs`` is traced through its ``.engine``
    (calling it would replay or capture a graph). An exception the
    engine raises is returned in ``failure``, not raised."""
    if isinstance(engine, WindowGraphs):
        engine = engine.engine  # its __call__ replays or captures a graph
    mode = _fake_mode((state, shell, stack))
    allowed, mode.allow_non_fake_inputs = mode.allow_non_fake_inputs, True
    rec = _Recorder(mode)
    out = failure = None
    try:
        device = next((x.device for x in tree_leaves((state, shell))
                       if torch.is_tensor(x)), None)
        fakes = (_fake_tree(state, mode), _fake_tree(shell, mode),
                 _fake_stack(stack, mode, device))
        ins = [tree_leaves(t) for t in fakes]
        gens = [(g, g.get_state()) for t in ins for g in t
                if isinstance(g, torch.Generator)]
        traced_counts(reset=True)
        traced_cost(reset=True)
        modes = (mode, rec) + ((top,) if top is not None else ())
        try:
            with _certifying(rec), contextlib.ExitStack() as stack_:
                for m in modes:
                    stack_.enter_context(m)
                out = engine(*fakes)
        except Exception as e:      # noqa: BLE001 — reported, not fatal
            failure = e
        finally:
            kernels = traced_counts(reset=True)
            kernel_cost = traced_cost(reset=True)
    finally:
        mode.allow_non_fake_inputs = allowed
    return Trace(fakes=fakes, ins=ins, gens=gens, out=out, failure=failure,
                 rec=rec, kernels=kernels, kernel_cost=kernel_cost)


# -------------------------------------------------------------- certify --
def certify_engine(engine: Callable, state, shell, stack, *,
                   scope=None, state_is_factory: bool = False,
                   replay_copy: bool = False,
                   name: str = "engine") -> CertReport:
    """Certify one engine against the rule catalog by one call on fake
    tensors (:func:`trace_engine`). ``state``/``shell``/``stack`` are the
    initial trees (real or already-fake leaves). ``state_is_factory``
    says the job rebuilds its initial state per attempt (``FarmJob.state``
    is callable) and ``replay_copy`` that the farm always dispatches it
    from a copy (a solo job); either makes an in-place state update
    replay-safe (ZC103). ``scope`` is the job's ScopeSpec (or None) for
    the fused-plane rule (ZC107)."""
    report = CertReport(name=name)
    if engine is None:
        report.findings.append(_finding(
            "ZC100", "job has no engine", "nothing to certify"))
        return report
    tr = trace_engine(engine, state, shell, stack)
    fakes, ins, gens, out, failure, rec = (tr.fakes, tr.ins, tr.gens,
                                           tr.out, tr.failure, tr.rec)
    report.kernels = tr.kernels

    # ---- host syncs (recorded even where the trace then failed)
    for what in dict.fromkeys(rec.syncs):
        report.findings.append(_finding(
            "ZC101", f"host sync in window body: {what}",
            "every window dispatch waits for the card here — a hidden "
            "sync point that ends the drain/compute overlap"))
    if failure is not None:
        report.findings.append(_finding(
            "ZC100", "engine failed to trace on fake tensors",
            f"{type(failure).__name__}: {failure}"))
        return report

    # ---- in-place writes ("donation" in eager PyTorch)
    for label, tree, leaves in zip(("state", "shell", "stack"), fakes, ins):
        report.writes += [
            p for p, x in zip(_paths(tree, label), leaves)
            if torch.is_tensor(x)
            and StorageWeakRef(x.untyped_storage()) in rec.written]
    bad = [w for w in report.writes if not w.startswith("state")]
    if bad:
        report.findings.append(_finding(
            "ZC102", "engine writes the shell or the window stack in "
            "place: " + ", ".join(bad[:4]),
            "only the state (arg 0) may be updated in place: the shell "
            "snapshot must survive the dispatch until its deferred drain, "
            "the window stack until the window is accepted"))
    writes_state = any(w.startswith("state") for w in report.writes)
    if writes_state and not (state_is_factory or replay_copy):
        report.findings.append(_finding(
            "ZC103", "engine writes its state in place with no copy to "
            "replay from",
            "a lane-packed run hands a leaf shared by identity across "
            "lanes to the engine uncopied; the update lands on the job's "
            "own tree and a requeue replays from the updated state — make "
            "FarmJob.state a zero-arg factory"))
    if writes_state and scope is not None and getattr(scope, "fuse", False):
        report.findings.append(_finding(
            "ZC107", "ScopeSpec(fuse=True) plane over an in-place engine",
            "the fused counter update is traced into the same dispatch "
            "and reads outputs the engine's in-place state writes may "
            "alias — run the plane unfused (fuse=False) or return fresh "
            "state"))

    # ---- carry contract
    if not (isinstance(out, tuple) and len(out) == 3):
        report.findings.append(_finding(
            "ZC104", "engine does not return a (state, shell, ys) triple",
            f"returned structure: {tree_structure(out)}"))
    else:
        report.findings.extend(_compare_carry("state", fakes[0], out[0]))
        report.findings.extend(_compare_carry("shell", fakes[1], out[1]))

    # ---- RNG discipline
    reseeded = list(dict.fromkeys(rec.reseeds)) + [
        "a generator in the carry" for g, s in gens
        if not torch.equal(g.get_state(), s)]
    if reseeded or rec.default_rng:
        what = (f"re-seeded inside the window ({', '.join(reseeded)})"
                if reseeded else
                "the global default generator sampled by "
                + ", ".join(dict.fromkeys(rec.default_rng)))
        report.findings.append(_finding(
            "ZC106", f"RNG stream: {what}",
            "a generator re-seeded or restored to a fixed state draws the "
            "same stream every window; the global generator is shared by "
            "every slot thread and lane, so their draws interleave — "
            "carry a torch.Generator in the state and pass it"))
    return report


def job_trees(job):
    """The ``(state, shell, stack)`` a built
    :class:`~repro_torch.farm.manager.FarmJob` (duck-typed: anything with
    windows/state/shell/stack_fn) dispatches its first window with, or
    None where it has no window: the first window stacked by the job's
    ``stack_fn``, a zero-arg state or shell factory called. Both may
    allocate (a factory's state, a stack on the card); a caller that
    holds certification itself to allocating nothing builds these first
    and passes them to :func:`certify_job`."""
    try:
        win0 = next(job._window_iter(), None)
    except AttributeError:      # duck-typed job without the helper
        windows = getattr(job, "windows", None)
        w = windows() if callable(windows) else windows
        win0 = next(iter(w), None) if w is not None else None
    if win0 is None:
        return None
    stack_fn = getattr(job, "stack_fn", None)
    state = getattr(job, "state", None)
    shell = getattr(job, "shell", None)
    return (state() if callable(state) else state,
            shell() if callable(shell) else shell,
            stack_fn(win0) if stack_fn is not None else win0)


def certify_job(job, trees=None) -> CertReport:
    """Certify a built :class:`~repro_torch.farm.manager.FarmJob` on the
    trees of its first window (``trees``, or :func:`job_trees`'); the
    engine itself only ever runs on fake tensors. A solo job (no
    ``lane_key``) always dispatches from a replay copy."""
    name = getattr(job, "name", "job")
    engine = getattr(job, "engine", None)
    if engine is None:
        r = CertReport(name=name)
        r.findings.append(_finding(
            "ZC100", "job has no engine", "nothing to certify"))
        return r
    if trees is None:
        trees = job_trees(job)
    if trees is None:
        return CertReport(name=name)    # no windows: nothing dispatches
    return certify_engine(
        engine, *trees,
        scope=getattr(job, "scope", None),
        state_is_factory=callable(getattr(job, "state", None)),
        replay_copy=getattr(job, "lane_key", None) is None,
        name=name)


def certify_spec(spec, registry=None) -> CertReport:
    """Build a :class:`~repro_torch.farm.registry.JobSpec` and certify the
    resulting job (the ``python -m repro_torch.analysis`` path; the
    factory itself may touch the card to build its initial trees — the
    ENGINE's certification stays trace-only)."""
    return certify_job(spec.build(registry))


def warm_fake_device(device) -> None:
    """Make now torch's one-time touch of a card for fake tensors: the
    first fake tensor a process makes on a device allocates and frees one
    4-byte tensor there (``fake_tensor.init_gpu_context``, once per device
    name, "cuda" and "cuda:0" apart). A caller that measures the card's
    peak across a certification calls this first."""
    device = torch.device(device)
    names = {device}
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        names = {torch.device("cuda"), torch.device("cuda", index)}
    with FakeTensorMode():
        for d in names:
            torch.empty(1, device=d)


# ----------------------------------------------------- no-device guard --
@contextlib.contextmanager
def no_dispatch_guard():
    """Fail-fast context proving certification never reaches a card: a
    CUDA-graph replay or a kernel library load (and so a build) inside the
    block raises at once, and the block fails at its end if a kernel
    wrapper counted a launch or the card's allocated bytes changed. Every
    boardcheck pass runs clean under it (tests hold certification to it).
    The traps are process-wide: use it where nothing else dispatches."""
    from repro_torch.core.graphs import counted_kernels
    from repro_torch.kernels import _build

    def blocked(what):
        def call(*args, **kwargs):
            raise AssertionError(
                f"{what} during certification — boardcheck must be "
                "trace-only (fake tensors, no dispatch)")
        return call

    kernels = counted_kernels()
    launches = {k: fn.launches for k, fn in kernels.items()}
    cuda = torch.cuda.is_available()
    allocated = torch.cuda.memory_allocated() if cuda else 0
    real_replay, real_load = torch.cuda.CUDAGraph.replay, _build.load
    torch.cuda.CUDAGraph.replay = blocked("a CUDA-graph replay")
    _build.load = blocked("a kernel build or load")
    try:
        yield
    finally:
        torch.cuda.CUDAGraph.replay, _build.load = real_replay, real_load
    after = {k: fn.launches for k, fn in kernels.items()}
    if after != launches:
        raise AssertionError(
            f"kernel launches during certification ({launches} -> "
            f"{after}) — boardcheck must be trace-only (fake tensors, no "
            "dispatch)")
    if cuda and torch.cuda.memory_allocated() != allocated:
        raise AssertionError(
            "device memory allocated during certification — boardcheck "
            "must be trace-only (fake tensors, no dispatch)")
