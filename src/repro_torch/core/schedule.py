"""The window scheduler: one host loop for every P-Shell client.

The scheduler owns window pipelining (the FireSim lesson: keep the device
busy while the host lags):

  * batch stacking — each window's per-step items are stacked into one
    (g, ...) payload per leaf;
  * one dispatch per clock-gated window — the *engine* is any
    ``(state, shell, batch_stack) -> (state, shell_snapshot, ys)``
    callable;
  * double-buffered shell + overlapped drain — in ``overlap`` mode the
    window's output shell is kept aside as a drain snapshot while
    ``reset`` (``pshell.group_reset``) hands the next window a fresh
    shell. Right after the dispatch the snapshot and ys are queued for
    non-blocking copies into pinned host buffers, behind the window's own
    kernels, and a CUDA event is recorded. The drain of window *i* waits
    on that event only, so it runs while window *i+1*'s kernels are queued
    on the device. (A plain blocking ``.cpu()`` at the drain would queue
    behind window *i+1* on the one stream and silently serialise the
    pipeline.)
  * tail windows — a step count not divisible by the interval yields a
    final smaller window, executed and drained exactly once;
  * barrier points — a ``DrainBarrier`` forces the in-flight window to be
    drained and ACCEPTED by the host before its action runs.

Engines may update the model state in place (the reference donates it),
never the shell: the snapshot must survive until its deferred drain.

``run_many`` schedules several engines through one pass — the ZP-Farm
shape: many DUT boards, one host; window *w* of every engine is dispatched
back-to-back before any engine's window *w-1* results are waited for, so
every board's compute overlaps every board's drain. Farm hooks (all
optional, the bare 4-tuple form is unchanged):

  * per-client plumbing — a :class:`Client` carries its OWN drain_fn /
    stack_fn / reset, so one pass can mix shell-ful (train, decode) and
    shell-less (verify) boards;
  * device-aware dispatch — ``place_fn(k, stack)`` runs right before
    client *k*'s engine call (the farm moves the window payload onto the
    client's device there), and ``on_dispatch(k, plan, state)`` fires
    right after the dispatch is enqueued;
  * pluggable completion policy — a :class:`ClientPolicy` is consulted at
    every round boundary (the farm's drain boundary): ``admit`` grows the
    pass with new clients, ``evict`` cancels a straggling/faulted client
    BEFORE its next dispatch (its undrained in-flight window is discarded,
    never delivered), ``done`` frees the client's device slot.

Lanes (:class:`LaneBatch`) fuse N identical-arch boards into one dispatch
stream: ``torch.func.vmap`` of the solo engine over a leading lane axis,
the port's counterpart of the reference's ``jax.jit(jax.vmap(engine))``.
A kernel wrapper reached inside a vmapped engine needs a vmap rule (K1
has one: the lane axis folds into the kernel's batch axis); a wrapper
without one raises on CUDA tensors, and nothing runs the lanes one after
another while claiming to be fused.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence)

import torch

from repro_torch.analysis.annotations import thread_confined
from repro_torch.core.pshell import drain as shell_drain
from repro_torch.core.pshell import group_reset, stack_batches
from repro_torch.core.scope import as_plane
from repro_torch.utils import (tree_leaves, tree_map, tree_structure,
                               tree_unflatten)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One clock-gated window: ``size`` consecutive steps from ``start``."""
    index: int          # window ordinal within the run
    start: int          # global index of the window's first step
    size: int           # steps in this window (the tail window may be short)

    @property
    def last(self) -> int:
        """Global index of the window's last step (the drain cadence id)."""
        return self.start + self.size - 1

    @property
    def boundary(self) -> int:
        """Step count after this window completes."""
        return self.start + self.size


@dataclasses.dataclass(frozen=True)
class DrainBarrier:
    """A host commit point: when a window crosses a multiple of ``every``,
    the scheduler drains that window (in overlap mode this forfeits ONE
    window's drain/compute overlap, no more) so the host has accepted every
    step up to the boundary, then calls ``action(state, boundary_step)``."""
    every: int
    action: Callable[[Any, int], None]

    def fires(self, plan: WindowPlan) -> bool:
        return plan.boundary // self.every > plan.start // self.every


_INHERIT = object()         # Client field sentinel: use the scheduler's own


@dataclasses.dataclass
class Client:
    """One ``run_many`` board with per-client plumbing. Fields left at
    ``_INHERIT`` fall back to the scheduler's drain_fn/stack_fn/reset, so a
    bare ``(engine, windows, state, shell)`` tuple and
    ``Client(engine, windows, state, shell)`` behave identically.
    ``barriers`` are per-client :class:`DrainBarrier`\\ s — each client
    commits at its OWN window boundaries (the farm's per-job checkpoint
    path), independent of its neighbors' progress.

    ``start_step`` / ``start_index`` are the RESUME cursor: a client whose
    window stream was cut at a committed barrier re-enters the pass with
    the remaining windows only, and its plans carry the true global step /
    window ids — so barrier ``fires`` math, ``on_drain`` cadence, and
    tail-window sizing stay correct for non-divisible streams."""
    engine: Callable
    windows: Iterable
    state: Any = None
    shell: Any = None
    drain_fn: Any = _INHERIT
    stack_fn: Any = _INHERIT
    reset: Any = _INHERIT
    barriers: Sequence = ()
    start_step: int = 0
    start_index: int = 0
    lanes: int = 1      # >1: a LaneBatch-fused client driving N boards
    scope: Any = None   # ScopeSpec/ScopePlane: opt into the ZP-Scope
    # instrumentation plane — normalization binds the client's engine /
    # shell / drain / reset so device counters ride the window carry
    # (per-lane counter slices under a fused client)


class ClientPolicy:
    """Pluggable client-completion policy for :meth:`WindowScheduler.
    run_many` (the ZP-Farm manager implements this). The scheduler consults
    the policy once per scheduling round — a round is one window of every
    live client, i.e. the farm's drain boundary:

      ``admit(round_idx)`` -> iterable of new clients (tuples or
          :class:`Client`) appended to the pass — dynamic admission; client
          indices are assigned in admission order and never reused.
      ``evict(k)`` -> True to cancel client *k* before its next dispatch.
          The client's in-flight (undrained) window is DISCARDED, not
          flushed: an evicted job is requeued and resumed elsewhere, so
          partial results must never reach ``on_drain`` twice.
      ``done(k, state, shell)`` — client *k* dispatched its last window and
          its final drain was delivered; its device slot is free (the
          admission point for the next queued job).
      ``crashed(k, exc)`` -> True to ABSORB an exception raised while
          driving client *k* (its dispatch/advance/flush): the client is
          cancelled (in-flight windows discarded) and the pass continues —
          the farm's requeue path for a crashing board. False (default)
          re-raises: one board's crash kills the lockstep pass.
    """

    def admit(self, round_idx: int):
        return ()

    def evict(self, k: int) -> bool:
        return False

    def done(self, k: int, state, shell):
        pass

    def crashed(self, k: int, exc: BaseException) -> bool:
        return False


def plan_windows(steps: int, interval: int, start: int = 0) -> List[WindowPlan]:
    """Partition steps [start, steps) into interval-sized windows plus a
    tail, aligned to ``start``."""
    interval = max(1, interval)
    plans = []
    i = start
    while i < steps:
        g = min(interval, steps - i)
        plans.append(WindowPlan(index=len(plans), start=i, size=g))
        i += g
    return plans


def iter_windows(items: Iterable[Any], interval: int):
    """Chunk a finite iterable of per-step items into window-sized lists."""
    interval = max(1, interval)
    buf: list = []
    for x in items:
        buf.append(x)
        if len(buf) == interval:
            yield buf
            buf = []
    if buf:
        yield buf


class _NullTimer:
    @contextmanager
    def phase(self, name: str):
        yield


def _to_host(tree):
    """Queue non-blocking copies of a tree's device tensors into fresh
    pinned host buffers on the current stream; returns (host_tree, event).
    The event completes when the copies have; host tensors pass through
    (with no event)."""
    leaves = [t for t in tree_leaves(tree) if torch.is_tensor(t)]
    if not any(t.is_cuda for t in leaves):
        return tree, None

    def copy(t):
        if not (torch.is_tensor(t) and t.is_cuda):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    host = tree_map(copy, tree)
    event = torch.cuda.Event()
    event.record()
    return host, event


class WindowScheduler:
    """Owns the host loop shared by the port's P-Shell clients.

    Parameters
    ----------
    interval : the clock-gating granularity (steps per window) — used only
        by :meth:`windows`; ``run`` consumes whatever window lists it is
        given.
    overlap : double-buffer the shell and defer each window's drain until
        the next window has been dispatched. ``False`` drains serially in
        place.
    reset : device-side shell reset deriving the NEXT window's shell from
        the current snapshot (``pshell.group_reset`` by default whenever
        overlapping with the P-Shell ``drain_fn``). Explicit ``None`` +
        ``drain_fn=None`` passes the snapshot through (shell-less clients).
    drain_fn : host-side ``shell -> (records, reset_shell)``; ``None``
        for clients whose results ride entirely in ``ys``.
    stack_fn : stacks a window's item list into the engine payload;
        ``None`` hands the engine the raw item list.
    timer : object with a ``phase(name)`` context manager: "data" = window
        assembly, "device" = the dispatch (engine call, shell reset and the
        queued host copies: nothing in it may wait on the device), "host" =
        drains and barriers.
    """

    def __init__(self, interval: int = 1, *, overlap: bool = True,
                 reset: Optional[Callable] = None,
                 drain_fn: Optional[Callable] = shell_drain,
                 stack_fn: Optional[Callable] = stack_batches,
                 timer: Any = None):
        self.interval = max(1, interval)
        self.overlap = overlap
        if overlap and reset is None and drain_fn is not None:
            if drain_fn is shell_drain:
                reset = group_reset
            else:
                raise ValueError(
                    "overlap=True with a drain_fn needs a device-side "
                    "`reset` to double-buffer the shell — without one the "
                    "un-reset snapshot becomes the live shell and every "
                    "drain re-reads prior windows' rows (pass reset=, or "
                    "an explicit identity lambda for non-accumulating "
                    "shells)")
        self.reset = reset
        self.drain_fn = drain_fn
        self.stack_fn = stack_fn
        self.timer = timer if timer is not None else _NullTimer()

    def windows(self, items: Iterable[Any]):
        return iter_windows(items, self.interval)

    def run(self, engine, windows, state, shell, *, start_step: int = 0,
            on_drain: Optional[Callable] = None,
            on_dispatch: Optional[Callable] = None,
            on_window: Optional[Callable] = None,
            barriers: Sequence[DrainBarrier] = (),
            scope: Any = None):
        """Drive ``engine`` over ``windows`` (an iterable of per-step item
        lists). Returns ``(state, last_ys, shell)``. ``start_step`` is the
        global index of the first window's first step (a resumed run):
        plans, drain ids and barrier boundaries count from it.

        Callbacks: ``on_dispatch(plan, state)`` fires right after a
        window's dispatch is enqueued; ``on_drain(plan, records, ys)`` fires
        once per window in window order with the drained shell records and
        the window's ys as host tensors — raising here vetoes any barrier
        commit that depends on the window; ``on_window(plan, state)`` fires
        after the window's host phase (profiler step accounting).

        ``scope`` (a ``ScopeSpec`` or ``ScopePlane``) opts the pass into
        the ZP-Scope plane (``core/scope.py``): device counters ride
        beside the shell, and the plane samples them at its read rate
        from the drained snapshot (on the overlapped path, from the host
        copy the dispatch queued, so the plane adds no host sync). The
        returned state, ys and shell are bit-identical to an
        un-instrumented pass (``plane.finalize`` unwraps the composite
        shell before return).

        The pass is one :class:`ClientDriver` driven to its end: the same
        pipeline ``run_many`` composes per client.
        """
        relay = None
        if on_dispatch is not None:
            def relay(_key, plan, st):
                on_dispatch(plan, st)
        d = self.driver(Client(engine, windows, state, shell,
                               barriers=barriers, start_step=start_step,
                               scope=scope),
                        on_drain=on_drain, on_dispatch=relay)
        while (plan := d.dispatch()) is not None:
            d.advance()
            if on_window is not None:
                on_window(plan, d.state)
        d.flush()
        shell = d.shell if scope is None else d.c.scope.finalize(d.shell)
        return d.state, d.last_ys, shell

    # -------------------------------------------------------------- multi --
    def _normalize_client(self, c) -> Client:
        if not isinstance(c, Client):
            engine, windows, state, shell = c
            c = Client(engine, windows, state, shell)
        drain_fn = self.drain_fn if c.drain_fn is _INHERIT else c.drain_fn
        stack_fn = self.stack_fn if c.stack_fn is _INHERIT else c.stack_fn
        reset = self.reset if c.reset is _INHERIT else c.reset
        if self.overlap and drain_fn is not None and reset is None:
            if drain_fn is shell_drain:
                reset = group_reset
            else:
                raise ValueError(
                    "run_many client with overlap=True and a drain_fn "
                    "needs a device-side `reset` to double-buffer its "
                    "shell (see WindowScheduler.__init__)")
        if c.scope is None:
            return dataclasses.replace(c, drain_fn=drain_fn,
                                       stack_fn=stack_fn, reset=reset)
        # ZP-Scope opt-in: bind the resolved plumbing so the counter tree
        # rides beside the DUT shell. Applied LAST so the counters see the
        # same engine/drain the un-instrumented client would run — the
        # bit-identity invariant the scope gate checks.
        plane = as_plane(c.scope, lanes=c.lanes)
        engine, shell, drain_fn, reset = plane.bind(
            c.engine, c.shell, drain_fn, reset)
        return dataclasses.replace(c, engine=engine, shell=shell,
                                   drain_fn=drain_fn, stack_fn=stack_fn,
                                   reset=reset, scope=plane)

    def driver(self, client, *, key=None,
               on_drain: Optional[Callable] = None,
               on_dispatch: Optional[Callable] = None,
               place_fn: Optional[Callable] = None,
               on_commit: Optional[Callable] = None,
               inject: Optional[Callable] = None) -> "ClientDriver":
        """A thread-confinable per-client pipeline over this scheduler's
        window/overlap settings (see :class:`ClientDriver`)."""
        return ClientDriver(self, client, key=key, on_drain=on_drain,
                            on_dispatch=on_dispatch, place_fn=place_fn,
                            on_commit=on_commit, inject=inject)

    def run_many(self, clients, on_drain: Optional[Callable] = None, *,
                 on_dispatch: Optional[Callable] = None,
                 place_fn: Optional[Callable] = None,
                 policy: Optional[ClientPolicy] = None,
                 on_commit: Optional[Callable] = None,
                 inject: Optional[Callable] = None):
        """ZP-Farm pass: ``clients`` is a list of ``(engine, windows,
        state, shell)`` tuples or :class:`Client`\\ s (per-client drain /
        stack / reset / barriers). Window *w* of EVERY client is dispatched
        before any client's window *w-1* is drained, so each engine's drain
        overlaps every engine's queued compute. Clients may have different
        window counts; a finished client's last pending window drains in
        the round it stops dispatching (after every still-alive client's
        dispatch, preserving the dispatch-before-fetch order).

        The per-client machinery lives in :class:`ClientDriver`; this
        method composes one driver per client round-robin on the CALLING
        thread — the lockstep host loop, where one slow client's dispatch
        delays every other client's next enqueue.

        ``on_drain(client_idx, plan, records, ys)`` (ys as host tensors,
        as ``run`` delivers them); ``on_dispatch(client_idx, plan, state)``
        fires right after a client's window dispatch is enqueued;
        ``place_fn(client_idx, stack)`` maps the stacked window payload
        right before the engine call (device placement); ``policy`` is a
        :class:`ClientPolicy` for dynamic admission / eviction / slot-free
        notification; ``on_commit(client_idx, plan, state, shell)`` fires
        after a client's barrier actions committed a window boundary (the
        farm's snapshot hook); ``inject(client_idx, point, plan)`` is the
        fault-injection hook threaded into every driver (see
        :class:`ClientDriver`). A driver raising while driven is offered
        to ``policy.crashed(k, exc)`` — absorbed crashes cancel the client
        and the pass continues. Returns the list of final ``(state,
        shell)`` per client index (admitted clients included, in admission
        order). With one client and no hooks the pass equals :meth:`run`
        bit for bit: the same calls in the same order."""
        def make(c):
            return self.driver(c, key=len(drivers), on_drain=on_drain,
                               on_dispatch=on_dispatch, place_fn=place_fn,
                               on_commit=on_commit, inject=inject)

        def absorb(d, exc):
            # a crashing board: discard its in-flight windows and let the
            # policy requeue it, instead of one crash killing the pass
            if policy is not None and policy.crashed(d.key, exc):
                d.cancel()
                return True
            return False

        drivers: List[ClientDriver] = []
        for c in clients:
            drivers.append(make(c))
        rnd = 0
        while True:
            if policy is not None:
                for c in policy.admit(rnd):
                    drivers.append(make(c))
            if all(d.exhausted for d in drivers):
                break
            progressed = []
            finished = []
            for k, d in enumerate(drivers):
                if d.exhausted:
                    continue
                if policy is not None and policy.evict(k):
                    d.cancel()              # discard, never deliver
                    continue
                try:
                    plan = d.dispatch()
                except Exception as e:      # noqa: BLE001 — policy decides
                    if absorb(d, e):
                        continue
                    raise
                if plan is None:
                    finished.append(d)
                else:
                    progressed.append(d)
            for d in finished:          # after every live client dispatched
                try:
                    d.flush()
                except Exception as e:      # noqa: BLE001 — policy decides
                    if absorb(d, e):
                        continue
                    raise
                if policy is not None:
                    policy.done(d.key, d.state, d.shell)
            for d in progressed:
                try:
                    d.advance()
                except Exception as e:      # noqa: BLE001 — policy decides
                    if not absorb(d, e):
                        raise
            rnd += 1
        for d in drivers:
            d.flush()
        return [(d.state, d.shell) for d in drivers]

    # ----------------------------------------------------------- plumbing --
    def _drain_now(self, snap, drain_fn=_INHERIT):
        drain_fn = self.drain_fn if drain_fn is _INHERIT else drain_fn
        if drain_fn is None:
            return {}, snap
        return drain_fn(snap)

    def _flush(self, pending, on_drain, drain_fn=_INHERIT, client=None):
        if pending is None:
            return
        drain_fn = self.drain_fn if drain_fn is _INHERIT else drain_fn
        plan, snap, ys, event = pending
        if event is not None:
            event.synchronize()     # this window's copies only
        # the snapshot's reset state is discarded: the live shell was
        # reset on the device
        records = drain_fn(snap)[0] if drain_fn is not None else {}
        self._emit(plan, records, ys, on_drain, client=client)

    @staticmethod
    def _emit(plan, records, ys, on_drain, client=None):
        if on_drain is None:
            return
        if client is None:
            on_drain(plan, records, ys)
        else:
            on_drain(client, plan, records, ys)


@thread_confined
class ClientDriver:
    """Thread-confined window pipeline for ONE client (one board's host
    driver).

    Owns every host<->device interaction for its client — window stacking,
    device placement, engine dispatch, shell double-buffer reset, the
    queued host copies, deferred drains, and per-client
    :class:`DrainBarrier` commits — so a caller can confine a client's
    dispatches to one thread or compose many drivers round-robin on a
    single thread (the lockstep :meth:`WindowScheduler.run_many`;
    :meth:`WindowScheduler.run` drives one). The driver itself takes no
    locks: it must only ever be touched from the thread that drives it.
    It times its work in the scheduler's ``timer`` phases: "data" (the
    window's assembly and placement), "device" (the dispatch) and "host"
    (``advance`` and ``flush``).

    Protocol per window:

      ``dispatch()`` — enqueue the next window (stack -> place -> engine
          call -> shell reset -> non-blocking copies of the snapshot and
          ys into pinned host buffers) and return its
          :class:`WindowPlan`, or ``None`` once the window stream is
          exhausted. ``last_ys`` keeps the window's ys on the device.
      ``advance()`` — retire ONE window's drain: in overlap mode the
          PREVIOUS window's (its wait covers that window's copies only,
          while the window just dispatched is queued), in serial mode the
          window just dispatched. Runs any barriers the dispatched window
          crossed — a barrier flushes the in-flight window first, so an
          ``on_drain`` verifier that raises vetoes the commit action.
          When at least one barrier committed, ``on_commit(key, plan,
          state, shell)`` fires with the accepted boundary's state handle
          — the shell is the live (post-reset) one the NEXT window
          consumes, i.e. exactly what a resumed run must start from.
      ``flush()`` — retire the final pending window (stream end).
      ``cancel()`` — drop pending + dispatched windows undelivered and
          mark the driver exhausted (eviction: a requeued job re-runs its
          uncommitted tail elsewhere, so partial results must never reach
          ``on_drain``).

    Resume: the client's ``start_step``/``start_index`` seed the window
    cursor, so a driver over the TAIL of a window stream emits plans with
    the same global ids an uninterrupted run would.

    Fault injection: ``inject(key, point, plan)`` (optional, ``None`` in
    production) fires at the driver's three named points — ``"dispatch"``
    right before the engine call, ``"drain"`` as ``advance()`` starts
    retiring a window, ``"commit"`` right before a crossed barrier's
    actions run. A raising hook models the board failing exactly there; a
    sleeping hook models a hang.
    """

    def __init__(self, sched: "WindowScheduler", client, *, key=None,
                 on_drain: Optional[Callable] = None,
                 on_dispatch: Optional[Callable] = None,
                 place_fn: Optional[Callable] = None,
                 on_commit: Optional[Callable] = None,
                 inject: Optional[Callable] = None):
        self.sched = sched
        self.c = sched._normalize_client(client)
        self.key = key
        self.on_drain = on_drain
        self.on_dispatch = on_dispatch
        self.place_fn = place_fn
        self.on_commit = on_commit
        self.inject = inject
        self._it = iter(self.c.windows)
        self.state = self.c.state
        self.shell = self.c.shell
        self.step = self.c.start_step
        self.index = self.c.start_index
        self.pending = None     # (plan, snapshot, ys, event) awaiting drain
        self._dispatched = None         # window in flight this round
        self.last_ys = None             # the last window's ys, on device
        self.exhausted = False

    def dispatch(self) -> Optional[WindowPlan]:
        if self.exhausted:
            return None
        c = self.c
        timer = self.sched.timer
        with timer.phase("data"):
            items = None
            while not items:            # skip empty windows, don't stall
                try:
                    items = next(self._it)
                except StopIteration:
                    self.exhausted = True
                    return None
            stack = c.stack_fn(items) if c.stack_fn else items
            if self.place_fn is not None:
                stack = self.place_fn(self.key, stack)
        plan = WindowPlan(index=self.index, start=self.step,
                          size=len(items))
        if self.inject is not None:
            self.inject(self.key, "dispatch", plan)
        with timer.phase("device"):
            self.state, snap, ys = c.engine(self.state, self.shell, stack)
            self.last_ys = ys
            event = None
            if self.sched.overlap:
                self.shell = c.reset(snap) if c.reset else snap
                (snap, ys), event = _to_host((snap, ys))
        if self.on_dispatch is not None:
            self.on_dispatch(self.key, plan, self.state)
        self._dispatched = (plan, snap, ys, event)
        self.step += len(items)
        self.index += 1
        return plan

    def advance(self):
        cur, self._dispatched = self._dispatched, None
        if cur is None:
            return
        with self.sched.timer.phase("host"):
            self._retire(cur)

    def _retire(self, cur):
        plan = cur[0]
        if self.inject is not None:
            self.inject(self.key, "drain", plan)
        if self.sched.overlap:
            self._flush_pending()       # previous window's deferred drain
            self.pending = cur
        else:
            _, snap, ys, _ = cur
            records, self.shell = self.sched._drain_now(
                snap, drain_fn=self.c.drain_fn)
            host_ys, event = _to_host(ys)
            if event is not None:
                event.synchronize()
            self.sched._emit(plan, records, host_ys, self.on_drain,
                             client=self.key)
        committed = False
        for b in self.c.barriers:
            if b.fires(plan):
                # commit barrier: every window up to the boundary must be
                # drained and accepted before the action (forfeits ONE
                # window's drain/compute overlap)
                self._flush_pending()
                if not committed and self.inject is not None:
                    self.inject(self.key, "commit", plan)
                b.action(self.state, plan.boundary)
                committed = True
        if committed and self.on_commit is not None:
            self.on_commit(self.key, plan, self.state, self.shell)

    def flush(self):
        with self.sched.timer.phase("host"):
            self._flush_pending()

    def _flush_pending(self):
        pending, self.pending = self.pending, None
        self.sched._flush(pending, self.on_drain, drain_fn=self.c.drain_fn,
                          client=self.key)

    def cancel(self):
        self.pending = None
        self._dispatched = None
        self.exhausted = True


# ------------------------------------------------------------------ lanes --
def _stack_lanes(group):
    return torch.stack([torch.as_tensor(g) for g in group])


def lane_pack(trees):
    """Stack N same-structure trees along a NEW leading lane axis.

    The packing is identity-aware (the stacked-weight memory fix): a leaf
    that is the SAME object in every lane — a weight tree shared across
    boards — is NOT stacked; it passes through as ONE tensor with a
    ``None`` vmap axis, so N lanes hold one device copy instead of N.
    Returns ``(packed, axes_tree, flat_axes)`` where ``axes_tree`` is the
    tree handed to ``vmap`` as in/out dims (0 = stacked, None = broadcast)
    and ``flat_axes`` is the same information in ``tree_leaves`` order,
    which is what :func:`lane_slice` consumes to undo the packing per
    lane."""
    if all(t is None for t in trees):
        return None, None, []
    structure = tree_structure(trees[0])
    for t in trees[1:]:
        if tree_structure(t) != structure:
            raise ValueError("lane_pack: lane trees differ in structure "
                             f"({structure} vs {tree_structure(t)})")
    packed, axes = [], []
    for group in zip(*(tree_leaves(t) for t in trees)):
        if all(g is group[0] for g in group[1:]):
            packed.append(group[0])
            axes.append(None)
        else:
            packed.append(_stack_lanes(group))
            axes.append(0)
    return (tree_unflatten(trees[0], packed),
            tree_unflatten(trees[0], axes), axes)


def lane_slice(tree, flat_axes, k):
    """Lane ``k``'s view of a packed tree: stacked leaves are indexed at
    the lane axis, broadcast (shared) leaves pass through untouched."""
    if tree is None:
        return None
    out = [x if a is None else x[k]
           for x, a in zip(tree_leaves(tree), flat_axes)]
    return tree_unflatten(tree, out)


def lane_fetch(tree, flat_axes):
    """ONE host fetch for a packed tree's stacked leaves (broadcast leaves
    pass through as their device tensors — a shared weight tree is never
    pulled to the host): the stacked leaves are queued as non-blocking
    copies into pinned host buffers and waited for once. Per-lane fan-out
    then takes views of the fetched leaves instead of issuing one device
    gather + copy per lane — N gathers per window is exactly the dispatch
    overhead lane batching exists to remove."""
    if tree is None:
        return None
    leaves = tree_leaves(tree)
    host, event = _to_host([x for x, a in zip(leaves, flat_axes)
                            if a == 0])
    if event is not None:
        event.synchronize()
    fetched = iter(host)
    out = [next(fetched) if a == 0 else x
           for x, a in zip(leaves, flat_axes)]
    return tree_unflatten(tree, out)


# (engine-or-reset, packed structures, vmap axes) -> vmapped wrapper.
# Without this every LaneBatch built over the same base engine — e.g. each
# farm pass that coalesces a fresh batch of compatible jobs — would wrap a
# NEW vmap. Keyed on the engine OBJECT (kept alive by the key, as
# CoEmulator._group_fns: object keys make no-aliasing unconditional where
# id() keys would not).
_FUSED_CACHE: Dict[Any, Callable] = {}


class LaneBatch:
    """N identical-arch boards fused into ONE dispatch stream.

    The solo engine is wrapped in ``torch.func.vmap`` over a leading lane
    axis, the per-lane window streams are zipped step-for-step, and the
    per-lane states/shells are :func:`lane_pack`-ed — so one window
    dispatch drives N boards while ``WindowPlan`` ids, barrier cadences,
    and drain ordering stay exactly what each solo board would have seen.

    Compatibility contract (what "identical-arch" means here):

      * ONE shared engine object that vmaps: no host read of a device
        value inside a window (``.item()``, ``int(tensor)``), no Python
        branch on one, no in-place write of a lane-batched value into an
        unbatched tensor, and every kernel wrapper it reaches has a vmap
        rule (K1 does; the others raise on CUDA tensors). A failing vmap
        raises with the op's name; the lanes are never run one after
        another instead;
      * equal window counts AND equal per-window sizes across lanes
        (streams are zipped per step, tail windows included);
      * same state/shell tree structure with stackable leaf shapes; a leaf
        shared BY IDENTITY across every lane broadcasts as one device
        copy with a ``None`` vmap axis (the stacked-weight fix);
      * a ``stack_fn`` is required (raw per-step item lists cannot stack
        across lanes); ``drain_fn``/``reset`` are optional and are applied
        per lane against shell slices, with drains fanned out as
        ``{"lanes": [records_0, ...records_{N-1}]}``.

    The packed state is a fresh stack, so an engine that updates its
    state in place writes the stack, never a member's own tensors: member
    state/shell objects stay valid replay sources if a lane is evicted
    and requeued as a solo board.
    """

    def __init__(self, engine, windows, states, shells, *, stack_fn,
                 drain_fn=None, reset=None):
        n = len(states)
        if n < 1 or not (len(windows) == len(shells) == n):
            raise ValueError("LaneBatch: windows/states/shells must be "
                             "equal-length and non-empty")
        if stack_fn is None:
            raise ValueError("LaneBatch requires a stack_fn")
        if drain_fn is shell_drain and reset is None:
            reset = group_reset         # same default a solo client gets
        if drain_fn is not None and reset is None:
            raise ValueError("LaneBatch: a custom drain_fn needs an "
                             "explicit reset (fused drains are deferred)")
        self.n = n
        self.base_engine = engine
        self.base_stack = stack_fn
        self.base_drain = drain_fn
        self.base_reset = reset
        self.state, self.state_axes, self._state_flat = lane_pack(states)
        self.shell, self.shell_axes, self._shell_flat = lane_pack(shells)
        self.windows = self.zip_windows(windows)
        self.engine = self._fuse_engine(engine)
        self.reset = self._fuse_reset(reset)

    # The fused plumbing is bound on each read, never stored: a bound
    # method of the batch kept on the batch is a reference cycle, which
    # held a finished run's lane stacks (3.3 GB a run of 8 glm4-9b
    # layers) until the garbage collector ran.
    @property
    def stack_fn(self):
        return self._fused_stack

    @property
    def drain_fn(self):
        return self._fused_drain if self.base_drain is not None else None

    # ---------------------------------------------------------- builders --
    @staticmethod
    def zip_windows(window_lists):
        """Zip per-lane window streams into one fused stream whose plans
        (window count, per-window sizes, step ids) match every solo lane."""
        counts = {len(w) for w in window_lists}
        if len(counts) != 1:
            raise ValueError("LaneBatch: lanes disagree on window count: "
                             f"{sorted(counts)}")
        fused = []
        for w, row in enumerate(zip(*window_lists)):
            sizes = {len(items) for items in row}
            if len(sizes) != 1:
                raise ValueError(f"LaneBatch: window {w} sizes differ "
                                 f"across lanes: {sorted(sizes)}")
            fused.append([tuple(step) for step in zip(*row)])
        return fused

    @staticmethod
    def _tree_key(tree, flat):
        return (None if tree is None else tree_structure(tree),
                tuple(flat))

    def _fuse_engine(self, engine):
        key = ("engine", engine,
               self._tree_key(self.state, self._state_flat),
               self._tree_key(self.shell, self._shell_flat))
        if key not in _FUSED_CACHE:
            _FUSED_CACHE[key] = torch.func.vmap(
                engine, in_dims=(self.state_axes, self.shell_axes, 1),
                out_dims=(self.state_axes, self.shell_axes, 0))
        return _FUSED_CACHE[key]

    def _fuse_reset(self, reset):
        if reset is None:
            return None
        if not any(a == 0 for a in self._shell_flat):
            return reset            # fully shared shell: nothing to map
        key = ("reset", reset, self._tree_key(self.shell, self._shell_flat))
        if key not in _FUSED_CACHE:
            _FUSED_CACHE[key] = torch.func.vmap(
                reset, in_dims=(self.shell_axes,), out_dims=self.shell_axes)
        return _FUSED_CACHE[key]

    def _fused_stack(self, items):
        # items: [step][lane]; restack per lane with the base stack_fn so
        # each lane's payload is byte-identical to its solo run's, then add
        # the lane axis SECOND, after the step axis (one contiguous payload
        # per leaf): step i of every lane is then one contiguous (N, ...)
        # block, which a batched product folds into the rows of one
        # product, as each solo lane's step is; a lane-major stack would
        # hand the product a strided slice, which torch runs as a batched
        # product that rounds differently on the host
        per_lane = list(zip(*items))
        stacks = [self.base_stack(list(steps)) for steps in per_lane]
        return tree_map(lambda *ys: torch.stack(
            [torch.as_tensor(y) for y in ys], dim=1), *stacks)

    def _fused_drain(self, snap):
        recs, resets = [], []
        for k in range(self.n):
            r, s = self.base_drain(self.slice_shell(snap, k))
            recs.append(r)
            resets.append(s)
        # re-pack the per-lane reset shells: serial (non-overlap) mode makes
        # this the live shell, overlap mode discards it after the drain
        packed = [g[0] if a is None else _stack_lanes(g)
                  for g, a in zip(zip(*(tree_leaves(s) for s in resets)),
                                  self._shell_flat)]
        return {"lanes": recs}, tree_unflatten(resets[0], packed)

    # ------------------------------------------------------------ fan-out --
    def slice_state(self, state, k):
        return lane_slice(state, self._state_flat, k)

    def slice_shell(self, shell, k):
        return lane_slice(shell, self._shell_flat, k)

    def fetch_state(self, state):
        """See :func:`lane_fetch` — host views for per-lane state fan-out."""
        return lane_fetch(state, self._state_flat)

    def fetch_shell(self, shell):
        return lane_fetch(shell, self._shell_flat)

    def fan_out_one(self, records, ys, k):
        """Lane ``k``'s (records, ys) exactly as its solo run would have
        delivered them to ``on_drain``."""
        rec = records["lanes"][k] if self.drain_fn is not None else records
        return rec, tree_map(lambda y: y[k], ys)

    def fan_out(self, records, ys):
        return [self.fan_out_one(records, ys, k) for k in range(self.n)]

    def client(self, *, barriers=()) -> Client:
        """A ready-to-run fused :class:`Client` for this batch."""
        return Client(self.engine, self.windows, self.state, self.shell,
                      drain_fn=self.drain_fn, stack_fn=self.stack_fn,
                      reset=self.reset, barriers=barriers, lanes=self.n)
