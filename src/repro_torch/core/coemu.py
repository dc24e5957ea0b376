"""Step-locked co-emulation against a golden model.

The DUT is the optimized step; the oracle is a slower reference
implementation (the plain paths, f32). Both run step-locked on identical
inputs; their commit streams (per-layer checksums) are cross-verified each
step — the Dromajo pattern. The report localizes the FIRST divergent
(step, layer), which is what makes injected faults debuggable.

Group-locked mode (``group_size > 1``): DUT and oracle each dispatch ONCE
per clock-gated window — on the card one CUDA-graph replay
(``core/graphs.py``) whose ys carry every step's checksums — so host
crossings amortize over the window while localization stays exact: the
per-step commit streams are recovered from the window's ys and compared
step by step, bit-for-bit equivalent to step-locked verification.

Both modes run through the core ``WindowScheduler``: DUT and oracle
windows are dispatched back-to-back before EITHER side's checksums are
fetched, and with ``overlap=True`` (default) window *i*'s fetch and
comparison run while window *i+1* is queued on the card
(``overlap=False`` is the serial baseline).

The steps update their state in place (``train/step.py``), where the
reference's JAX values stay unchanged. So the emulator steps copies of its
own: ``verify`` gives each side a working copy of the caller's state (two
copies even where the caller passes one state for both), ``determinism``
steps two clones, and the caller's states are never written. A side's
working copy is kept and refilled in place by the next ``verify``: it is
the static state of that side's captured window graphs, which each side
owns even where both sides run one step function (a shared graph would
copy one side's state over the other's buffers).

``CommitStreamVerifier`` closes the verified-snapshot loop: attached to
the train loop's checkpoint ``DrainBarrier`` path, it replays the same
deterministic batch stream through the oracle and compares the drained
commit FIFO rows window by window — a diverging commit stream raises at
the drain, which vetoes the checkpoint before it can publish.

Multi-DUT mode (``subsystem_boards``, ``submit_subsystem_jobs``,
``verify_subsystems``): every Scale-Down subsystem becomes one board of a
ZP-Farm pass (``repro_torch.farm``), checked against the in-situ
capture's checksums; with ``lanes=True`` same-spec boards fuse into one
vmapped dispatch stream. An enc-dec model has no decoder-only layer stack
to decompose and raises ValueError, as Scale-Down does.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.commit import layer_checksums
from repro_torch.core.graphs import GraphPool, WindowGraphs
from repro_torch.core.pshell import stack_batches
from repro_torch.core.schedule import WindowScheduler, iter_windows
from repro_torch.utils import (tree_clone, tree_leaves, tree_map,
                               tree_paths_sorted)

@dataclasses.dataclass
class Divergence:
    step: int
    layer: int
    rel_err: float
    lane: Optional[int] = None      # lane-batched runs: which board


@dataclasses.dataclass
class CoEmuReport:
    steps: int
    diverged: bool
    first: Optional[Divergence]
    max_rel_err: float
    loss_max_abs_diff: float

    def summary(self) -> str:
        if not self.diverged:
            return (f"PASS: {self.steps} steps verified, "
                    f"max commit rel-err {self.max_rel_err:.2e}")
        return (f"FAIL: first divergence at step {self.first.step} "
                f"layer {self.first.layer} (rel-err {self.first.rel_err:.2e})")


def _rel_err(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a - b) / (np.abs(b) + 1e-6)


def _f64(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def _device(tree) -> torch.device:
    """The device of ``tree``'s first tensor (the host where it holds
    none)."""
    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            return t.device
    return torch.device("cpu")


class _CompareAccumulator:
    """Folds one window's (dut, oracle) checksum/loss ys at a time into the
    running CoEmuReport fields. The ys arrive as host tensors: the
    scheduler queued their copies right after the window's dispatch and
    waited for them at this window's drain only."""

    def __init__(self, rtol: float):
        self.rtol = rtol
        self.first: Optional[Divergence] = None
        self.max_err = 0.0
        self.loss_diff = 0.0
        self.steps = 0

    def ingest(self, step0: int, ys):
        (cks_d, loss_d), (cks_o, loss_o) = ys
        cks_d, cks_o = _f64(cks_d), _f64(cks_o)          # (g, L, 2)
        self._compare(cks_d, cks_o, step0)
        self.loss_diff = max(self.loss_diff, float(np.max(np.abs(
            _f64(loss_d) - _f64(loss_o)))))
        self.steps += cks_d.shape[0]

    def _compare(self, cks_d, cks_o, step0):
        """Per-step (g, L, 2) checksum comparison; records the first
        divergent (step, layer) in window order."""
        err = _rel_err(cks_d, cks_o).max(axis=2)          # (g, L)
        self.max_err = max(self.max_err, float(err.max()))
        if self.first is None:
            bad_steps, bad_layers = np.nonzero(err > self.rtol)
            if bad_steps.size:
                s, l = int(bad_steps[0]), int(bad_layers[0])
                self.first = Divergence(step=step0 + s, layer=l,
                                        rel_err=float(err[s, l]))

    def report(self) -> "CoEmuReport":
        return CoEmuReport(steps=self.steps,
                           diverged=self.first is not None,
                           first=self.first, max_rel_err=self.max_err,
                           loss_max_abs_diff=self.loss_diff)


def _same_layout(a, b) -> bool:
    """Same containers, every leaf a tensor of one shape, dtype and
    device."""
    la, lb = tree_paths_sorted(a), tree_paths_sorted(b)
    return len(la) == len(lb) and all(
        pa == pb and torch.is_tensor(x) and torch.is_tensor(y)
        and x.shape == y.shape and x.dtype == y.dtype
        and x.device == y.device
        for (pa, x), (pb, y) in zip(la, lb))


def _bitwise_equal(a, b) -> bool:
    if torch.is_tensor(a) and torch.is_tensor(b):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


class CoEmulator:
    """verify(): DUT-vs-oracle commit comparison. determinism(): DUT-vs-DUT
    bitwise reproducibility (run-to-run, the emulation-debug contract).

    A step is ``step(state, batch) -> (state, metrics, aux)`` with
    ``metrics["loss"]`` and the commit taps in ``aux``; it may update
    ``state`` in place."""

    def __init__(self, dut_step: Callable, oracle_step: Callable,
                 rtol: float = 5e-2):
        self.dut_step = dut_step
        self.oracle_step = oracle_step
        self.rtol = rtol
        # keyed on the step function OBJECT (kept alive by the key), never
        # id(): id keys are only sound while every cached fn happens to
        # stay alive; object keys make no-aliasing unconditional
        self._group_fns: Dict[Any, Callable] = {}
        self._work: Dict[str, Any] = {}       # side -> its working state
        self._engines: Dict[str, Callable] = {}   # side -> window engine
        self._pool = GraphPool()    # the sides' one CUDA-graph pool

    def verify(self, state_dut, state_orc, batches, group_size: int = 1,
               overlap: bool = True) -> CoEmuReport:
        """Cross-verify commit streams. ``group_size=1`` is the step-locked
        Dromajo loop; ``group_size=N`` dispatches each side once per
        N-step window and recovers per-step checksums from the window's ys
        — same localization, 2 dispatches per window instead of 2N.
        ``overlap=False`` forces the serial baseline: each window's
        checksums are fetched before the next window dispatches, and in
        grouped mode the DUT window is additionally synced to completion
        before the oracle window dispatches. Step-locked mode always
        dispatches DUT and oracle back-to-back within a step.

        The caller's states are left as they were: each side steps its own
        working copy."""
        grouped = group_size > 1
        states = (self._working("dut", state_dut),
                  self._working("orc", state_orc))
        engine = (self._grouped_engine(serial=not overlap) if grouped
                  else self._step_engine())
        sched = WindowScheduler(
            interval=max(1, group_size), overlap=overlap, drain_fn=None,
            stack_fn=stack_batches if grouped else None)
        acc = _CompareAccumulator(self.rtol)
        sched.run(engine, sched.windows(batches), states, {},
                  on_drain=lambda plan, records, ys: acc.ingest(plan.start,
                                                                ys))
        return acc.report()

    def _working(self, side: str, state):
        """``side``'s working copy of ``state``. An earlier copy of the same
        layout is refilled in place (the side's captured graphs hold it as
        their static state); any other state is cloned, and the side's
        graphs, which hold the old copy, are dropped."""
        work = self._work.get(side)
        if work is not None and _same_layout(work, state):
            tree_map(lambda dst, src: dst.copy_(src), work, state)
            return work
        self._engines.pop(side, None)
        self._work.pop(side, None)          # free it before the clone
        self._work[side] = tree_clone(state)
        return self._work[side]

    # ------------------------------------------------------------ engines --
    def _step_engine(self):
        """Step-locked two-sided engine: per-step dispatches exactly as the
        Dromajo loop, checksums left on the device for the scheduler's
        drain."""
        def engine(states, shell, batches):
            state_dut, state_orc = states
            cks_d, cks_o, loss_d, loss_o = [], [], [], []
            for batch in batches:
                state_dut, m_dut, aux_dut = self.dut_step(state_dut, batch)
                state_orc, m_orc, aux_orc = self.oracle_step(state_orc, batch)
                cks_d.append(layer_checksums(aux_dut))
                cks_o.append(layer_checksums(aux_orc))
                loss_d.append(m_dut["loss"])
                loss_o.append(m_orc["loss"])
            ys = ((torch.stack(cks_d), torch.stack(loss_d)),
                  (torch.stack(cks_o), torch.stack(loss_o)))
            return (state_dut, state_orc), shell, ys

        return engine

    def _grouped_engine(self, serial: bool = False):
        """Group-locked two-sided engine: DUT and oracle windows dispatch
        back-to-back; nothing is fetched here. ``serial=True`` is the
        no-dispatch-overlap baseline: the DUT window is synced to
        completion before the oracle window dispatches."""
        dut = self._side_engine("dut", self.dut_step)
        orc = self._side_engine("orc", self.oracle_step)

        def engine(states, shell, stack):
            state_dut, state_orc = states
            state_dut, _, ys_d = dut(state_dut, {}, stack)
            if serial and ys_d[0].is_cuda:
                torch.cuda.current_stream(ys_d[0].device).synchronize()
            state_orc, _, ys_o = orc(state_orc, {}, stack)
            return (state_dut, state_orc), shell, (ys_d, ys_o)

        return engine

    def _side_engine(self, side: str, step: Callable):
        """``side``'s window engine: the cached group of ``step``, on the
        card run as a ``WindowGraphs`` of the side's own (its first window
        of each length eagerly, then one replay a window on the side's
        working copy). The two sides' graphs share one memory pool: they
        are captured DUT first, then oracle, in one window, and replayed
        in that order, each window's ys copied out before the next."""
        if side not in self._engines:
            engine = self._cached_group(step)
            if _device(self._work[side]).type == "cuda":
                engine = WindowGraphs(engine, warmup="eager",
                                      pool=self._pool)
            self._engines[side] = engine
        return self._engines[side]

    def _group_fn(self, step: Callable):
        """One dispatch per window, as an engine ``(state, shell, stack)
        -> (state, shell, ys)``: ``step`` over the window's batch stack,
        ys = (per-step checksums (g, L, 2) f32, per-step loss (g,) f32).
        The window's body is exactly one ``step`` per batch, so per-step
        checksums equal the step-locked loop's bit for bit."""
        def group(state, shell, stack):
            g = int(next(iter(stack.values())).shape[0])
            cks, loss = [], []
            for i in range(g):
                state, metrics, aux = step(
                    state, {k: v[i] for k, v in stack.items()})
                cks.append(layer_checksums(aux).float())
                loss.append(metrics["loss"].float())
            return state, shell, (torch.stack(cks), torch.stack(loss))

        return group

    def _cached_group(self, step: Callable):
        if step not in self._group_fns:
            self._group_fns[step] = self._group_fn(step)
        return self._group_fns[step]

    @staticmethod
    def determinism(step: Callable, state, batch) -> bool:
        """Two identical dispatches must be BITWISE identical (the
        deterministic clock-gated emulation contract). Each steps its own
        clone of ``state``, which stays as it was."""
        out1 = step(tree_clone(state), batch)
        out2 = step(tree_clone(state), batch)
        leaves1, leaves2 = tree_leaves(out1), tree_leaves(out2)
        return len(leaves1) == len(leaves2) and all(
            _bitwise_equal(a, b) for a, b in zip(leaves1, leaves2))


# --------------------------------------------------- checkpoint verifier ---
class CommitDivergence(RuntimeError):
    """Raised by CommitStreamVerifier at the drain whose commit rows
    diverge from the oracle — inside the scheduler's ``on_drain``, this
    vetoes any DrainBarrier commit (checkpoint save) behind the window."""

    def __init__(self, step: int, layer: int, rel_err: float,
                 lane: Optional[int] = None):
        at_lane = "" if lane is None else f" lane {lane}"
        super().__init__(
            f"commit stream diverged at step {step} layer {layer}"
            f"{at_lane} (rel-err {rel_err:.2e}); checkpoint vetoed")
        self.step = step
        self.layer = layer
        self.rel_err = rel_err
        self.lane = lane


class CommitStreamVerifier:
    """The paper's verified-snapshot workflow, wired into the train loop:
    a checkpoint may only publish if the host has ACCEPTED every commit up
    to the boundary.

    Called as the train loop's drain verifier with ``(last_step,
    records)``: replays its OWN copy of the deterministic batch stream
    through ``oracle_step`` (eager, step-locked) and compares the drained
    commit FIFO rows — per-step ``[layer, mean, abs_mean]`` checksums
    pushed by the P-Shell ingest — against the oracle's
    ``layer_checksums``. A divergence raises :class:`CommitDivergence`,
    which the ``WindowScheduler`` barrier semantics turn into a checkpoint
    veto (the barrier action never runs). Requires a losslessly sized
    commit FIFO (the ``default_shell_config`` contract).

    The oracle steps ``state`` itself, in place where its step updates in
    place: pass a copy to keep the original.

    Mid-stream resume: :meth:`snapshot` captures the oracle's position —
    host-copied state, global step, and the number of batches consumed —
    and :meth:`restore` rewinds to it. Rewinding re-reads the batch
    stream, so resume requires ``batches`` to be a sequence or a zero-arg
    factory (a one-shot iterator can be consumed but never rewound).

    Digest first pass (ZP-Scope): ``expected_digests`` maps a window index
    to the oracle's digest of that window's outputs
    (:func:`repro_torch.core.scope.digest_tree`, the exact host twin of
    the plane's device fold). When the caller passes the drained window's
    ``digest`` and ``window`` and the digest MATCHES, the per-step,
    per-layer row compare is skipped; the oracle still steps, so its state
    stays step-locked. A mismatch falls through to the full compare, which
    localises the divergence and raises. ``digest_hits`` counts the
    windows verified by digest alone.
    """

    def __init__(self, oracle_step: Callable, state, batches,
                 layers: int, rtol: float = 1e-5, start_step: int = 0,
                 lane: Optional[int] = None,
                 expected_digests: Optional[dict] = None):
        self.oracle_step = oracle_step
        self.state = state
        self._batches_src = batches
        self.batches = self._iter_batches()
        self.L = layers
        self.rtol = rtol
        self.step = start_step      # resume: report true global step ids
        self._consumed = 0          # batches taken from the stream so far
        self.lane = lane            # lane-batched boards: divergences name
        # the lane, so a fused farm run localizes the veto to ONE board
        self.expected_digests = expected_digests or {}
        self.digest_hits = 0        # windows verified by digest alone

    def _iter_batches(self):
        b = self._batches_src
        return iter(b() if callable(b) else b)

    def _next_batch(self):
        batch = next(self.batches)
        self._consumed += 1
        return batch

    def __call__(self, last_step: int, records, digest: Optional[int] = None,
                 window: Optional[int] = None):
        rows = np.asarray(records["fifos"]["commits"]["data"], np.float64)
        steps = rows.shape[0] // self.L
        # digest first pass: the device fold matched the oracle's digest
        # for this window, so the host row compare is skipped; the oracle
        # still steps to stay step-locked
        skip_rows = (digest is not None and window is not None
                     and window in self.expected_digests
                     and int(digest) == int(self.expected_digests[window]))
        for s in range(steps):
            batch = self._next_batch()
            self.state, _, aux = self.oracle_step(self.state, batch)
            if skip_rows:
                continue
            exp = _f64(layer_checksums(aux))                     # (L, 2)
            got = rows[s * self.L:(s + 1) * self.L, 1:]
            err = _rel_err(got, exp).max(axis=1)                 # (L,)
            bad = np.nonzero(err > self.rtol)[0]
            if bad.size:
                l = int(bad[0])
                raise CommitDivergence(step=self.step + s, layer=l,
                                       rel_err=float(err[l]),
                                       lane=self.lane)
        if skip_rows:
            self.digest_hits += 1
        self.step += steps

    # ------------------------------------------------------------- resume --
    def snapshot(self):
        """Host-copied resume point (oracle state + stream position)."""
        return {"state": tree_map(
                    lambda t: t.detach().to("cpu", copy=True)
                    if torch.is_tensor(t) else t, self.state),
                "step": np.int64(self.step),
                "consumed": np.int64(self._consumed)}

    def restore(self, snap):
        """Rewind to a :meth:`snapshot`: subsequent drains re-verify from
        that barrier's oracle state (copied back onto the oracle's device,
        so a later restore finds the snapshot unchanged) against a
        re-seeked batch stream."""
        src = self._batches_src
        if not callable(src) and iter(src) is src:
            raise ValueError(
                "CommitStreamVerifier resume needs a re-iterable batch "
                "source (sequence or zero-arg factory); a one-shot "
                "iterator cannot be rewound to the snapshot position")
        device = _device(self.state)
        self.state = tree_map(
            lambda t: t.to(device, copy=True) if torch.is_tensor(t) else t,
            snap["state"])
        self.step = int(snap["step"])
        self._consumed = int(snap["consumed"])
        self.batches = itertools.islice(self._iter_batches(),
                                        self._consumed, None)


# ------------------------------------------------------------- multi-DUT ---
def _activation_checksum(x):
    """(abs-mean, rms) in f32 — both O(activation-scale) positive
    statistics, so the relative comparison is stable (a raw mean sits
    near zero for normalized activations and would amplify low-bit
    jitter)."""
    x = x.float()
    return torch.stack([x.abs().mean(), x.square().mean().sqrt()])


def _stack_on_device(items):
    """A window's per-step activations stacked into one (g, ...) tensor on
    their own device (no host round trip for resident captures)."""
    return torch.stack(list(items))


def subsystem_boards(params, cfg, rt, xs: Sequence, positions,
                     layer_idxs: Sequence[int], dut_params=None):
    """Build the multi-DUT farm boards: for each activation batch in ``xs``
    (the "steps"), an in-situ unrolled run over ``params`` captures every
    block's boundary traffic (the oracle); each layer in ``layer_idxs``
    becomes one DUT board — its extracted subsystem (from ``dut_params``,
    defaulting to the oracle's params) replayed standalone over its
    captured inputs, one window of steps per dispatch.

    Returns one ``(engine, state, x_ins, oracle_cks, lane_key)`` tuple per
    layer. Boards sharing a block spec share ONE engine whose block params
    ride as the board's STATE (not a per-engine closure): same-spec boards
    are lane-batchable under ``lane_key`` (``subsys:<mixer>+<ffn>``), the
    farm's identity-aware lane packing broadcasts any params shared
    across boards instead of replicating them per board, and extraction
    is a single ``extract_blocks`` walk instead of one full-stack re-walk
    per board. The engine never writes its state. An enc-dec config
    raises ValueError."""
    from repro_torch.core.decompose import extract_blocks, unrolled_capture
    from repro_torch.models import transformer as tfm

    captures = [unrolled_capture(params, cfg, x, positions, rt)[1]
                for x in xs]                       # [step][layer] records
    batch, seq = xs[0].shape[0], xs[0].shape[1]
    subs = extract_blocks(dut_params if dut_params is not None else params,
                          cfg, layer_idxs, rt, batch, seq)

    engines = {}                    # spec -> ONE engine for all its boards

    def shared_engine(spec):
        if spec not in engines:
            def engine(state, shell, stack):
                pos = positions.to(stack.device)
                cks = []
                for i in range(stack.shape[0]):
                    y, _ = tfm.block_apply(state, cfg, spec, stack[i], pos,
                                           rt)
                    cks.append(_activation_checksum(y))
                return state, shell, torch.stack(cks)

            engines[spec] = engine
        return engines[spec]

    boards = []
    for li in layer_idxs:
        sub = subs[li]
        x_ins = [captures[s][li]["x_in"] for s in range(len(xs))]
        oracle_cks = np.stack([
            _f64(_activation_checksum(captures[s][li]["x_out"]))
            for s in range(len(xs))])              # (steps, 2)
        boards.append((shared_engine(sub.spec), sub.params, x_ins,
                       oracle_cks, f"subsys:{sub.spec[0]}+{sub.spec[1]}"))
    return boards


def submit_subsystem_jobs(farm, params, cfg, rt, xs: Sequence, positions,
                          layer_idxs: Sequence[int], group_size: int = 2,
                          rtol: float = 5e-2, dut_params=None,
                          lanes: bool = False):
    """Submit one verification FarmJob per extracted subsystem to ``farm``
    (a ``repro_torch.farm.FarmManager``) and return a zero-arg
    ``finalize`` producing the per-subsystem ``CoEmuReport``\\ s once the
    farm ran.

    Checksum ingestion rides the job's exactly-once ``on_drain`` sink, so
    an evicted + requeued board's replayed windows are never
    double-counted. A divergence localizes a fault to the exact (step,
    subsystem) — it is RECORDED in the report, not raised, so a diverging
    board never takes down the farm pass.

    ``lanes=True`` tags each job with its block-spec ``lane_key`` so a
    lane-capable farm coalesces same-spec subsystem boards into one
    vmapped dispatch stream (they already share one engine, and the lane
    packer broadcasts any param leaves shared across boards)."""
    from repro_torch.farm.manager import FarmJob

    boards = subsystem_boards(params, cfg, rt, xs, positions, layer_idxs,
                              dut_params=dut_params)
    accs = []
    for li, (engine, state, x_ins, oracle_cks, lane_key) in zip(layer_idxs,
                                                                boards):
        acc = _CompareAccumulator(rtol)
        accs.append(acc)

        def sink(plan, records, ys, acc=acc, oracle_cks=oracle_cks):
            cks_d = _f64(ys)[:, None, :]                      # (g, 1, 2)
            cks_o = oracle_cks[plan.start:plan.start
                               + plan.size][:, None, :]
            acc._compare(cks_d, cks_o, plan.start)
            acc.steps += cks_d.shape[0]

        farm.submit(FarmJob(
            name=f"layer{li}", engine=engine, state=state,
            windows=list(iter_windows(x_ins, group_size)), shell={},
            stack_fn=_stack_on_device, on_drain=sink,
            lane_key=lane_key if lanes else None))

    def finalize() -> Dict[str, CoEmuReport]:
        out = {}
        for k, li in enumerate(layer_idxs):
            rep = accs[k].report()
            if rep.first is not None:
                # the board sees a single "layer" (itself); report true id
                rep.first = Divergence(step=rep.first.step, layer=li,
                                       rel_err=rep.first.rel_err)
            out[f"layer{li}"] = rep
        return out

    return finalize


def verify_subsystems(params, cfg, rt, xs: Sequence, positions,
                      layer_idxs: Sequence[int], group_size: int = 2,
                      rtol: float = 5e-2, dut_params=None,
                      farm=None, lanes: bool = False,
                      device=None) -> Dict[str, CoEmuReport]:
    """Multi-DUT (ZP-Farm) mode: verify several extracted subsystems as
    independent boards of one farm pass (see ``submit_subsystem_jobs``).
    ``farm=None`` builds a dedicated ``FarmManager`` with one slot per
    subsystem on ``device`` (the card by default, which must exist;
    ``"cpu"``: the host) — every board dispatches before any board's
    previous window is fetched, exactly the paper's board-farm shape.
    The whole pass runs under ``torch.inference_mode()``.

    Note on tolerance: a window's replay may differ from the in-situ
    capture in low mantissa bits (a lane-batched product rounds as a
    batched product), so comparison is at ``rtol`` — the BITWISE
    non-interference contract is the eager ``decompose.verify_extraction``
    path.

    Blind spot of the default ``rtol`` (5e-2, the reference's): a
    block's output is its input plus the residual update, so the
    checksums move much less than the fault. At glm4-9b's full width on
    an H100, ``inject_fault``'s 100x fault in layer 39 moved its
    checksums by 8.33e-3 and passed unseen. There a solo board's
    checksums equal the capture's (max_rel_err 0.0) and lane-batched
    boards lie within 2.05e-7 of them, so ``rtol=1e-3`` names that fault
    (``chip_smoke.py`` phase 50). Pass the tightest tolerance that the
    DUT's own rounding allows."""
    from repro_torch.farm.manager import FarmManager

    # the internal farm disables straggler eviction: a library
    # verification call must be timing-independent (heterogeneous blocks
    # legitimately differ in window cost); callers who want eviction pass
    # their own farm
    mgr = farm if farm is not None else FarmManager(
        slots=len(layer_idxs), evict_stragglers=False,
        lanes=len(layer_idxs) if lanes else 1, device=device)
    with torch.inference_mode():
        finalize = submit_subsystem_jobs(
            mgr, params, cfg, rt, xs, positions, layer_idxs,
            group_size=group_size, rtol=rtol, dut_params=dut_params,
            lanes=lanes)
        mgr.run()
    return finalize()


def inject_fault(params, cfg, layer: int, scale: float = 100.0):
    """Perturb one weight tensor of block ``layer`` (mutation testing: the
    co-emulator must localize the divergence to this layer): the first
    leaf with ndim >= 3 of the block's pattern position, in the JAX
    package's flatten order (sorted keys), multiplied by ``scale`` at the
    layer's period. Returns new params that share no tensor with
    ``params``, which is left as it was (the port's steps update their
    state in place, so a shared leaf would carry one run's updates into
    the other). An enc-dec config raises ValueError."""
    if cfg.family == "encdec":
        raise ValueError(
            f"inject_fault perturbs a block of the decoder-only layer "
            f"stack; {cfg.name!r} is of the encdec family (no "
            f"params['stack']), where the reference fails with a KeyError")
    P_len = len(cfg.layer_pattern)
    period, pos = divmod(layer, P_len)
    params = tree_clone(params)
    blocks = list(params["stack"]["blocks"])
    blk = blocks[pos]
    leaves = [leaf for _, leaf in tree_paths_sorted(blk)]
    for leaf in leaves:
        if leaf.dim() >= 3:
            if period >= leaf.shape[0]:
                raise ValueError(
                    f"inject_fault: layer {layer} is not in the stacked "
                    f"periods ({leaf.shape[0]} of {P_len} layers); the "
                    "unstacked tail holds no (n_periods, ...) leaf")
            leaf[period].mul_(scale)
            break
    else:
        raise ValueError(
            f"inject_fault: block position {pos} (layer {layer}) has no "
            f"stacked weight leaf with ndim >= 3 to perturb; leaf shapes"
            f" = {[tuple(l.shape) for l in leaves]}")
    return params
