"""The integrated train loop: the ZP-Farm host loop.

Wires together every substrate: data pipeline (prefetch), P-Shell
instrumentation (drain at the gating granularity -> coverage + commit
verification hooks), profiler phases (device/host/data attribution),
watchdog heartbeats, async checkpointing, and restart-from-latest.

Both execution engines run through the core ``WindowScheduler`` — engine
selection is the ONLY difference, the window/drain/barrier machinery is
shared (tests hold the two bitwise):

  fused (default) — the whole clock-gated window (``sample_interval``
      steps) is ONE dispatch (``PShell.compile_group`` of
      ``make_group_step``; on the card one CUDA-graph replay after the
      first window of each length ran eagerly). Losses cross to the host
      once per window; the scheduler overlaps the drain of window *i* with
      window *i+1* on the card.

  per-step — one dispatch per batch inside the window (``overlap=False``,
      serial drains), kept as the equivalence baseline. Loss tensors stay
      on the device until the window's drain.

Profiler, watchdog, coverage, and checkpointing hook in via scheduler
callbacks: the profiler IS the scheduler's phase timer, the watchdog
heartbeats from ``on_dispatch``, coverage folds drained CSRs in
``on_drain``, and checkpoints are ``DrainBarrier`` actions — a checkpoint
at a boundary may only hit disk after every window up to it was drained
and ACCEPTED by the host (an on_drain verifier that raises vetoes it).

Profiler attribution: "device" is the dispatch (the enqueue), and the
wait for a window's results lands in "host" at its drain.

``LoopConfig.scope`` (a ``ScopeSpec`` or ``ScopePlane``) runs both engines
with the ZP-Scope plane (``core/scope.py``): device counters drained at
its read rate, the DUT stream bit-identical with the plane on or off; the
last sample's gate bits fold into the coverage map and the plane's report
comes back under "scope".

Not ported yet: the measured-window roofline (``WindowCapture``, the
reference's ``out["roofline"]``), which waits for ``roofline/``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (CoverageMap, DrainBarrier, PShell, Watchdog,
                              default_shell_config, make_ingest,
                              plan_windows)
from repro_torch.core.profiler import Profiler
from repro_torch.core.scope import as_plane
from repro_torch.data import SyntheticPipeline
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import init_state, make_group_step, \
    make_train_step
from repro_torch.utils import resolve_device, tree_clone, tree_leaves


@dataclasses.dataclass
class LoopConfig:
    steps: int = 20
    batch: int = 4
    seq: int = 32
    seed: int = 0
    sample_interval: int = 1
    checkpoint_every: int = 10
    checkpoint_dir: Optional[str] = None
    watchdog_timeout_s: float = 600.0
    grad_compress: bool = False
    accum_steps: int = 1
    fused: bool = True          # fused step groups vs per-step dispatch
    scope: Any = None           # ScopeSpec: ZP-Scope instrumentation
    # plane (device counters drained at the read rate; bit-identical DUT
    # stream with the plane on or off)


def train_loop(model, loop_cfg: LoopConfig,
               opt_cfg: OptConfig = OptConfig(),
               on_drain: Optional[Callable[[int, dict], None]] = None,
               resume: bool = True,
               oracle_step: Optional[Callable] = None,
               oracle_state: Any = None,
               oracle_rtol: float = 1e-5, *, device=None) -> Dict[str, Any]:
    """Train ``model`` from ``init_state(loop_cfg.seed)`` on ``device``
    (``cuda`` unless named), or from the latest checkpoint in
    ``loop_cfg.checkpoint_dir`` with ``resume``.

    ``oracle_step`` arms the verified-snapshot workflow: a
    ``CommitStreamVerifier`` replays the same deterministic batch stream
    through the oracle and checks the drained commit FIFO rows at every
    window — a diverging commit stream raises at the drain, vetoing the
    checkpoint ``DrainBarrier`` before the save can publish.
    ``oracle_state`` defaults to the DUT's own starting state — the fresh
    seed init, or the restored checkpoint on resume; pass a different
    state to model a faulted engine. The oracle steps a copy of it: the
    train step updates its state in place, so neither engine writes into
    the other's state or into the caller's.

    Returns ``{"state", "losses", "coverage", "profile", "stragglers",
    "final_step"}``, plus ``"scope"`` (the plane's report) where
    ``loop_cfg.scope`` is set; the reference's ``"roofline"`` waits for
    its slice."""
    device = resolve_device(device)
    cfg = model.cfg

    state = init_state(model, loop_cfg.seed, opt_cfg,
                       grad_compress=loop_cfg.grad_compress, device=device)
    start_step = 0
    ckpt = None
    if loop_cfg.checkpoint_dir:
        ckpt = CheckpointManager(loop_cfg.checkpoint_dir)
        if resume and ckpt.steps():
            state, start_step = ckpt.restore(state)

    shell_cfg = default_shell_config(
        cfg, sample_interval=loop_cfg.sample_interval)
    ingest = make_ingest(cfg)
    shell = PShell(shell_cfg, ingest)
    sh = shell.init(device)

    prof = Profiler(sample_interval=loop_cfg.sample_interval)
    wd = Watchdog(timeout_s=loop_cfg.watchdog_timeout_s)
    cov = CoverageMap()
    scope_plane = None
    if loop_cfg.scope is not None:
        scope_plane = as_plane(loop_cfg.scope)
    pipe = SyntheticPipeline(cfg, loop_cfg.batch, loop_cfg.seq,
                             seed=loop_cfg.seed, start_step=start_step)
    losses: list = []

    verifier = None
    orc_pipe = None
    if oracle_step is not None:
        from repro_torch.core.coemu import CommitStreamVerifier
        orc_pipe = SyntheticPipeline(cfg, loop_cfg.batch, loop_cfg.seq,
                                     seed=loop_cfg.seed,
                                     start_step=start_step)
        verifier = CommitStreamVerifier(
            oracle_step,
            tree_clone(state if oracle_state is None else oracle_state),
            orc_pipe, layers=cfg.num_layers + cfg.encoder_layers,
            rtol=oracle_rtol, start_step=start_step)

    try:
        runner = _run_fused if loop_cfg.fused else _run_per_step
        state = runner(model, loop_cfg, opt_cfg, state, shell, sh, ingest,
                       pipe, prof, wd, cov, ckpt, losses, start_step,
                       on_drain, verifier, scope_plane)
    finally:
        pipe.close()
        if orc_pipe is not None:
            orc_pipe.close()
        if ckpt:
            ckpt.wait()

    if scope_plane is not None and scope_plane.samples:
        # fold the plane's device gate bits into the coverage map: the
        # same OR-accumulated CSR semantics, one more bitmap
        last = scope_plane.samples[-1]
        if last.get("gates") is not None:
            cov.update_gates(last["gates"])
    out = {
        "state": state,
        "losses": losses,
        "coverage": cov.summary(),
        "profile": prof.live_stack().seconds,
        "stragglers": wd.stragglers(),
        "final_step": loop_cfg.steps,
    }
    if scope_plane is not None:
        out["scope"] = scope_plane.report()
    return out


def _pipe_windows(pipe, loop_cfg, start_step):
    """Window source: pull each planned window's batches from the pipeline
    (consumed inside the scheduler's "data" phase)."""
    for plan in plan_windows(loop_cfg.steps, loop_cfg.sample_interval,
                             start=start_step):
        yield [next(pipe) for _ in range(plan.size)]


def _barriers(ckpt, loop_cfg):
    if not ckpt:
        return ()
    return (DrainBarrier(every=loop_cfg.checkpoint_every,
                         action=lambda state, step: ckpt.save(state, step)),)


def _step_counter(prof):
    """on_window hook: one profiler step per step of the drained window."""
    def step_done(plan, state):
        for _ in range(plan.size):
            prof.step_done()
    return step_done


def _run_fused(model, loop_cfg, opt_cfg, state, shell, sh, ingest, pipe,
               prof, wd, cov, ckpt, losses, start_step, on_drain,
               verifier=None, scope_plane=None):
    """Group-granular engine: one dispatch per clock-gated window (on the
    card one CUDA-graph replay), host drain of window i overlapped with
    window i+1 on the card."""
    group_fn = shell.compile_group(
        make_group_step(model, opt_cfg, ingest=ingest,
                        grad_compress=loop_cfg.grad_compress,
                        accum_steps=loop_cfg.accum_steps),
        device=tree_leaves(state)[0].device)
    sched = shell.scheduler(overlap=True, timer=prof)

    def emit(plan, records, metrics):
        if verifier is not None:        # raising here vetoes the barrier
            verifier(plan.last, records)
        losses.extend(metrics["loss"].float().numpy().tolist())
        cov.update(records["csrs"])
        if on_drain:
            on_drain(plan.last, records)

    state, _, _ = sched.run(
        group_fn, _pipe_windows(pipe, loop_cfg, start_step), state, sh,
        start_step=start_step, on_drain=emit,
        on_dispatch=lambda plan, state: wd.heartbeat(),
        on_window=_step_counter(prof), barriers=_barriers(ckpt, loop_cfg),
        scope=scope_plane)
    return state


def _run_per_step(model, loop_cfg, opt_cfg, state, shell, sh, ingest, pipe,
                  prof, wd, cov, ckpt, losses, start_step, on_drain,
                  verifier=None, scope_plane=None):
    """Per-step dispatch baseline (``overlap=False``: serial in-place
    drains at window boundaries). Loss tensors are fetched at the drain
    boundaries only."""
    wrapped = shell.wrap(make_train_step(
        model, opt_cfg, with_aux=True,
        grad_compress=loop_cfg.grad_compress,
        accum_steps=loop_cfg.accum_steps))
    sched = shell.scheduler(overlap=False, timer=prof, stacked=False)

    def engine(state, sh, batches):
        window_losses = []          # device tensors, fetched at the drain
        for batch in batches:
            state, metrics, sh = wrapped(state, batch, sh)
            window_losses.append(metrics["loss"])
            wd.heartbeat()
        return state, sh, window_losses

    def emit(plan, records, window_losses):
        if verifier is not None:        # raising here vetoes the barrier
            verifier(plan.last, records)
        losses.extend(float(x) for x in window_losses)
        cov.update(records["csrs"])
        if on_drain:
            on_drain(plan.last, records)

    state, _, _ = sched.run(
        engine, _pipe_windows(pipe, loop_cfg, start_step), state, sh,
        start_step=start_step, on_drain=emit,
        on_window=_step_counter(prof), barriers=_barriers(ckpt, loop_cfg),
        scope=scope_plane)
    return state
