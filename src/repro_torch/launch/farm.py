"""ZP-Farm CLI of the port: a mixed co-emulation workload through one
FarmManager.

The paper's end state — a farm of scaled-down DUTs behind one host — as an
executable: a TRAIN engine (fused clock-gated windows, P-Shell commit
stream), a DECODE engine (graphed autoregressive windows, telemetry FIFO),
and N VERIFY boards (extracted subsystems replaying captured boundary
traffic) all share one farm pass: device placement (round-robin virtual
slots on one card), dynamic admission, per-slot watchdogs, straggler
eviction + requeue, and one aggregated telemetry report. ``--device``
defaults to the card, which must exist; ``--device cpu`` runs on the host.

Host-loop mode: ``--async`` (default) drives each slot from its own
dispatcher thread on its own CUDA stream — a slow board delays only
itself; ``--lockstep`` is the single-thread round-robin oracle the async
mode is held bitwise against.

  PYTHONPATH=src python -m repro_torch.launch.farm --steps 8
  PYTHONPATH=src python -m repro_torch.launch.farm --steps 8 \\
      --synthetic-straggler
  PYTHONPATH=src python -m repro_torch.launch.farm --steps 8 --lockstep \\
      --synthetic-straggler --device cpu

``--synthetic-straggler`` slows one board down. In lockstep mode the last
verify board is force-marked for eviction (dispatch-cost observations
there come from too few windows to flag it); in async mode NOTHING is
marked: a long board gone slow must be caught by the watchdog from its
measured per-window WALL time alone. The run exits non-zero unless every
job completes verified — and, when a straggler was injected, unless it was
actually evicted (in async mode: as a ``straggler``), requeued, and still
delivered correct outputs.

The gates, each exiting non-zero unless it holds:

  --restart-smoke     a long board with a checkpoint barrier at every
                      window is evicted mid-stream and must RESUME from
                      its last accepted snapshot (replayed < committed),
                      bit-identically;
  --chaos SEED        a toy workload run fault-free (the oracle), then
                      under a seeded ZP-Chaos schedule (board crashes,
                      hung drains, commit divergence, snapshot corruption
                      and truncation, thread death, results stalls) plus
                      one poisoned board: every fault fired and recovered,
                      every other board bit-identical to the oracle, the
                      poisoned board quarantined;
  --lanes N           N identical-arch boards over one weight tensor
                      coalesce into ONE vmap-fused dispatch stream,
                      bit-identical to the same boards run solo;
                      ``--chaos-lane`` fails one lane's verify mid-stream
                      and exactly that lane must requeue solo;
  --scope-smoke       the same boards scope-off and scope-on, bitwise, with
                      a non-empty fleet scope report (``--lanes N``: the
                      lane-coalesced variant);
  --killrestart-smoke whole-process crash recovery (ZP-Ledger): a toy
                      durable campaign run fault-free in-process (the
                      oracle), then in a victim subprocess SIGKILLed at a
                      journaled commit (chaos ``process_kill``), then in a
                      ``--recover`` subprocess over the victim's journal:
                      at least one board resumed mid-stream, fewer windows
                      replayed than committed, every window delivered
                      exactly once across both lifetimes, and the
                      per-window output files bit-identical to the
                      oracle's.

``--ledger DIR`` runs the durable toy workload (``--ledger-boards`` boards
of ``--ledger-windows`` windows, journal, snapshots and per-window
outputs all under DIR) as one process lifetime: ``--recover`` rebuilds
the farm from DIR's journal and finishes the campaign,
``--kill-after-commits N`` SIGKILLs the process at the N-th journaled
commit.

``--scope N`` runs the mixed workload with the ZP-Scope plane read every N
drains; ``--telemetry-out PATH`` merges the run's telemetry and scope
report into a JSON file by run key.

SIGINT (^C) and SIGTERM during a farm run are a GRACEFUL stop: every
board is cut at its next drain boundary, committed prefixes and
published snapshots are kept, the partial report + telemetry summary are
printed, and the process exits ``128 + signum`` (130 for SIGINT, 143 for
SIGTERM). A second signal kills immediately.

What waits for a later slice exits non-zero with a message naming it:
``--certify`` and ``--certify-smoke`` (ZP-Cert), ``--roofline`` (the
measured-window roofline).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core import DrainBarrier, plan_windows
from repro_torch.core.coemu import submit_subsystem_jobs
from repro_torch.core.commit import default_shell_config, make_ingest
from repro_torch.core.graphs import WindowGraphs, counted_kernels
from repro_torch.core.pshell import PShell, drain, shell_init, stack_batches
from repro_torch.core.scope import ScopeSpec
from repro_torch.core.watchdog import Watchdog
from repro_torch.data.pipeline import SyntheticPipeline, make_batch_fn
from repro_torch.farm import (FailurePolicy, FarmJob, FarmLedger,
                              FarmManager, JobSpec, register)
from repro_torch.farm.chaos import ChaosHarness, ChaosInjector, Injection
from repro_torch.launch.serve import (_FRONTEND_INPUTS, decode_shell_config,
                                      make_decode_engine)
from repro_torch.models import Runtime, build_model
from repro_torch.serve import make_prefill_step
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import init_state, make_group_step
from repro_torch.utils import dtype_of, resolve_device, tree_leaves

# the CLI flags of the reference that wait for a later slice of the port
CERT_SLICE = ("waits for ZP-Cert, the static board certifier of the "
              "port's analysis/ (the ZP-Cert slice)")
ROOFLINE_SLICE = ("waits for the measured-window roofline slice of the "
                  "port (roofline/, WindowCapture)")


class _SignalDrain:
    """Graceful-stop signal plumbing for a farm run. First SIGINT *or*
    SIGTERM: the farm drains at the next barrier, keeps its committed
    prefixes and published snapshots, ``run()`` returns the partial
    report, and the process should exit ``exit_code`` (``128 + signum``:
    130 for ^C, 143 for SIGTERM). A second SIGINT raises
    KeyboardInterrupt; a second SIGTERM restores the default disposition
    and re-delivers it — an immediate hard kill either way."""

    def __init__(self, mgr):
        self.mgr = mgr
        self.exit_code = 130
        self._hits = 0
        self._prev = {}

    def install(self) -> "_SignalDrain":
        for s in (signal.SIGINT, signal.SIGTERM):
            self._prev[s] = signal.signal(s, self._handle)
        return self

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}

    def _handle(self, signum, frame):
        self._hits += 1
        if self._hits == 1:
            self.exit_code = 128 + int(signum)
            print(f"{signal.Signals(signum).name}: draining farm at the "
                  f"next barrier (signal again to kill)", file=sys.stderr)
            self.mgr.request_shutdown()
        elif signum == signal.SIGTERM:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
        else:
            signal.signal(signal.SIGINT,
                          self._prev.get(signal.SIGINT, signal.SIG_DFL))
            raise KeyboardInterrupt


def _train_board_parts(cfg, steps, interval, batch=2, seq=16, seed=0,
                       device=None, lr=None):
    """Fused train engine's job parts: P-Shell drain + stack_batches per
    window, on the plain "xla" path (the reference trains on
    ``impl="xla"``; the kernels have no backward). Shared by the CLI
    submit path and the ``zp.train_board`` registered factory —
    everything here is rebuilt from plain kwargs. The engine updates its
    state in place, and the state is a zero-arg factory: the farm draws
    it from ``seed`` at each admission (and ``prewarm`` for its warm-up
    window), so a requeue replays from the same initial state without a
    second train state kept beside the running one (the reference keeps
    the initial state and compiles the engine non-donating)."""
    device = resolve_device(device)
    model = build_model(cfg, Runtime(attention_impl="xla",
                                     taps=frozenset({"commits"})))
    ingest = make_ingest(cfg)
    shell = PShell(default_shell_config(cfg, sample_interval=interval),
                   ingest)
    opt = OptConfig() if lr is None else OptConfig(lr=lr, warmup_steps=10)
    engine = shell.compile_group(make_group_step(model, opt, ingest=ingest),
                                 device=device)
    pipe = SyntheticPipeline(cfg, batch, seq, seed=seed)
    windows = [[next(pipe) for _ in range(p.size)]
               for p in plan_windows(steps, interval)]
    pipe.close()
    return dict(engine=engine, windows=windows,
                state=lambda: init_state(model, seed, device=device),
                shell=shell.init(device), drain_fn=drain,
                stack_fn=stack_batches)


@register("zp.train_board")
def _train_board_factory(arch="granite-8b", steps=8, interval=2, batch=2,
                         seq=16, seed=0, device=None):
    return _train_board_parts(get_smoke_config(arch), steps, interval,
                              batch=batch, seq=seq, seed=seed,
                              device=device)


def train_board_spec(arch: str, steps: int, interval: int,
                     **kw) -> JobSpec:
    """Serializable JobSpec for the fused TRAIN board (the durable-intake
    analog of :func:`submit_train_job`, minus the loss sink)."""
    return JobSpec(name="train", factory="zp.train_board",
                   kwargs={"arch": arch, "steps": int(steps),
                           "interval": int(interval), **kw})


def submit_train_job(mgr, cfg, steps, interval, batch=2, seq=16, seed=0,
                     device=None, lr=None):
    """Fused train engine as a farm job (see ``_train_board_parts``);
    returns the list its sink fills with every step's loss."""
    parts = _train_board_parts(cfg, steps, interval, batch=batch, seq=seq,
                               seed=seed, device=device, lr=lr)
    losses: list = []

    def sink(plan, records, metrics):
        losses.extend(metrics["loss"].float().tolist())

    mgr.submit(FarmJob(name="train", on_drain=sink, **parts))
    return losses


def submit_decode_job(mgr, cfg, gen, interval, batch=2, prompt_len=16,
                      seed=0, device=None, params=None):
    """Decode engine as a farm job: the prefill runs up front (serve's,
    on ``params``, drawn from ``seed`` unless given), the farm schedules
    the windowed decode with its telemetry shell — on a card one
    CUDA-graph replay a window (``prewarm`` captures the window lengths
    before the pass). Returns the token blocks its sink fills:
    ``np.concatenate(toks, axis=1)`` is the (batch, gen) greedy tokens."""
    device = resolve_device(device)
    model = build_model(cfg, Runtime())
    if params is None:
        params = model.init(seed, device=device)
    bf = make_batch_fn(cfg, batch, prompt_len, seed)
    b = {k: torch.from_numpy(v).to(device, dtype_of(cfg.dtype)
                                   if k in _FRONTEND_INPUTS else None)
         for k, v in bf(0).items() if k != "labels"}
    max_len = prompt_len + (cfg.num_patches if cfg.family == "vlm" else 0) \
        + gen + 8
    with torch.no_grad():
        cache, logits = make_prefill_step(model, max_len)(params, b)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    engine = make_decode_engine(model, params)
    windows = [list(range(p.start, p.boundary))
               for p in plan_windows(gen - 1, interval)]
    toks: list = [tok.cpu().numpy()]

    def sink(plan, records, ys):
        toks.append(ys.numpy()[:, :, 0].T)

    mgr.submit(FarmJob(
        name="decode", engine=engine, windows=windows, state=(cache, tok),
        shell=shell_init(decode_shell_config(interval), device),
        drain_fn=drain, stack_fn=stack_batches, on_drain=sink))
    return toks


def _sync_all(tree):
    devices = {t.device for t in tree_leaves(tree)
               if torch.is_tensor(t) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def prewarm(mgr) -> float:
    """Warm every board before the farm runs, on the calling thread: a
    ``WindowGraphs`` engine with warm-up on clones has every window length
    of its stream captured now (no capture, and none of its host syncs,
    inside the pass); any other engine runs once on its first window
    (lazy library loads, kernel builds; a ``WindowGraphs`` with eager
    warm-up takes that as its eager window). Each call gets fresh copies
    of the job's state and shell, which the port's engines may update in
    place (the reference calls each engine on the job's own state); the
    results are dropped. Returns the seconds it took."""
    t0 = time.perf_counter()
    for job in mgr.jobs:
        windows = job.windows() if callable(job.windows) else job.windows
        firsts: dict = {}               # window length -> its first items
        for items in windows:
            if items:
                firsts.setdefault(len(items), items)
        if not firsts:
            continue
        engine = job.engine
        graphed = isinstance(engine, WindowGraphs) \
            and engine.warmup == "clone"
        for items in (firsts.values() if graphed
                      else [next(iter(firsts.values()))]):
            stack = job.stack_fn(items) if job.stack_fn else items
            state, shell = job._initial("state"), job._initial("shell")
            if graphed:
                engine.prepare(state, shell, stack)
            else:
                engine(state, shell, stack)
            _sync_all(state)
    return time.perf_counter() - t0


def _toy_stack(items):
    # ONE shared function: lane coalescing requires the same stack_fn
    # OBJECT across members (per-board lambdas would defeat it)
    return torch.as_tensor(np.stack(items))


def _noop_barrier(state, boundary):
    pass


def _same_stream(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@dataclasses.dataclass
class SoakBoard:
    """Handle for the synthetic async straggler (see
    ``submit_soak_straggler``): the job, its delivered outputs, and the
    bitwise-expected outputs an uninterrupted run would produce."""
    job: FarmJob
    outputs: list
    expected: list

    def preserved(self) -> bool:
        return (len(self.outputs) == len(self.expected)
                and all(np.array_equal(a.numpy(), b)
                        for a, b in zip(self.outputs, self.expected)))


def _toy_board(n_windows: int, scale: float, slow=None):
    """(engine, items, expected) of a toy board: window *w* yields
    ``[w * scale]`` (analytic, so a divergence shows bit-exactly);
    ``slow(state)`` runs before each window's compute."""
    def engine(state, shell, stack):
        if slow is not None:
            slow()
        return state + stack.sum(), shell, stack * scale

    items = [np.float32(i) for i in range(n_windows)]
    expected = [np.asarray([x * scale], np.float32) for x in items]
    return engine, items, expected


def submit_soak_straggler(mgr, n_windows: int = 150,
                          delay: float = 0.5) -> SoakBoard:
    """A long-workload board gone slow, for the wall-time eviction gate.

    The board sleeps per window on its FIRST attempt only — modeling a
    slow SEAT rather than a slow job, so the requeued attempt replays fast
    on its new slot. The stream is long (ceiling ``n_windows * delay``)
    so it is still running once the fleet's samples are in; eviction is
    what cuts it short. Its ``verify`` asserts every window bit-exactly,
    so preserved-outputs checks are meaningful."""
    def slow():
        if board.job.attempts == 1:
            time.sleep(delay)           # the slow seat

    engine, items, expected = _toy_board(n_windows, 2.0, slow)
    outs: list = []

    def verify(plan, records, ys):
        np.testing.assert_array_equal(ys.numpy(), expected[plan.start])

    board = SoakBoard(
        job=FarmJob(
            name="soak", engine=engine, windows=[[x] for x in items],
            state=torch.tensor(0.0), shell={}, stack_fn=_toy_stack,
            verify=verify, on_drain=lambda p, r, y: outs.append(y)),
        outputs=outs, expected=expected)
    mgr.submit(board.job)
    return board


def submit_restart_board(mgr, n_windows: int = 40, evict_at: int = 8,
                         delay: float = 0.02) -> SoakBoard:
    """A long board with a checkpoint barrier at EVERY window boundary,
    for the checkpointed-requeue gate: its verify force-marks the job
    mid-stream (first attempt only), so the eviction lands with committed
    snapshots behind it and the requeued attempt must resume from the
    last accepted barrier instead of window 0. The per-window ``delay``
    keeps attempt 1 slow enough that the async control plane's sweep can
    signal the mark at a drain boundary; the replay runs full speed."""
    def slow():
        if board.job.attempts == 1:
            time.sleep(delay)

    engine, items, expected = _toy_board(n_windows, 2.0, slow)
    outs: list = []
    marked = {"done": False}

    def verify(plan, records, ys):
        np.testing.assert_array_equal(ys.numpy(), expected[plan.start])
        if plan.index >= evict_at and not marked["done"]:
            marked["done"] = True
            mgr.force_evict("restart")

    board = SoakBoard(
        job=FarmJob(
            name="restart", engine=engine, windows=[[x] for x in items],
            state=torch.tensor(0.0), shell={}, stack_fn=_toy_stack,
            verify=verify, on_drain=lambda p, r, y: outs.append(y),
            barriers=(DrainBarrier(every=1, action=_noop_barrier),)),
        outputs=outs, expected=expected)
    mgr.submit(board.job)
    return board


def run_restart_smoke(mode: str = "async", slots: int = 3,
                      device=None) -> dict:
    """The checkpointed-requeue gate: a mid-stream eviction must resume
    from the job's last accepted drain-barrier snapshot. ``ok`` unless
    the evicted board requeued, replayed FEWER windows than it had
    committed, logged a snapshot resume, and still delivered outputs
    bit-identical to an uninterrupted run."""
    mgr = FarmManager(slots=slots, mode=mode, evict_stragglers=False,
                      device=device)
    board = submit_restart_board(mgr)
    report = mgr.run(strict=False)
    j = report["jobs"]["restart"]
    resumes = report["telemetry"]["resumes"]
    ok = (j["status"] == "done"
          and j["requeues"] >= 1
          and j["windows_committed"] > 0
          and j["windows_replayed"] < j["windows_committed"]
          and any(r["job"] == "restart" and r["window"] > 0
                  for r in resumes)
          and board.preserved())
    return {
        "mode": mode,
        "jobs": report["jobs"],
        "resumes": resumes,
        "evictions": report["telemetry"]["evictions"],
        "preserved": board.preserved(),
        "windows_delivered": len(board.outputs),
        "ok": ok,
    }


def _chaos_board(mgr, name: str, scale: float, n_windows: int,
                 max_requeues: int = 6) -> list:
    """One toy chaos board: window *w* yields ``[w * scale]``, a
    checkpoint barrier at every window boundary (the snapshot-fault
    target), and a generous requeue budget (chaos schedules at most one
    fault pair per board). Returns the board's delivered-output list."""
    engine, items, _ = _toy_board(n_windows, scale)
    outs: list = []
    mgr.submit(FarmJob(
        name=name, engine=engine, windows=[[x] for x in items],
        state=torch.tensor(0.0), shell={}, stack_fn=_toy_stack,
        on_drain=lambda p, r, y: outs.append(y),
        barriers=(DrainBarrier(every=1, action=_noop_barrier),),
        max_requeues=max_requeues))
    return outs


def run_chaos_smoke(seed: int, mode: str = "async", slots: int = 4,
                    n_jobs: int = 8, n_windows: int = 6,
                    device=None) -> dict:
    """The fault-recovery gate: run the toy workload fault-free (the
    oracle), then again under the seed's injection schedule plus one
    permanently-poisoned board. ``ok`` requires every injected fault
    fired and recovered, non-quarantined outputs bit-identical to the
    oracle, and the poisoned board quarantined (never raised). The
    watchdog's timeout is 1.5 s of wall time (a hung drain sleeps 2.5×
    that): the boards' windows take microseconds."""
    def build(policy=None, timeout_s=600.0):
        # straggler eviction OFF: wall-time heuristics are the one
        # nondeterministic eviction source, and chaos needs the injected
        # faults to be the ONLY faults
        m = FarmManager(slots=slots, mode=mode, evict_stragglers=False,
                        watchdog=Watchdog(timeout_s=timeout_s),
                        poll_s=0.01, policy=policy, device=device)
        o = {f"board{i}": _chaos_board(m, f"board{i}", float(i + 1),
                                       n_windows) for i in range(n_jobs)}
        return m, o

    mgr0, oracle = build()
    mgr0.run()

    mgr, outs = build(policy=FailurePolicy(quarantine=True),
                      timeout_s=1.5)
    harness = ChaosHarness(mgr, seed)
    schedule = harness.arm()

    # the poison board: submitted AFTER arm() so no injection targets it
    # — its engine genuinely always fails, and the farm must dead-letter
    # it and still complete everything else
    def poison_engine(state, shell, stack):
        raise RuntimeError("poisoned board output bus")

    mgr.submit(FarmJob(
        name="poison", engine=poison_engine,
        windows=[[np.float32(0)]], state=torch.tensor(0.0), shell={},
        stack_fn=_toy_stack, max_requeues=2))

    report = mgr.run(strict=False)
    problems = harness.gate(report, expect_quarantined={"poison"})
    for name in oracle:
        if not _same_stream(outs[name], oracle[name]):
            problems.append(f"{name}: outputs diverged from the "
                            f"fault-free oracle")
    return {
        "mode": mode,
        "seed": seed,
        "schedule": [dataclasses.asdict(i) for i in schedule],
        "faults_injected": len(harness.injector.fired),
        "jobs": {n: j["status"] for n, j in report["jobs"].items()},
        "quarantined": report["quarantined"],
        "retries": len(report["telemetry"]["retries"]),
        "fallbacks": report["telemetry"]["fallbacks"],
        "breaker_trips": report["telemetry"]["breaker_trips"],
        "problems": problems,
        "ok": not problems,
    }


def _lane_engine(state, shell, stack):
    """A toy board over ``state = {"bias", "w"}``: each step
    ``y = tanh(x @ w) + bias`` and the bias moves by ``0.01 * sum(y)``."""
    bias, w = state["bias"], state["w"]
    ys = []
    for i in range(stack.shape[0]):
        y = torch.tanh(stack[i] @ w) + bias
        bias = bias + 0.01 * y.sum()
        ys.append(y.sum(dim=-1))
    return {"bias": bias, "w": w}, shell, torch.stack(ys)


def _submit_lane_boards(mgr, w, n_boards: int, n_steps: int, group: int,
                        chaos_lane: bool, lane_key, scope=None):
    """``n_boards`` identical-arch boards over ONE shared weight ``w``
    (per-board state differs only in seed-derived inputs and bias — the
    lane packer must broadcast ``w`` as a single device copy). With
    ``chaos_lane`` the last board's verify raises ONCE mid-stream: in a
    lane-batched run that is a lane veto — only that lane may be detached
    and requeued solo; every other lane keeps running."""
    outs = {}
    marked = {"done": False}
    for i in range(n_boards):
        name = f"lane-board{i}"
        outs[name] = []
        rng = np.random.RandomState(100 + i)
        items = [rng.randn(4, 8).astype(np.float32)
                 for _ in range(n_steps)]
        verify = None
        if chaos_lane and i == n_boards - 1:
            def verify(plan, records, ys):
                if plan.index == 3 and not marked["done"]:
                    marked["done"] = True
                    raise RuntimeError("chaos lane: injected veto")
        mgr.submit(FarmJob(
            name=name, engine=_lane_engine,
            windows=[items[k:k + group]
                     for k in range(0, n_steps, group)],
            state={"bias": torch.tensor(i * 0.5), "w": w}, shell={},
            stack_fn=_toy_stack,
            on_drain=lambda p, r, y, n=name: outs[n].append(y),
            barriers=(DrainBarrier(every=1, action=_noop_barrier),),
            verify=verify, lane_key=lane_key, max_requeues=2,
            scope=scope))
    return outs


def _lane_weight():
    return torch.from_numpy(np.random.RandomState(0).randn(8, 8)
                            .astype(np.float32))


def run_lanes_smoke(lanes: int = 8, chaos_lane: bool = False,
                    mode: str = "async", slots: int = 2,
                    n_steps: int = 12, group: int = 2,
                    device=None) -> dict:
    """The lanes gate: ``lanes`` identical-arch boards must coalesce into
    one vmap-fused dispatch stream and stay bit-identical to the same
    boards run solo (the oracle). With ``chaos_lane`` one board's verify
    raises mid-stream: the farm must evict EXACTLY that lane (one lane
    veto, one requeue, snapshot resume), keep the other lanes running,
    and still deliver every board bit-identical."""
    w = _lane_weight()
    n_windows = (n_steps + group - 1) // group

    # solo oracle: same boards, no lane coalescing, no chaos
    mgr0 = FarmManager(slots=slots, mode=mode, evict_stragglers=False,
                       device=device)
    oracle = _submit_lane_boards(mgr0, w, lanes, n_steps, group,
                                 chaos_lane=False, lane_key=None)
    mgr0.run()

    mgr = FarmManager(slots=slots, mode=mode, evict_stragglers=False,
                      lanes=lanes, device=device)
    outs = _submit_lane_boards(mgr, w, lanes, n_steps, group,
                               chaos_lane=chaos_lane,
                               lane_key="lanes-smoke")
    report = mgr.run(strict=False)
    tel = report["telemetry"]

    problems = []
    for name in oracle:
        if not _same_stream(outs[name], oracle[name]):
            problems.append(f"{name}: outputs diverged from solo oracle")
    if any(j["status"] != "done" for j in report["jobs"].values()):
        problems.append("not every board finished done")
    if tel.get("lanes_per_dispatch_max", 1) < lanes:
        problems.append(
            f"boards did not coalesce: lanes_per_dispatch_max="
            f"{tel.get('lanes_per_dispatch_max')} < {lanes}")
    chaos_name = f"lane-board{lanes - 1}"
    if chaos_lane:
        vetoes = tel.get("lane_vetoes", [])
        if len(vetoes) != 1 or vetoes[0]["job"] != chaos_name:
            problems.append(f"expected exactly one lane veto on "
                            f"{chaos_name}, got {vetoes}")
        j = report["jobs"][chaos_name]
        if j["requeues"] != 1:
            problems.append(f"chaos lane requeues={j['requeues']}, "
                            f"expected 1")
        others = [report["jobs"][n]["requeues"] for n in outs
                  if n != chaos_name]
        if any(others):
            problems.append(f"surviving lanes were requeued: {others}")
        if not (0 < j["windows_committed"]
                and j["windows_replayed"] < n_windows):
            problems.append(
                f"chaos lane replayed the full stream "
                f"(committed={j['windows_committed']}, "
                f"replayed={j['windows_replayed']}) — snapshot resume "
                f"did not carry over")
    elif tel.get("lane_vetoes"):
        problems.append(f"unexpected lane vetoes: {tel['lane_vetoes']}")

    return {
        "mode": mode,
        "lanes": lanes,
        "chaos_lane": chaos_lane,
        "jobs": report["jobs"],
        "lanes_per_dispatch_max": tel.get("lanes_per_dispatch_max"),
        "lane_vetoes": tel.get("lane_vetoes", []),
        "problems": problems,
        "ok": not problems,
    }


def run_scope_smoke(mode: str = "async", lanes: int = 1,
                    every_n: int = 2, slots: int = 2,
                    n_steps: int = 12, group: int = 2,
                    device=None) -> dict:
    """The ZP-Scope non-interference gate: the SAME boards run scope-off
    (the oracle) and scope-on must deliver bit-identical outputs and
    final states, and the scoped run must produce a non-empty fleet scope
    report (on-device counters actually drained at the read rate).
    ``lanes > 1`` also runs the boards lane-coalesced, exercising the
    per-lane counter slices."""
    w = _lane_weight()
    n = max(1, lanes)
    lane_key = "scope-smoke" if n > 1 else None

    mgr0 = FarmManager(slots=slots, mode=mode, evict_stragglers=False,
                       lanes=n, device=device)
    oracle = _submit_lane_boards(mgr0, w, n, n_steps, group,
                                 chaos_lane=False, lane_key=lane_key)
    mgr0.run()

    spec = ScopeSpec(every_n_windows=every_n)
    mgr = FarmManager(slots=slots, mode=mode, evict_stragglers=False,
                      lanes=n, device=device)
    outs = _submit_lane_boards(mgr, w, n, n_steps, group,
                               chaos_lane=False, lane_key=lane_key,
                               scope=spec)
    report = mgr.run(strict=False)
    sc = report["telemetry"]["scope"]

    problems = []
    for name in oracle:
        if not _same_stream(outs[name], oracle[name]):
            problems.append(f"{name}: outputs diverged with scope on")
        s0, _ = mgr0.results[name]
        s1, sh1 = mgr.results[name]
        if not _same_stream(tree_leaves(s0), tree_leaves(s1)):
            problems.append(f"{name}: final state diverged with scope on")
        if isinstance(sh1, dict) and "zp_scope" in sh1:
            problems.append(f"{name}: scope counters leaked into results")
    if any(j["status"] != "done" for j in report["jobs"].values()):
        problems.append("not every board finished done")
    if not sc["samples"]:
        problems.append("scope report is empty: no samples drained")
    for job, row in sc["jobs"].items():
        if not row.get("windows") or not row.get("steps"):
            problems.append(f"{job}: scope counters never advanced "
                            f"({row})")

    return {
        "mode": mode,
        "lanes": n,
        "every_n_windows": every_n,
        "jobs": report["jobs"],
        "scope": sc,
        "problems": problems,
        "ok": not problems,
    }


# ------------------------------------------------------------ ZP-Ledger --

def _write_window_file(out_dir: str, board: str, index: int, ys,
                       fsync: bool = True) -> str:
    """Atomic, idempotent per-window delivery: tmp + fsync + rename keyed
    on the GLOBAL window index. This is the documented sink contract for
    the WAL's one honest edge — a window whose ``deliver`` record was
    torn by a crash is re-delivered once after recovery, and rewriting
    the same window file with the same bytes is a no-op. ``fsync=False``
    skips the fsync: the file then survives the death of the process
    (the kernel's page cache keeps it), not a power cut."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{board}_w{index:05d}.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"window": int(index), "y": np.asarray(ys).tolist()},
                  f, sort_keys=True)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _read_window_files(out_dir: str) -> dict:
    """``{file name: bytes}`` of every per-window file under ``out_dir``."""
    files = {}
    if os.path.isdir(out_dir):
        for fn in sorted(os.listdir(out_dir)):
            if fn.endswith(".json"):
                with open(os.path.join(out_dir, fn), "rb") as f:
                    files[fn] = f.read()
    return files


@register("zp.ledger_board")
def _ledger_board_factory(board="board", scale=1.0, n_windows=24,
                          out_dir=".", delay=0.005):
    """Registered toy board for the durable-farm gates: window *w* yields
    ``[w * scale]`` (analytic — divergence after recovery is detectable
    bit-exactly), a checkpoint barrier at every window boundary, and an
    idempotent per-window file sink. The per-window ``delay`` paces
    commits so the control plane's incremental delivery cursor tracks
    them — at a mid-stream SIGKILL the journal then holds BOTH a commit
    frontier and a delivered cursor behind it, the state recovery must
    reconcile. The control plane fsyncs a window file and a deliver
    record for each batch it delivers; where those fsyncs and its waits
    for the interpreter lock take longer than a window, the cursor falls
    behind the commits (``run_killrestart_smoke`` reports the lag)."""
    scale = float(scale)

    def engine(state, shell, stack):
        if delay:
            time.sleep(delay)
        return state + stack.sum(), shell, stack * scale

    def sink(plan, records, ys):
        _write_window_file(out_dir, board, plan.index, ys)

    return dict(
        engine=engine,
        windows=[[np.float32(w)] for w in range(int(n_windows))],
        state=torch.tensor(0.0), shell={},
        stack_fn=_toy_stack, on_drain=sink,
        barriers=(DrainBarrier(every=1, action=_noop_barrier),))


def ledger_board_spec(name: str, scale: float, n_windows: int,
                      ledger_dir: str) -> JobSpec:
    """One durable toy board: outputs, snapshots, and journal all live
    under ``ledger_dir`` so a recovering process finds everything by the
    journal alone. ``snapshot_keep=4`` leaves enough on-disk history for
    ``choose_resume`` to rewind past a torn newest snapshot."""
    return JobSpec(
        name=name, factory="zp.ledger_board",
        kwargs={"board": name, "scale": float(scale),
                "n_windows": int(n_windows),
                "out_dir": os.path.join(ledger_dir, "outputs")},
        snapshot_dir=os.path.join(ledger_dir, "snaps", name),
        snapshot_keep=4, max_requeues=4)


class _CommitClock(ChaosInjector):
    """The injector of a durable-farm lifetime: counts the journaled
    commits, keeps the wall time of the first, and calls
    ``on_commit(job, n)`` at the n-th, before a ``process_kill`` armed
    there fires."""

    def __init__(self, telemetry, on_commit=None):
        super().__init__(telemetry=telemetry)
        self.commits = 0
        self.first_commit_unix = None
        self.on_commit = on_commit
        self._mu = threading.Lock()

    def fire(self, point, job=None, slot=None, **ctx):
        if point == "ledger.commit":
            with self._mu:
                self.commits += 1
                n = self.commits
                if self.first_commit_unix is None:
                    self.first_commit_unix = time.time()
            if self.on_commit is not None:
                self.on_commit(job, n)
        return super().fire(point, job=job, slot=slot, **ctx)


def run_ledger_farm(ledger_dir: str, mode: str = "async",
                    recover: bool = False, kill_after=None,
                    n_boards: int = 3, n_windows: int = 24,
                    slots: int = 2, device=None, specs=None, ledger=None,
                    on_commit=None) -> dict:
    """One durable-farm process lifetime: fresh (``recover=False``)
    submits ``specs`` (JobSpecs whose factories are registered in this
    process; by default ``n_boards`` toy boards of ``n_windows`` windows)
    through the journaled JobSpec intake; ``recover=True`` rebuilds the
    whole farm from ``ledger_dir``'s journal and finishes the campaign.
    ``ledger`` is an open FarmLedger on ``ledger_dir`` (one is opened by
    default). ``kill_after=N`` arms a ``process_kill`` injection at the
    N-th journaled commit — the caller sees this process die by SIGKILL,
    mid-write-order, exactly like an OOM kill; ``on_commit`` as
    :class:`_CommitClock`. The kernel launch counts are set to 0 just
    before the run; the lifetime ends once the snapshot stores' last
    writes are on disk. Reports the run's launches, its seconds, the
    commits it journaled (and the wall time of the first) and the
    journal's records and bytes."""
    ledger = ledger if ledger is not None else FarmLedger(ledger_dir)
    kw = dict(slots=slots, mode=mode, evict_stragglers=False, poll_s=0.01,
              device=device)
    if recover:
        mgr = FarmManager.recover(ledger, **kw)
    else:
        mgr = FarmManager(ledger=ledger, **kw)
        if specs is None:
            specs = [ledger_board_spec(f"board{i}", float(i + 1), n_windows,
                                       ledger_dir) for i in range(n_boards)]
        for spec in specs:
            mgr.submit_spec(spec)
    clock = _CommitClock(mgr.telemetry, on_commit)
    if kill_after is not None:
        # scope "farm" counts every journaled commit across all boards:
        # die at the Nth, whoever commits it
        clock.arm([Injection(kind="process_kill", point="ledger.commit",
                             scope="farm", name="*",
                             at=max(0, int(kill_after) - 1))])
    mgr.injector = clock
    kernels = counted_kernels()
    for fn in kernels.values():
        fn.launches = 0
    t = time.perf_counter()
    report = mgr.run(strict=False)
    run_s = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in kernels.items()}
    # the last commits' snapshot writes run on in the stores' threads
    # after run() returns: they finish before this lifetime ends
    for job in mgr.jobs:
        if job.snapshot_store is not None:
            job.snapshot_store.wait()
    jobs = report["jobs"]       # empty-journal recover: a minimal report
    out = {
        "mode": mode,
        "recover": recover,
        "jobs": jobs,
        "recoveries": report["telemetry"].get("recoveries", []),
        "interrupted": report.get("interrupted", False),
        "windows_committed": sum(j["windows_committed"]
                                 for j in jobs.values()),
        "windows_replayed": sum(j["windows_replayed"]
                                for j in jobs.values()),
        "windows_delivered": sum(j["windows_delivered"]
                                 for j in jobs.values()),
        "launches": launches,
        "run_s": run_s,
        "commits": clock.commits,
        "first_commit_unix": clock.first_commit_unix,
        "journal": {"records": len(ledger.records()),
                    "bytes": os.path.getsize(ledger.path)},
        "ok": (not report.get("interrupted", False)
               and all(j["status"] == "done" for j in jobs.values())),
    }
    if not report.get("interrupted", False):
        # bound journal growth once the campaign settled — NOT inside
        # FarmManager.run(), which must leave the full audit trail for
        # a supervisor (and the kill-restart gate) to inspect
        ledger.compact()
    ledger.close()
    return out


def _tail(text: str, n: int = 2000) -> str:
    return text[-n:] if text else ""


def victim_journal(victim_dir: str) -> dict:
    """What a SIGKILLed lifetime left in its journal: each board's
    journaled commits (``pre_commits``) and delivered cursor
    (``pre_delivered``), and the windows by which the cursor trailed
    the commits (``delivery_lag``)."""
    led = FarmLedger(victim_dir)
    pre = led.replay()
    led.close()
    delivered = {n: js.delivered for n, js in pre.jobs.items()}
    commits = {n: len(js.commits) for n, js in pre.jobs.items()}
    return {"pre_delivered": delivered, "pre_commits": commits,
            "delivery_lag": {n: commits[n] - d
                             for n, d in delivered.items()}}


def killrestart_problems(oracle_dir: str, victim_dir: str, boards,
                         n_windows: int, victim_returncode: int,
                         victim: dict, recovered: dict) -> list:
    """The kill-restart gate over a campaign's three lifetimes (the
    oracle's journal and per-window files under ``oracle_dir``, the
    victim's and then the recovery's under ``victim_dir``): the victim
    died by SIGKILL with delivery already in flight (``victim`` from
    :func:`victim_journal`), the recovery (``recovered``, its
    :func:`run_ledger_farm` report) finished every board, resumed at
    least one mid-stream (window > 0) and replayed fewer windows than it
    committed, every board of ``boards`` was delivered exactly
    ``n_windows`` windows across both lifetimes, and the per-window
    files are bit-identical to the oracle's. Returns the problems."""
    problems: list = []
    if victim_returncode != -signal.SIGKILL:
        problems.append(f"victim exited {victim_returncode}, expected "
                        f"{-signal.SIGKILL} (SIGKILL'd mid-commit)")
    # the delivered cursors must already be moving, or the exactly-once
    # suppression across lifetimes would be exercised vacuously
    if sum(victim["pre_delivered"].values()) <= 0:
        problems.append("victim died before delivering any window — the "
                        "kill landed too early to gate recovery")
    if recovered:
        if not recovered.get("ok"):
            problems.append("recovered run did not finish every board "
                            "done")
        if not any(r["window"] > 0
                   for r in recovered.get("recoveries", [])):
            problems.append("no board resumed mid-stream (every recovery "
                            "fell back to window 0)")
        replayed = recovered.get("windows_replayed", -1)
        committed = recovered.get("windows_committed", 0)
        if not 0 <= replayed < committed:
            problems.append(
                f"windows_replayed={replayed} not below "
                f"windows_committed={committed} — recovery replayed the "
                f"full stream (delivery lag at the kill: "
                f"{victim['delivery_lag']})")
    # exactly-once across both lifetimes: the final journal's deliver
    # cursor per board is exactly the stream length — never short (lost
    # windows) and never past it (double delivery)
    led = FarmLedger(victim_dir)
    final = led.replay()
    led.close()
    for name in boards:
        js = final.jobs.get(name)
        if js is None or js.status != "done":
            problems.append(f"{name}: not done in the final journal")
        elif js.delivered != n_windows:
            problems.append(f"{name}: delivered cursor {js.delivered} != "
                            f"{n_windows} windows across both lifetimes")
    want = _read_window_files(os.path.join(oracle_dir, "outputs"))
    got = _read_window_files(os.path.join(victim_dir, "outputs"))
    if len(want) != len(boards) * n_windows:
        problems.append(f"oracle produced {len(want)} window files, "
                        f"expected {len(boards) * n_windows}")
    if got != want:
        missing = sorted(set(want) - set(got))
        diff = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        problems.append(f"outputs diverged from the oracle: "
                        f"missing={missing[:5]} differing={diff[:5]}")
    return problems


def run_killrestart_smoke(mode: str = "async", n_boards: int = 3,
                          n_windows: int = 24, kill_after: int = 8,
                          slots: int = 2, device=None) -> dict:
    """The ``farm-killrestart-smoke`` gate: whole-process crash recovery.
    Three lifetimes: (1) a fault-free oracle run in-process; (2) a victim
    subprocess armed with ``process_kill`` at the ``kill_after``-th
    journaled commit — it must die by SIGKILL with delivery already in
    flight; (3) a ``--recover`` subprocess over the victim's ledger that
    must finish the campaign. ``ok`` requires what
    :func:`killrestart_problems` gates. The subprocesses run on
    ``device`` (``--device``) with a timeout of 600 s each; a problem
    quotes a failed one's stderr tail. ``pre_commits``,
    ``pre_delivered`` and ``delivery_lag`` are the victim's journal at
    its death (:func:`victim_journal`)."""
    import shutil
    import subprocess
    import tempfile

    device = resolve_device(device)
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = tempfile.mkdtemp(prefix="zp-killrestart-")
    problems: list = []
    out: dict = {"mode": mode, "kill_after": kill_after,
                 "device": str(device), "seconds": {}}
    try:
        oracle_dir = os.path.join(base, "oracle")
        t = time.perf_counter()
        oracle = run_ledger_farm(oracle_dir, mode=mode, n_boards=n_boards,
                                 n_windows=n_windows, slots=slots,
                                 device=device)
        out["seconds"]["oracle"] = time.perf_counter() - t
        if not oracle["ok"]:
            problems.append("fault-free oracle run failed")

        victim_dir = os.path.join(base, "victim")
        env = dict(os.environ)
        env["PYTHONPATH"] = src_root + os.pathsep \
            + env.get("PYTHONPATH", "")
        common = [sys.executable, "-m", "repro_torch.launch.farm",
                  "--ledger", victim_dir, f"--{mode}",
                  "--slots", str(slots), "--device", str(device),
                  "--ledger-boards", str(n_boards),
                  "--ledger-windows", str(n_windows)]
        t = time.perf_counter()
        victim = subprocess.run(
            common + ["--kill-after-commits", str(kill_after)],
            env=env, capture_output=True, text=True, timeout=600)
        out["seconds"]["victim"] = time.perf_counter() - t
        out["victim_returncode"] = victim.returncode
        if victim.returncode != -signal.SIGKILL:
            problems.append(f"victim stderr: {_tail(victim.stderr)}")
        # the victim's journal as the recovery will see it
        pre = victim_journal(victim_dir)
        out.update(pre)

        t = time.perf_counter()
        rec = subprocess.run(common + ["--recover"], env=env,
                             capture_output=True, text=True, timeout=600)
        out["seconds"]["recover"] = time.perf_counter() - t
        if rec.returncode != 0:
            problems.append(f"recovery run exited {rec.returncode}: "
                            f"{_tail(rec.stderr)}")
        try:
            recovered = json.loads(rec.stdout)
        except ValueError:
            recovered = {}
            problems.append("recovery run printed no parseable report")
        out["recovered"] = recovered
        problems += killrestart_problems(
            oracle_dir, victim_dir, [f"board{i}" for i in range(n_boards)],
            n_windows, victim.returncode, pre, recovered)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["problems"] = problems
    out["ok"] = not problems
    return out


def write_telemetry(path: str, out: dict, run_key: str) -> str:
    """Dump a farm run's merged telemetry + scope report as JSON, keyed
    by run so repeated invocations MERGE into one file (one mergeable
    record per run)."""
    data = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
    key, i = run_key, 1
    while key in data:
        i += 1
        key = f"{run_key}#{i}"
    data[key] = {
        "ts": time.time(),
        "telemetry": out.get("telemetry", {}),
        "scope": out.get("telemetry", {}).get("scope", {}),
        "summary": out.get("summary"),
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=float)
    return key


def verify_inputs(cfg, n: int, batch: int, seq: int, seed: int, device):
    """The verify boards' activation batches: ``n`` draws of (batch, seq,
    d_model) standard normals in the model's dtype, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(batch, seq, cfg.d_model, generator=g,
                        device=device).to(dtype_of(cfg.dtype))
            for _ in range(n)]


def run_farm(arch: str, steps: int, slots, interval: int = 2,
             synthetic_straggler: bool = False, straggler_factor: float = 6.0,
             seed: int = 0, mode: str = "async",
             handle_sigint: bool = False, scope: ScopeSpec = None,
             device=None) -> dict:
    """The mixed workload — a train board, a decode board and two verify
    boards of ``arch``'s smoke config — through one farm pass."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch)
    # min_s floors the straggler RATIO check: the mixed workload's boards
    # legitimately differ in window cost (a decode window costs more than
    # a one-layer verify window), so sub-200ms medians are never flagged
    # however large the ratio — only genuinely slow boards are evictable
    mgr = FarmManager(slots=slots, straggler_factor=straggler_factor,
                      straggler_min_s=0.2, mode=mode, device=device)

    losses = submit_train_job(mgr, cfg, steps, interval, seed=seed,
                              device=device)
    toks = submit_decode_job(mgr, cfg, gen=steps, interval=interval,
                             seed=seed, device=device)

    params = build_model(cfg, Runtime()).init(seed, device=device)
    B, S = 2, 16
    xs = verify_inputs(cfg, max(2, steps // 4), B, S, seed, device)
    pos = torch.arange(S, dtype=torch.int32, device=device)[None] \
        .expand(B, S).contiguous()
    with torch.no_grad():
        finalize = submit_subsystem_jobs(mgr, params, cfg, Runtime(), xs,
                                         pos, layer_idxs=[0, 1],
                                         group_size=interval)

    if scope is not None:
        # every board opts into the instrumentation plane: on-device
        # counters drained at the read rate, feeding the scope telemetry
        # channel and the watchdog's work-rate straggler signal
        for j in mgr.jobs:
            j.scope = scope

    straggler = None
    soak = None
    if synthetic_straggler:
        if mode == "async":
            # wall-time path: a long-workload board gone slow, caught by
            # the watchdog from measured window wall alone
            soak = submit_soak_straggler(mgr)
            straggler = soak.job
        else:
            # lockstep path: dispatch-cost observations on the short
            # verify streams are too few to flag (window 0 is warm-up),
            # so the board is force-marked — the deterministic oracle path
            straggler = mgr.jobs[-1]        # last verify board
            inner = straggler.engine

            def slow_engine(state, shell, stack):
                time.sleep(0.15)            # a board gone slow
                return inner(state, shell, stack)

            straggler.engine = slow_engine
            mgr.force_evict(straggler.name)

    prewarm_s = prewarm(mgr)
    drainer = _SignalDrain(mgr).install() if handle_sigint else None
    if handle_sigint:
        print(f"farm: running {len(mgr.jobs)} jobs ({mode})",
              file=sys.stderr, flush=True)
    try:
        report = mgr.run(strict=False)
    finally:
        if drainer is not None:
            drainer.restore()
    if report["interrupted"]:
        # graceful stop: partial report + telemetry, no pass/fail gating —
        # committed prefixes and published snapshots were kept
        return {
            "mode": mode,
            "interrupted": True,
            "exit_code": drainer.exit_code if drainer else 130,
            "prewarm_s": round(prewarm_s, 3),
            "jobs": report["jobs"],
            "telemetry": report["telemetry"],
            "summary": mgr.telemetry.summary(),
            "ok": False,
        }
    reps = finalize()

    out = {
        "mode": mode,
        "prewarm_s": round(prewarm_s, 3),
        "jobs": report["jobs"],
        "telemetry": report["telemetry"],
        "summary": mgr.telemetry.summary(),
        "train": {"steps": len(losses), "losses": losses,
                  "loss_first": losses[0] if losses else None,
                  "loss_last": losses[-1] if losses else None},
        "decode": {"tokens": np.concatenate(toks, axis=1).tolist()},
        "verify": {k: r.summary() for k, r in reps.items()},
    }

    ok = all(j["status"] == "done" for j in report["jobs"].values())
    ok = ok and not any(r.diverged for r in reps.values())
    if synthetic_straggler:
        evs = report["telemetry"]["evictions"]
        evicted = {e["job"] for e in evs}
        ok = ok and straggler.name in evicted \
            and report["jobs"][straggler.name]["requeues"] >= 1
        if soak is not None:
            # the wall-time-divergence gate: the board must have been
            # caught by the watchdog (not a forced mark), and its delivered
            # outputs must be bit-identical to an uninterrupted run
            ok = ok and any(e["job"] == straggler.name
                            and e["why"] == "straggler" for e in evs)
            ok = ok and soak.preserved()
            out["soak"] = {"windows": len(soak.outputs),
                           "preserved": soak.preserved()}
    out["ok"] = ok
    return out


def _refused(args) -> str | None:
    """The message for a flag that waits for a later slice, if any."""
    for flag, on, slice_ in (
            ("--certify", args.certify, CERT_SLICE),
            ("--certify-smoke", args.certify_smoke, CERT_SLICE),
            ("--roofline", args.roofline, ROOFLINE_SLICE)):
        if on:
            return f"farm: {flag} {slice_}"
    return None


def _emit(out: dict):
    print(json.dumps(out, indent=1, default=float))
    if not out["ok"]:
        sys.exit(1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="granite-8b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--sample-interval", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--synthetic-straggler", action="store_true")
    ap.add_argument("--straggler-factor", type=float, default=6.0)
    ap.add_argument("--restart-smoke", action="store_true",
                    help="checkpointed-requeue gate: a mid-stream "
                         "eviction must resume from the last accepted "
                         "barrier snapshot (replayed < committed) with "
                         "bit-identical outputs")
    ap.add_argument("--lanes", type=int, metavar="N", default=None,
                    help="lane-batched boards gate: N identical-arch "
                         "boards must coalesce into one vmap-fused "
                         "dispatch stream bit-identical to solo runs")
    ap.add_argument("--chaos-lane", action="store_true",
                    help="with --lanes: one board's verify raises "
                         "mid-stream; exactly that lane must be evicted "
                         "and requeued solo while the others keep "
                         "running bit-identically")
    ap.add_argument("--scope", type=int, metavar="N", default=None,
                    help="enable the ZP-Scope instrumentation plane on "
                         "every board with a read rate of every N window "
                         "drains")
    ap.add_argument("--scope-smoke", action="store_true",
                    help="non-interference gate: the same boards run "
                         "scope-off and scope-on must be bit-identical "
                         "and the scoped run must produce a non-empty "
                         "scope report (combine with --lanes for the "
                         "lane-coalesced variant)")
    ap.add_argument("--telemetry-out", metavar="PATH", default=None,
                    help="dump the run's merged telemetry + scope report "
                         "as JSON at PATH (repeated runs merge by key)")
    ap.add_argument("--chaos", type=int, metavar="SEED", default=None,
                    help="fault-recovery gate: inject a seeded fault "
                         "schedule; exit non-zero unless every fault was "
                         "recovered with oracle-identical outputs and "
                         "the poisoned board quarantined")
    ap.add_argument("--ledger", metavar="DIR", default=None,
                    help="attach a ZP-Ledger write-ahead journal at DIR "
                         "and run the durable toy workload (outputs, "
                         "snapshots, and journal all under DIR)")
    ap.add_argument("--recover", action="store_true",
                    help="with --ledger: rebuild the farm from DIR's "
                         "journal after a process death and finish the "
                         "campaign")
    ap.add_argument("--kill-after-commits", type=int, metavar="N",
                    default=None,
                    help="with --ledger: SIGKILL this process at the "
                         "N-th journaled commit (chaos process_kill — "
                         "models an OOM kill mid-write-order)")
    ap.add_argument("--ledger-boards", type=int, default=3,
                    help="with --ledger: number of toy boards")
    ap.add_argument("--ledger-windows", type=int, default=24,
                    help="with --ledger: windows per toy board")
    ap.add_argument("--killrestart-smoke", action="store_true",
                    help="whole-process crash-recovery gate: oracle run, "
                         "SIGKILL'd victim subprocess, --recover "
                         "subprocess; exit non-zero unless recovery "
                         "resumed mid-stream with bit-identical outputs "
                         "and exactly-once delivery across lifetimes")
    # what waits for a later slice: accepted so that it is refused by
    # name, never silently ignored
    ap.add_argument("--certify", action="store_true",
                    help="static board certification (ZP-Cert)")
    ap.add_argument("--certify-smoke", action="store_true",
                    help="ZP-Cert admission gate (ZP-Cert)")
    ap.add_argument("--roofline", action="store_true",
                    help="measured-window roofline (the measured-window "
                         "roofline slice)")
    g = ap.add_mutually_exclusive_group()
    g.add_argument("--async", dest="mode", action="store_const",
                   const="async", default="async",
                   help="per-slot dispatcher threads and streams "
                        "(default)")
    g.add_argument("--lockstep", dest="mode", action="store_const",
                   const="lockstep",
                   help="single-thread round-robin host loop (the "
                        "bit-identity oracle)")
    args = ap.parse_args(argv)

    refused = _refused(args)
    if refused:
        sys.exit(refused)

    dev = args.device
    if args.killrestart_smoke:
        return _emit(run_killrestart_smoke(mode=args.mode, device=dev))
    if args.ledger:
        return _emit(run_ledger_farm(args.ledger, mode=args.mode,
                                     recover=args.recover,
                                     kill_after=args.kill_after_commits,
                                     n_boards=args.ledger_boards,
                                     n_windows=args.ledger_windows,
                                     slots=args.slots, device=dev))
    if args.scope_smoke:
        out = run_scope_smoke(mode=args.mode, lanes=args.lanes or 1,
                              every_n=args.scope or 2, slots=args.slots,
                              device=dev)
        if args.telemetry_out:
            write_telemetry(args.telemetry_out,
                            {"telemetry": {"scope": out["scope"]}},
                            f"scope-smoke-{args.mode}-l{args.lanes or 1}")
        return _emit(out)
    if args.restart_smoke:
        return _emit(run_restart_smoke(mode=args.mode, slots=args.slots,
                                       device=dev))
    if args.lanes is not None:
        return _emit(run_lanes_smoke(lanes=args.lanes,
                                     chaos_lane=args.chaos_lane,
                                     mode=args.mode, device=dev))
    if args.chaos is not None:
        return _emit(run_chaos_smoke(args.chaos, mode=args.mode,
                                     slots=args.slots, device=dev))

    scope = (ScopeSpec(every_n_windows=args.scope)
             if args.scope is not None else None)
    try:
        out = run_farm(args.arch, args.steps, args.slots,
                       interval=args.sample_interval,
                       synthetic_straggler=args.synthetic_straggler,
                       straggler_factor=args.straggler_factor,
                       mode=args.mode, handle_sigint=True, scope=scope,
                       device=dev)
    except KeyboardInterrupt:
        # ^C before the farm was running (job setup) or a second ^C
        # during the graceful drain: nothing to keep, exit the
        # conventional SIGINT code without a traceback
        print("farm: interrupted before completion", file=sys.stderr)
        sys.exit(130)
    if args.telemetry_out:
        write_telemetry(args.telemetry_out, out,
                        f"farm-{args.mode}-{args.arch}-s{args.steps}")
    if out.get("interrupted"):
        print(json.dumps(out, indent=1, default=float))
        print(out["summary"], file=sys.stderr)
        sys.exit(out.get("exit_code", 130))
    _emit(out)


if __name__ == "__main__":
    main()
