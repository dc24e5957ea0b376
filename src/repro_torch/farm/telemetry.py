"""Farm telemetry: per-device window latency, occupancy, drain vetoes,
and per-slot host-overhead attribution.

Aggregates every board's signals into ONE farm report (the FireSim
manager's consolidated run-farm status): per-slot window latency
(dispatch-to-drain, pipelined — the drain of window *i* lands while window
*i+1* is in flight, so this is "time until the window's results were in
hand"), per-slot dispatch cost (the engine-call wall time), occupancy
sampled at every admission/drain boundary, drain-veto counts (a job
verifier rejecting a window), and the eviction log.

Every latency channel reports n/mean/p50/p95/p99/max — tail latency is
the farm's health signal (one slow board hides behind a mean), and each
slot's host-overhead channels are folded into a per-slot
:class:`~repro_torch.core.profiler.StallStack` whose dominant term is surfaced
in :meth:`report`/:meth:`summary` (the live stall-stack attribution the
solo train loop gets from its Profiler, reconstructed farm-side from the
slot threads' own timestamps).

Device-side channels (ZP-Scope): ``scope(slot, job, sample)`` ingests the
instrumentation plane's read-rate samples — on-device step/token
counters, gate toggle bits, commit digests — and
:meth:`scope_report` joins them into fleet-wide per-job (and per-lane)
counter tables.

Host-overhead channels (filled by the ASYNC farm's slot threads, from
their own timestamps — the attribution that makes an async win explainable
rather than just measured):

  queue_wait — admission-to-pickup: how long an assigned job sat in the
      slot's bounded work queue before its dispatcher thread took it;
  dispatch   — the engine-call wall (the enqueue, per window);
  drain      — the blocking fetch + verify wall per retired window;
  idle       — the gap between a slot thread finishing one assignment and
      picking up the next (slot starvation — admission latency, not board
      slowness);
  queue_depth — slot work-queue depth sampled at every assignment.

Failure-policy channels (filled by the :class:`FailurePolicy` layer and
the chaos harness): per-job retry counts with their backoff, quarantined
(dead-lettered) jobs, circuit-breaker trips/probes per slot, snapshot
integrity fallbacks, and a fault-recovery log pairing every injected
fault with the recovery path that absorbed it, and the crash-recovery
log of ZP-Ledger (the jobs a dead process's journal resumed), and the
ZP-Cert admission gate's verdicts (``certify``: a board dead-lettered
unrun for error findings, or admitted with warnings).

All mutation is lock-protected: slot threads record concurrently while
the control plane reads reports. Every event log is a BOUNDED deque with
a dropped-count: a week-long soak run keeps the newest ``max_events``
entries per log and reports how many older ones aged out, instead of
growing host memory without bound.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Tuple

from repro_torch.core.profiler import StallStack


def _pct(s: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list."""
    import math
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def _stats(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"n": 0}
    s = sorted(xs)
    return {"n": len(xs),
            "mean": sum(xs) / len(xs),
            "p50": s[len(s) // 2],
            "p95": _pct(s, 0.95),
            "p99": _pct(s, 0.99),
            "max": s[-1]}


class _BoundedLog:
    """Append-only event log capped at ``maxlen`` entries: the newest
    events are retained, the eviction count is reported (``dropped``) so
    a truncated log is never mistaken for a short run. NOT thread-safe on
    its own — callers hold the telemetry lock."""

    def __init__(self, maxlen: int):
        self._q: deque = deque(maxlen=maxlen)
        self.dropped = 0

    def append(self, item):
        if len(self._q) == self._q.maxlen:
            self.dropped += 1
        self._q.append(item)

    def __len__(self):
        return len(self._q)

    def __iter__(self):
        return iter(self._q)


class FarmTelemetry:
    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_events: int = 4096):
        self.clock = clock
        self.max_events = max_events
        self.window_ms = defaultdict(list)      # slot -> drain latencies
        self.dispatch_ms = defaultdict(list)    # slot -> engine-call cost
        self.drain_wall_ms = defaultdict(list)  # slot -> fetch+verify wall
        self.queue_wait_ms = defaultdict(list)  # slot -> admission->pickup
        self.idle_ms = defaultdict(list)        # slot -> between-job gaps
        self.queue_depth = defaultdict(list)    # slot -> depth at assignment
        self.windows = defaultdict(int)         # slot -> drained windows
        self.vetoes = defaultdict(int)          # slot -> drain vetoes
        # ----- lane channels (lane-batched many-DUT dispatch) -----
        self.lanes_per_dispatch = defaultdict(list)  # slot -> lanes/assignment
        self.lane_vetoes = _BoundedLog(max_events)   # {slot, job, lane}
        self.evictions = _BoundedLog(max_events)    # {slot, job, why}
        self.resumes = _BoundedLog(max_events)  # snapshot-resumed requeues
        self.occupancy_samples = _BoundedLog(max_events)
        # ----- failure-policy channels -----
        self.retries = _BoundedLog(max_events)  # {job, attempt, backoff_s}
        self.quarantined = _BoundedLog(max_events)      # {job, why}
        self.certifications = _BoundedLog(max_events)   # ZP-Cert: {job,
        # ok, rules, findings} — admission-gate verdicts with findings
        self.breaker_events = _BoundedLog(max_events)   # {slot, event, ..}
        self.fallbacks = _BoundedLog(max_events)        # snapshot fallbacks
        self.faults = _BoundedLog(max_events)   # fault-recovery log
        self.recoveries = _BoundedLog(max_events)   # ZP-Ledger: jobs a
        # crashed process's journal resumed ({job, window, delivered, ..})
        self.breaker_trips = defaultdict(int)   # slot -> trip count
        # ----- device-side channels (ZP-Scope instrumentation plane) -----
        self.scope_samples = _BoundedLog(max_events)  # {slot, job, sample}
        self.scope_jobs: Dict[str, dict] = {}   # job -> latest cumulative
        self.scope_quiet = defaultdict(int)     # job -> quiet samples seen
        self._t: Dict[Tuple[str, object], float] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ events --
    def dispatch(self, slot: str, key, cost_s: float):
        """One window enqueued on ``slot``: start its drain-latency clock
        and record the dispatch (engine-call) cost."""
        now = self.clock()
        with self._lock:
            self._t[(slot, key)] = now
            self.dispatch_ms[slot].append(cost_s * 1e3)

    def drain(self, slot: str, key, wall_s: float = None):
        """One window's results in hand on ``slot``; ``wall_s`` optionally
        records the host-side fetch+verify wall of the retired window."""
        now = self.clock()
        with self._lock:
            t0 = self._t.pop((slot, key), None)
            if t0 is not None:
                self.window_ms[slot].append((now - t0) * 1e3)
            if wall_s is not None:
                self.drain_wall_ms[slot].append(wall_s * 1e3)
            self.windows[slot] += 1

    def queue_wait(self, slot: str, wait_s: float):
        with self._lock:
            self.queue_wait_ms[slot].append(wait_s * 1e3)

    def idle(self, slot: str, gap_s: float):
        with self._lock:
            self.idle_ms[slot].append(gap_s * 1e3)

    def depth(self, slot: str, depth: int):
        with self._lock:
            self.queue_depth[slot].append(depth)

    def veto(self, slot: str):
        with self._lock:
            self.vetoes[slot] += 1

    def lanes(self, slot: str, n: int):
        """One assignment started on ``slot`` carrying ``n`` boards
        (1 = solo; >1 = a lane-batched fused run). Sampled at every
        assignment, so the mean is true lanes-per-dispatch occupancy."""
        with self._lock:
            self.lanes_per_dispatch[slot].append(int(n))

    def lane_veto(self, slot: str, job: str, lane: int):
        """A verifier vetoed ONE lane of a lane-batched run: lane ``lane``
        (board ``job``) is masked out and requeued solo while the
        surviving lanes keep running."""
        with self._lock:
            self.lane_vetoes.append({"slot": slot, "job": job,
                                     "lane": int(lane)})

    def eviction(self, slot: str, job: str, why: str):
        with self._lock:
            self.evictions.append((slot, job, why))

    def resume(self, slot: str, job: str, window: int, step: int):
        """A requeued job restored its barrier snapshot onto ``slot`` and
        resumed its window plan at ``window`` (= committed windows it did
        NOT replay)."""
        with self._lock:
            self.resumes.append({"slot": slot, "job": job,
                                 "window": int(window), "step": int(step)})

    def occupancy(self, active: int, total: int):
        with self._lock:
            self.occupancy_samples.append((active, total))

    # ----------------------------------------------- device-side events --
    def scope(self, slot: str, job: str, sample: dict):
        """One ZP-Scope read-rate sample drained at a barrier on ``slot``:
        the job's cumulative on-device counters (windows/steps/tokens),
        the interval deltas, gate toggle bits, and the running commit
        digest. The per-job table keeps the LATEST cumulative sample (the
        counters are monotone within an attempt); the bounded log keeps
        the interval history for tokens/sec-over-time plots."""
        with self._lock:
            self.scope_samples.append({"slot": slot, "job": job,
                                       "sample": dict(sample)})
            if sample.get("quiet"):
                self.scope_quiet[job] += 1
            self.scope_jobs[job] = {
                "slot": slot,
                **{k: sample.get(k) for k in (
                    "lanes", "windows", "steps", "tokens",
                    "gates", "digest", "d_windows", "d_steps",
                    "d_tokens")}}

    def _scope_report_locked(self) -> dict:
        jobs = {}
        for job, row in self.scope_jobs.items():
            row = dict(row)
            w = row.get("windows") or 0
            t = row.get("tokens")
            if w and t is not None:
                if isinstance(t, list):
                    row["tokens_per_window"] = [x / w for x in t]
                else:
                    row["tokens_per_window"] = t / w
            row["quiet_samples"] = self.scope_quiet.get(job, 0)
            jobs[job] = row
        return {
            "jobs": jobs,
            "samples": len(self.scope_samples),
            "samples_dropped": self.scope_samples.dropped,
            "quiet_samples": sum(self.scope_quiet.values()),
        }

    def scope_report(self) -> dict:
        """Fleet-wide device-side counter table: per-job cumulative
        windows/steps/tokens (per-lane lists under lane batching), derived
        tokens-per-window throughput, gate bits, commit digest, and the
        quiet-interval counts the straggler detector excluded."""
        with self._lock:
            return self._scope_report_locked()

    # -------------------------------------------- failure-policy events --
    def retry(self, job: str, attempt: int, backoff_s: float, why: str):
        """A failed attempt re-admitted under the job's retry budget,
        after ``backoff_s`` of exponential backoff."""
        with self._lock:
            self.retries.append({"job": job, "attempt": int(attempt),
                                 "backoff_s": float(backoff_s),
                                 "why": why})

    def quarantine(self, job: str, why: str):
        """A job exhausted its retry budget and was dead-lettered: the
        farm completes the rest and reports it instead of raising."""
        with self._lock:
            self.quarantined.append({"job": job, "why": why})

    def certify(self, job: str, findings, ok: bool = True):
        """ZP-Cert admission-gate verdict for ``job``: ``ok=False`` means
        error-severity findings dead-lettered it unrun; ``ok=True`` with
        findings records warnings that did not gate."""
        with self._lock:
            self.certifications.append({
                "job": job, "ok": bool(ok),
                "rules": sorted({f.rule for f in findings}),
                "findings": [f.as_dict() for f in findings]})

    def breaker(self, slot: str, event: str, detail: str = ""):
        """Circuit-breaker transition on ``slot``: ``trip`` (benched after
        too many failures in the scoring window), ``probe`` (canary
        dispatched), ``canary_pass``/``canary_fail``, ``readmit``."""
        with self._lock:
            self.breaker_events.append({"slot": slot, "event": event,
                                        "detail": detail})
            if event == "trip":
                self.breaker_trips[slot] += 1

    def fallback(self, slot: str, job: str, want_step: int, got_step,
                 why: str):
        """Snapshot integrity fallback: the restore at ``want_step`` hit a
        corrupt/partial snapshot and landed on ``got_step`` (``None`` =
        no verifiable snapshot — window-0 replay)."""
        with self._lock:
            self.fallbacks.append({
                "slot": slot, "job": job, "want_step": int(want_step),
                "got_step": None if got_step is None else int(got_step),
                "why": why})

    def fault(self, point: str, kind: str, job: str = "", slot: str = "",
              event: str = "injected"):
        """Fault-recovery log entry: the chaos harness records each
        injection (``event="injected"``); the recovery paths record what
        absorbed it (``event="recovered"`` with the policy applied)."""
        with self._lock:
            self.faults.append({"point": point, "kind": kind, "job": job,
                                "slot": slot, "event": event})

    def recovery(self, job: str, window: int = 0, step=None,
                 delivered: int = 0, note: str = ""):
        """ZP-Ledger crash recovery: ``job`` was rebuilt from the journal
        after whole-process death and will resume at ``window`` (0 =
        full replay) with windows ``[0, delivered)`` suppressed — the
        dead process already delivered them."""
        with self._lock:
            self.recoveries.append({
                "job": job, "window": int(window),
                "step": None if step is None else int(step),
                "delivered": int(delivered), "note": note})

    # ------------------------------------------------------------ report --
    def report(self) -> dict:
        with self._lock:
            slots = sorted(set(self.windows) | set(self.dispatch_ms)
                           | set(self.lanes_per_dispatch))
            devices = {}
            for slot in slots:
                lanes = self.lanes_per_dispatch.get(slot, [])
                # Fold the slot's host-overhead channel SUMS into a stall
                # stack: the solo loop's Profiler attribution, rebuilt
                # farm-side from the slot thread's own timestamps.
                stack = StallStack(seconds={
                    "queue": sum(self.queue_wait_ms.get(slot, [])),
                    "dispatch": sum(self.dispatch_ms.get(slot, [])),
                    "drain": sum(self.drain_wall_ms.get(slot, [])),
                    "idle": sum(self.idle_ms.get(slot, [])),
                })
                has_stall = any(v > 0 for v in stack.seconds.values())
                devices[slot] = {
                    "windows": self.windows.get(slot, 0),
                    "lanes_per_dispatch": _stats([float(x) for x in lanes]),
                    "window_ms": _stats(self.window_ms.get(slot, [])),
                    "dispatch_ms": _stats(self.dispatch_ms.get(slot, [])),
                    "drain_ms": _stats(self.drain_wall_ms.get(slot, [])),
                    "queue_wait_ms": _stats(
                        self.queue_wait_ms.get(slot, [])),
                    "idle_ms": _stats(self.idle_ms.get(slot, [])),
                    "queue_depth_max": max(
                        self.queue_depth.get(slot, []), default=0),
                    "drain_vetoes": self.vetoes.get(slot, 0),
                    "stall_ms": dict(stack.seconds),
                    "dominant_stall": (stack.dominant() if has_stall
                                       else None),
                }
            occ = list(self.occupancy_samples)
            lane_vetoes = [dict(v) for v in self.lane_vetoes]
            all_lanes = [x for xs in self.lanes_per_dispatch.values()
                         for x in xs]
            evs = list(self.evictions)
            resumes = [dict(r) for r in self.resumes]
            vetoes = sum(self.vetoes.values())
            retries = [dict(r) for r in self.retries]
            quarantined = [dict(q) for q in self.quarantined]
            certifications = [dict(c) for c in self.certifications]
            breaker_events = [dict(b) for b in self.breaker_events]
            fallbacks = [dict(f) for f in self.fallbacks]
            faults = [dict(f) for f in self.faults]
            recoveries = [dict(r) for r in self.recoveries]
            trips = dict(self.breaker_trips)
            dropped = {name: log.dropped for name, log in (
                ("evictions", self.evictions),
                ("lane_vetoes", self.lane_vetoes),
                ("resumes", self.resumes),
                ("occupancy", self.occupancy_samples),
                ("retries", self.retries),
                ("quarantined", self.quarantined),
                ("certifications", self.certifications),
                ("breaker_events", self.breaker_events),
                ("fallbacks", self.fallbacks),
                ("faults", self.faults),
                ("recoveries", self.recoveries),
                ("scope_samples", self.scope_samples)) if log.dropped}
            scope = self._scope_report_locked()
        return {
            "devices": devices,
            "occupancy_mean": (sum(a / t for a, t in occ if t) / len(occ)
                               if occ else 0.0),
            "occupancy_peak": max((a for a, _ in occ), default=0),
            "slots": max((t for _, t in occ), default=0),
            "drain_vetoes": vetoes,
            "lane_vetoes": lane_vetoes,
            "lanes_per_dispatch_mean": (sum(all_lanes) / len(all_lanes)
                                        if all_lanes else 0.0),
            "lanes_per_dispatch_max": max(all_lanes, default=0),
            "evictions": [{"slot": s, "job": j, "why": w}
                          for s, j, w in evs],
            "resumes": resumes,
            "retries": retries,
            "quarantined": quarantined,
            "certifications": certifications,
            "breaker_trips": trips,
            "breaker_events": breaker_events,
            "fallbacks": fallbacks,
            "faults": faults,
            "recoveries": recoveries,
            "scope": scope,
            "events_dropped": dropped,
        }

    def summary(self) -> str:
        r = self.report()
        lines = [f"farm: {r['slots']} slots, "
                 f"occupancy mean {r['occupancy_mean']:.2f} "
                 f"peak {r['occupancy_peak']}, "
                 f"{r['drain_vetoes']} drain vetoes, "
                 f"{len(r['evictions'])} evictions, "
                 f"{len(r['resumes'])} snapshot resumes"]
        if r["lanes_per_dispatch_max"] > 1:
            lines.append(
                f"  lanes: {r['lanes_per_dispatch_mean']:.1f}/dispatch "
                f"mean, {r['lanes_per_dispatch_max']} max, "
                f"{len(r['lane_vetoes'])} lane vetoes")
        policy = []
        if r["retries"]:
            policy.append(f"{len(r['retries'])} retries")
        if r["quarantined"]:
            policy.append(f"{len(r['quarantined'])} quarantined")
        if r["certifications"]:
            n_fail = sum(not c["ok"] for c in r["certifications"])
            policy.append(f"{n_fail} certify-failed of "
                          f"{len(r['certifications'])} flagged")
        if r["breaker_trips"]:
            policy.append(
                f"{sum(r['breaker_trips'].values())} breaker trips")
        if r["fallbacks"]:
            policy.append(f"{len(r['fallbacks'])} snapshot fallbacks")
        if r["recoveries"]:
            policy.append(f"{len(r['recoveries'])} crash-recovered")
        if r["faults"]:
            n_inj = sum(f["event"] == "injected" for f in r["faults"])
            policy.append(f"{n_inj} faults injected")
        if policy:
            lines.append("  policy: " + ", ".join(policy))
        sc = r["scope"]
        if sc["samples"]:
            lines.append(
                f"  scope: {sc['samples']} samples over "
                f"{len(sc['jobs'])} jobs, "
                f"{sc['quiet_samples']} quiet intervals excluded")
        if r["events_dropped"]:
            lines.append("  dropped: " + ", ".join(
                f"{k} {v}" for k, v in r["events_dropped"].items()))
        for slot, d in r["devices"].items():
            w = d["window_ms"]
            line = f"  {slot}: {d['windows']} windows"
            if w["n"]:
                line += (f", drain p50 {w['p50']:.1f}ms "
                         f"p99 {w['p99']:.1f}ms max {w['max']:.1f}ms")
            host = []
            for label, ch in (("queue", "queue_wait_ms"),
                              ("dispatch", "dispatch_ms"),
                              ("drain", "drain_ms"),
                              ("idle", "idle_ms")):
                st = d[ch]
                if st["n"]:
                    host.append(f"{label} {st['p50']:.1f}ms")
            if host:
                line += " | host: " + " ".join(host)
            if d["dominant_stall"]:
                tot = sum(d["stall_ms"].values()) or 1.0
                dom = d["dominant_stall"]
                line += (f" | stall: {dom} "
                         f"{d['stall_ms'][dom] / tot:.0%}")
            lines.append(line)
        return "\n".join(lines)
