"""ZP-Ledger: the farm's durable write-ahead journal.

The FarmManager process is the farm's last single point of loss: boards
already survive eviction, veto, and crash (checkpointed requeue), but a
SIGKILL/OOM/power-cut of the *manager* discards the queue, the delivery
cursors, and every in-flight job even though verified snapshots sit on
disk. The ledger closes that gap the way every durable queue does — an
append-only journal of control-plane decisions, written BEFORE they are
acted on where it matters, replayed at startup to rebuild the farm's
state (``FarmManager.recover``).

Journal format — one record per line in ``<dir>/journal.jsonl``::

    crc32hex SP canonical-json NL

``canonical-json`` is ``json.dumps(record, sort_keys=True,
separators=(",", ":"))`` and the crc32 covers exactly those payload
bytes, so every record self-validates: a torn final write (the expected
crash artifact) or a bit flip fails its checksum and marks the start of
the DROPPED TAIL — everything from the first bad record on is truncated
at open (crc32 catches all single-bit and short-burst corruptions).
Appends are flushed and fsync'd under a lock before returning, so a
record the manager acted on is on disk first.

Record kinds (unknown kinds are ignored on replay — forward compat)::

    submit      {job, spec}           spec = JobSpec.to_json() or null
    admit       {job, slot, attempt}  backoff was consumed at admission
    commit      {job, slot, step, window}   accepted barrier snapshot
    deliver     {job, upto}           on_drain CURSOR: windows [0, upto)
                                      handed to the sink (one record per
                                      delivery batch, not per window —
                                      bounds fsync cost)
    evict       {job, slot, why}      informational (requeue carries state)
    requeue     {job, attempt, backoff_s, why}   backoff_s is RELATIVE —
                                      rebased onto the recovering
                                      process's own clock
    quarantine  {job, why}            dead-lettered
    certify_fail {job, why, rules}    ZP-Cert rejected the board at
                                      submit — dead-lettered unrun
    failed      {job, why}
    done        {job, windows}        full stream delivered
    interrupted {job}                 graceful stop; resumable
    recover     {job, window, delivered}   a recovery resumed here
    compact     per-job summary rewritten by :meth:`FarmLedger.compact`

Recovery contract (see ``FarmManager.recover``): the journal is the
source of truth for WHAT was delivered (the ``deliver`` cursor ``D``);
the checkpoint store is the source of truth for restorable STATE. The
resume point is the newest store-verifiable commit with ``window <= D``
— never past ``D``, or suppressed windows would be lost; never an
unverifiable snapshot, or a torn write would poison the resume. The one
honest WAL edge: a window whose ``deliver`` record was itself torn by
the crash may be re-delivered once — sinks that must be exactly-once
across a crash *inside the delivery window* should be idempotent keyed
on ``plan.index`` (the toy ledger board publishes atomic per-window
files, so re-delivery rewrites identical bytes).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.annotations import exclusive, locked


def _jsonable(x):
    """json.dumps default hook: journal fields may carry numpy scalars
    (steps, windows) — everything else non-JSON is a caller bug."""
    import numpy as np
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    raise TypeError(f"ledger field not JSON-serializable: {type(x)!r}")


def _parse_line(line: bytes) -> Optional[dict]:
    """One journal line -> record dict, or ``None`` if torn/corrupt
    (bad frame, failed crc, invalid JSON, or not a keyed record)."""
    if len(line) < 10 or line[8:9] != b" ":
        return None
    try:
        want = int(line[:8], 16)
    except ValueError:
        return None
    payload = line[9:]
    if zlib.crc32(payload) != want:
        return None
    try:
        rec = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None
    if not isinstance(rec, dict) or "kind" not in rec:
        return None
    return rec


@dataclasses.dataclass
class JobReplay:
    """One job's state reconstructed from the journal."""
    name: str
    spec: Optional[dict] = None         # JobSpec.to_json(), if serializable
    commits: List[List[int]] = dataclasses.field(default_factory=list)
    # ^ accepted barrier commits as [step, window], journal order
    delivered: int = 0                  # on_drain cursor: [0, delivered)
    attempts: int = 0
    requeues: int = 0
    backoff_s: float = 0.0              # unconsumed RELATIVE backoff
    status: str = "queued"
    error: Optional[str] = None
    windows: Optional[int] = None       # total windows, known once done


@dataclasses.dataclass
class LedgerState:
    """Everything :meth:`FarmLedger.replay` can reconstruct."""
    jobs: Dict[str, JobReplay] = dataclasses.field(default_factory=dict)
    records: int = 0


class FarmLedger:
    """Append-only crc32'd JSONL journal with torn-tail truncation on
    open, fsync'd appends, and a compaction pass. Thread-safe: appends
    arrive from slot threads and the control plane."""

    FILENAME = "journal.jsonl"

    def __init__(self, directory: str, fsync: bool = True):
        self.dir = str(directory)
        self.fsync = fsync
        self.path = os.path.join(self.dir, self.FILENAME)
        self._lock = threading.Lock()
        self._records: List[dict] = []
        self._seq = 0
        self.dropped_records = 0        # torn/corrupt tail, counted at open
        self.dropped_bytes = 0
        os.makedirs(self.dir, exist_ok=True)
        self._open()

    # ------------------------------------------------------------- open --
    @exclusive
    def _open(self):
        """Scan the journal, keep the longest valid prefix, truncate the
        torn tail in place (the crash artifact this format exists for),
        and leave an append handle positioned after the last good
        record."""
        raw = b""
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                raw = f.read()
        good_end = 0
        pos = 0
        self._records = []
        while pos < len(raw):
            nl = raw.find(b"\n", pos)
            if nl < 0:                  # unterminated final line: torn
                break
            rec = _parse_line(raw[pos:nl])
            if rec is None:             # first bad record starts the tail
                break
            self._records.append(rec)
            pos = good_end = nl + 1
        tail = raw[good_end:]
        self.dropped_bytes = len(tail)
        self.dropped_records = sum(
            1 for chunk in tail.split(b"\n") if chunk)
        if tail:
            with open(self.path, "rb+") as f:
                f.truncate(good_end)
                f.flush()
                os.fsync(f.fileno())
        self._f = open(self.path, "ab")
        self._seq = (self._records[-1].get("seq", len(self._records) - 1)
                     + 1) if self._records else 0

    # ----------------------------------------------------------- append --
    def append(self, kind: str, **fields) -> dict:
        """Durably append one record: the call returns only after the
        bytes are flushed (and fsync'd unless ``fsync=False``), so a
        decision the manager acts on is journaled first."""
        rec = dict(fields)
        rec["kind"] = str(kind)
        with self._lock:
            rec["seq"] = self._seq
            payload = json.dumps(rec, sort_keys=True,
                                 separators=(",", ":"),
                                 default=_jsonable).encode("utf-8")
            self._f.write(b"%08x " % zlib.crc32(payload) + payload + b"\n")
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._records.append(rec)
            self._seq += 1
        return rec

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    # ----------------------------------------------------------- replay --
    def replay(self) -> LedgerState:
        with self._lock:
            return self._replay_locked()

    def _replay_locked(self) -> LedgerState:
        state = LedgerState()

        def job(name) -> JobReplay:
            if name not in state.jobs:
                state.jobs[name] = JobReplay(name=str(name))
            return state.jobs[name]

        for rec in self._records:
            kind = rec.get("kind")
            name = rec.get("job")
            if name is None:
                continue
            j = job(name)
            if kind == "submit":
                j.spec = rec.get("spec")
                j.status = "queued"
            elif kind == "admit":
                j.attempts = max(j.attempts, int(rec.get("attempt", 0)))
                j.status = "running"
                j.backoff_s = 0.0       # the gate was consumed at admission
            elif kind == "commit":
                j.commits.append([int(rec["step"]), int(rec["window"])])
            elif kind == "deliver":
                j.delivered = max(j.delivered, int(rec.get("upto", 0)))
            elif kind == "requeue":
                j.requeues = max(j.requeues, int(rec.get("attempt", 0)))
                j.backoff_s = float(rec.get("backoff_s", 0.0))
                j.status = "queued"
            elif kind == "quarantine":
                j.status = "quarantined"
                j.error = rec.get("why")
            elif kind == "certify_fail":
                j.status = "quarantined"
                j.error = rec.get("why")
            elif kind == "failed":
                j.status = "failed"
                j.error = rec.get("why")
            elif kind == "done":
                j.status = "done"
                j.windows = rec.get("windows")
                j.backoff_s = 0.0
            elif kind == "interrupted":
                j.status = "interrupted"
            elif kind == "compact":
                state.jobs[str(name)] = JobReplay(
                    name=str(name), spec=rec.get("spec"),
                    commits=[[int(s), int(w)]
                             for s, w in rec.get("commits", [])],
                    delivered=int(rec.get("delivered", 0)),
                    attempts=int(rec.get("attempts", 0)),
                    requeues=int(rec.get("requeues", 0)),
                    backoff_s=float(rec.get("backoff_s", 0.0)),
                    status=str(rec.get("status", "queued")),
                    error=rec.get("error"),
                    windows=rec.get("windows"))
            # evict / recover / unknown kinds: informational only
            state.records += 1
        return state

    # ---------------------------------------------------------- compact --
    def compact(self, keep_commits: int = 8):
        """Rewrite the journal as one ``compact`` summary record per job
        (atomic: tmp + fsync + rename), bounding journal growth across
        long campaigns. The last ``keep_commits`` commits per job are
        retained so a later recovery can still fall back past a torn
        newest snapshot."""
        with self._lock:
            state = self._replay_locked()
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                for seq, j in enumerate(state.jobs.values()):
                    rec = {"kind": "compact", "job": j.name, "seq": seq,
                           "spec": j.spec,
                           "commits": j.commits[-max(1, keep_commits):],
                           "delivered": j.delivered,
                           "attempts": j.attempts, "requeues": j.requeues,
                           "backoff_s": j.backoff_s, "status": j.status,
                           "error": j.error, "windows": j.windows}
                    payload = json.dumps(rec, sort_keys=True,
                                         separators=(",", ":"),
                                         default=_jsonable).encode("utf-8")
                    f.write(b"%08x " % zlib.crc32(payload) + payload
                            + b"\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)           # the rename itself must be durable
            finally:
                os.close(dfd)
            self._f = open(self.path, "ab")
            self._records = []
            self._seq = 0
            self._open_records_from_disk()

    @locked("_lock")
    def _open_records_from_disk(self):
        """Re-scan after compaction (caller holds the lock)."""
        with open(self.path, "rb") as f:
            raw = f.read()
        pos = 0
        self._records = []
        while pos < len(raw):
            nl = raw.find(b"\n", pos)
            if nl < 0:
                break
            rec = _parse_line(raw[pos:nl])
            if rec is None:
                break
            self._records.append(rec)
            pos = nl + 1
        self._seq = (self._records[-1].get("seq", len(self._records) - 1)
                     + 1) if self._records else 0


def choose_resume(commits: List[List[int]], delivered: int,
                  verify: Optional[Callable[[int], bool]] = None,
                  ) -> Tuple[int, Optional[int]]:
    """Pick the recovery resume point: the newest commit that is (a) at
    or behind the journal's delivered cursor — resuming PAST ``delivered``
    would lose the suppressed windows' outputs forever — and (b)
    verifiable in the job's snapshot store (``verify(step)``; a torn
    newest snapshot rewinds to an older one). Returns ``(window, step)``;
    ``(0, None)`` means full window-0 replay (delivered-window
    suppression still applies)."""
    best: Tuple[int, Optional[int]] = (0, None)
    for step, window in sorted(commits, key=lambda c: (c[1], c[0]),
                               reverse=True):
        if window > delivered:
            continue
        if verify is not None:
            try:
                if not verify(step):
                    continue
            except Exception:       # noqa: BLE001 — unverifiable = torn
                continue
        return int(window), int(step)
    return best
