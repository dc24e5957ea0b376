"""The port's ZP-Ledger (``repro_torch.farm.ledger``, the manager's ledger
mode and ``FarmManager.recover``) on the CPU, mirroring the reference's
``tests/test_farm_ledger.py``: the WAL format (crc-framed records,
numpy scalars, torn-tail truncation, a fuzz over every byte boundary and
a bit flip of the last record, compaction), ``choose_resume``, the
registry's round trip over every smoke arch, dead letters, the backoff
rebase, exactly-once delivery across two manager lifetimes, the torn
``deliver`` edge, ledger on and off bit-identical, the checkpoint save's
host copies and the CLI's signal drain; the kill-restart gate in a
subprocess (``--killrestart-smoke --device cpu``, one case a mode).

Against the JAX package (``repro.farm.ledger``, ``repro.farm.manager``,
``repro.launch.farm``): a journal written by either package, torn tail
and bit flip included, replays under the other to the same
``LedgerState`` and is byte for byte what the other writes;
``choose_resume`` agrees on a seeded grid; and a toy campaign cut
mid-stream and recovered in each package delivers the same per-window
outputs (f32, rtol 1e-6: the boards' outputs are exact products, so
they agree to the bit).

Every farm here runs on ``device="cpu"``.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.core import DrainBarrier  # noqa: E402
from repro_torch.farm import (FarmLedger, FarmManager, JobSpec,  # noqa: E402
                              LedgerState, choose_resume, register)
from repro_torch.launch import farm as cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT_RTOL = 1e-6         # the port's window outputs against the reference's


# ----------------------------------------------------------- toy factory --
#: tag -> [(board, window, value)] — module-global so the sink survives a
#: job's reconstruction from its JobSpec (recovery builds a NEW closure,
#: but it appends to the same list)
DELIVERED: dict = {}


def _stack(items):
    return torch.as_tensor(np.stack(items))


def _nb(state, boundary):
    pass


@register("test_torch.ledger_board")
def _test_board(board="b", tag="t", scale=2.0, n_windows=8, delay=0.0):
    import time

    def engine(state, shell, stack):
        if delay:
            time.sleep(delay)
        return state + stack.sum(), shell, stack * float(scale)

    def sink(plan, records, ys):
        DELIVERED.setdefault(tag, []).append(
            (board, plan.index, float(ys[0])))

    return dict(engine=engine,
                windows=[[np.float32(w)] for w in range(int(n_windows))],
                state=torch.tensor(0.0), shell={},
                stack_fn=_stack, on_drain=sink,
                barriers=(DrainBarrier(every=1, action=_nb),))


def _spec(name, tag, tmp_path, n_windows=8, delay=0.004, scale=2.0):
    return JobSpec(
        name=name, factory="test_torch.ledger_board",
        kwargs={"board": name, "tag": tag, "scale": scale,
                "n_windows": n_windows, "delay": delay},
        snapshot_dir=str(tmp_path / "snaps" / name),
        snapshot_keep=4, max_requeues=3)


def _farm(**kw):
    kw.setdefault("device", "cpu")
    return FarmManager(**kw)


def _recover(path, **kw):
    kw.setdefault("device", "cpu")
    return FarmManager.recover(FarmLedger(str(path)), **kw)


# =========================================================== WAL format ==
def test_append_replay_round_trip(tmp_path):
    led = FarmLedger(str(tmp_path))
    led.append("submit", job="a", spec=None)
    led.append("admit", job="a", slot="cpu:0", attempt=1)
    led.append("commit", job="a", slot="cpu:0", step=2, window=2)
    led.append("deliver", job="a", upto=2)
    led.append("done", job="a", windows=4)
    led.close()

    led2 = FarmLedger(str(tmp_path))
    assert led2.dropped_records == 0 and led2.dropped_bytes == 0
    assert [r["seq"] for r in led2.records()] == [0, 1, 2, 3, 4]
    st = led2.replay()
    j = st.jobs["a"]
    assert j.status == "done" and j.windows == 4
    assert j.commits == [[2, 2]] and j.delivered == 2 and j.attempts == 1
    # appends continue the seq after reopen
    assert led2.append("interrupted", job="a")["seq"] == 5
    led2.close()


def test_numpy_scalars_journal_as_plain_json(tmp_path):
    led = FarmLedger(str(tmp_path))
    led.append("commit", job="a", slot="s", step=np.int64(3),
               window=np.int32(3))
    led.close()
    with open(os.path.join(str(tmp_path), "journal.jsonl"), "rb") as f:
        payload = f.read().split(b" ", 1)[1]
    rec = json.loads(payload)
    assert rec["step"] == 3 and rec["window"] == 3


def test_torn_tail_truncated_in_place(tmp_path):
    led = FarmLedger(str(tmp_path))
    led.append("submit", job="a", spec=None)
    led.append("deliver", job="a", upto=3)
    led.close()
    path = os.path.join(str(tmp_path), "journal.jsonl")
    good = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"00000000 {\"kind\":\"deliver\",\"job\":\"a\",\"upto")

    led2 = FarmLedger(str(tmp_path))
    assert led2.dropped_records == 1
    assert led2.dropped_bytes > 0
    assert led2.replay().jobs["a"].delivered == 3
    led2.close()
    assert os.path.getsize(path) == good     # tail physically truncated


def _journal_bytes(tmp_path, name, records):
    d = tmp_path / name
    led = FarmLedger(str(d))
    for kind, fields in records:
        led.append(kind, **fields)
    led.close()
    return open(os.path.join(str(d), "journal.jsonl"), "rb").read()


def test_fuzz_every_byte_boundary_of_last_record(tmp_path):
    """Cutting the journal at EVERY byte offset inside the last record
    must never raise, never advance the delivered cursor past the full
    journal's, and report exactly what was dropped."""
    raw = _journal_bytes(tmp_path, "src", [
        ("submit", {"job": "a", "spec": None}),
        ("commit", {"job": "a", "slot": "s", "step": 1, "window": 1}),
        ("deliver", {"job": "a", "upto": 1}),
        ("deliver", {"job": "a", "upto": 4})])
    last_start = raw.rstrip(b"\n").rfind(b"\n") + 1

    for cut in range(last_start, len(raw) + 1):
        d = tmp_path / f"cut{cut}"
        os.makedirs(str(d))
        with open(os.path.join(str(d), "journal.jsonl"), "wb") as f:
            f.write(raw[:cut])
        led2 = FarmLedger(str(d))
        st = led2.replay()
        led2.close()
        if cut == len(raw):                 # intact journal
            assert led2.dropped_records == 0 and led2.dropped_bytes == 0
            assert st.jobs["a"].delivered == 4
        else:
            whole_tail = cut == last_start
            assert led2.dropped_records == (0 if whole_tail else 1)
            assert led2.dropped_bytes == cut - last_start
            assert st.jobs["a"].delivered == 1      # never past the drop
            assert st.jobs["a"].commits == [[1, 1]]


def test_fuzz_bit_flip_in_last_record_drops_only_it(tmp_path):
    raw = _journal_bytes(tmp_path, "src", [
        ("submit", {"job": "a", "spec": None}),
        ("deliver", {"job": "a", "upto": 2}),
        ("deliver", {"job": "a", "upto": 5})])
    last_start = raw.rstrip(b"\n").rfind(b"\n") + 1

    for i in range(last_start, len(raw)):
        flipped = bytearray(raw)
        flipped[i] ^= 0x40
        d = tmp_path / f"flip{i}"
        os.makedirs(str(d))
        with open(os.path.join(str(d), "journal.jsonl"), "wb") as f:
            f.write(bytes(flipped))
        led2 = FarmLedger(str(d))
        st = led2.replay()
        led2.close()
        # crc32 catches every single-bit/short-burst corruption: the
        # flipped record is dropped, the cursor stays at the prior record
        assert st.jobs["a"].delivered == 2, f"flip at byte {i}"
        assert st.records == 2


def test_compaction_preserves_replay_state(tmp_path):
    led = FarmLedger(str(tmp_path))
    led.append("submit", job="a", spec={"name": "a", "factory": "f"})
    for w in range(1, 13):
        led.append("commit", job="a", slot="s", step=w, window=w)
    led.append("deliver", job="a", upto=10)
    led.append("requeue", job="a", attempt=1, backoff_s=2.5, why="x")
    before = led.replay().jobs["a"]
    led.compact(keep_commits=8)
    after = led.replay().jobs["a"]
    assert len(led.records()) == 1
    assert after.spec == before.spec
    assert after.delivered == 10 and after.requeues == 1
    assert after.backoff_s == 2.5 and after.status == "queued"
    assert after.commits == before.commits[-8:]
    # the compacted journal is itself a valid crc-framed journal
    assert led.append("admit", job="a", slot="s", attempt=2)["seq"] == 1
    led.close()
    led2 = FarmLedger(str(tmp_path))
    assert led2.replay().jobs["a"].status == "running"
    led2.close()


def test_choose_resume_never_passes_delivered_and_skips_torn():
    commits = [[1, 1], [2, 2], [3, 3], [4, 4]]
    assert choose_resume(commits, delivered=3) == (3, 3)
    assert choose_resume(commits, delivered=99) == (4, 4)
    assert choose_resume(commits, delivered=0) == (0, None)
    # step 3 is torn: fall back to the older verifiable commit
    assert choose_resume(commits, 3, verify=lambda s: s != 3) == (2, 2)

    # a verifier that raises means unverifiable, not an error
    def boom(step):
        raise IOError("disk gone")
    assert choose_resume(commits, 3, verify=boom) == (0, None)


# ============================================================= registry ==
def test_jobspec_round_trips_for_every_smoke_arch():
    for arch in ARCH_IDS:
        spec = cli.train_board_spec(arch, steps=4, interval=2)
        d = json.loads(json.dumps(spec.to_json()))
        assert JobSpec.from_json(d) == spec


def test_submit_without_spec_dead_letters_on_recovery(tmp_path):
    led = FarmLedger(str(tmp_path))
    led.append("submit", job="ghost", spec=None)
    led.close()
    mgr = _recover(tmp_path, slots=1)
    ghost = next(j for j in mgr.jobs if j.name == "ghost")
    assert ghost.status == "quarantined"
    assert "closures" in ghost.error
    assert mgr.run()["quarantined"] == ["ghost"]     # not raised
    mgr.ledger.close()


def test_unbuildable_spec_dead_letters_with_reason(tmp_path):
    led = FarmLedger(str(tmp_path))
    led.append("submit", job="bad",
               spec={"name": "bad", "factory": "no.such.factory"})
    led.close()
    mgr = _recover(tmp_path, slots=1)
    bad = next(j for j in mgr.jobs if j.name == "bad")
    assert bad.status == "quarantined"
    assert "rebuild failed" in bad.error
    mgr.ledger.close()
    # the dead letter is journaled: a second recovery sees it terminal
    st = FarmLedger(str(tmp_path)).replay()
    assert st.jobs["bad"].status == "quarantined"


def test_recover_rebases_relative_backoff_onto_fresh_clock(tmp_path):
    spec = _spec("slow", "unused-backoff", tmp_path)
    led = FarmLedger(str(tmp_path))
    led.append("submit", job="slow", spec=spec.to_json())
    led.append("requeue", job="slow", attempt=1, backoff_s=7.5, why="x")
    led.close()
    mgr = _recover(tmp_path, slots=1, clock=lambda: 1000.0)
    job = next(j for j in mgr.jobs if j.name == "slow")
    # the dead process's absolute deadline is meaningless here: the
    # RELATIVE journal value lands on the recovering clock's origin
    assert job.not_before == pytest.approx(1007.5)
    assert job.requeues == 1
    mgr.ledger.close()


# ===================================================== crash recovery ==
def _cut_mid_stream(mgr, at_window=3):
    """Make every job request a graceful farm stop once its stream passes
    ``at_window`` — the in-process stand-in for process death that still
    exercises journal-seeded resume + delivered-window suppression."""
    for job in mgr.jobs:
        def cut(plan, records, ys, _m=mgr):
            if plan.index >= at_window:
                _m.request_shutdown()
        job.verify = cut


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_recover_finishes_campaign_exactly_once_across_lifetimes(
        tmp_path, mode):
    tag = f"xonce-{mode}"
    DELIVERED[tag] = []
    n = 8
    mgr = _farm(slots=2, mode=mode, evict_stragglers=False, poll_s=0.01,
                ledger=FarmLedger(str(tmp_path)))
    for i in range(2):
        mgr.submit_spec(_spec(f"b{i}", tag, tmp_path, n_windows=n,
                              scale=float(i + 1)))
    _cut_mid_stream(mgr)
    rep1 = mgr.run(strict=False)
    mgr.ledger.close()
    assert rep1["interrupted"]
    phase1 = {b: [w for bb, w, _ in DELIVERED[tag] if bb == b]
              for b in ("b0", "b1")}
    assert any(phase1.values())          # delivery was already in flight

    mgr2 = _recover(tmp_path, slots=2, mode=mode, evict_stragglers=False,
                    poll_s=0.01)
    rep2 = mgr2.run(strict=False)
    mgr2.ledger.close()
    assert all(j["status"] == "done" for j in rep2["jobs"].values())
    rec = rep2["telemetry"]["recoveries"]
    assert {r["job"] for r in rec} == {"b0", "b1"}
    assert any(r["window"] > 0 for r in rec)    # genuine mid-stream resume
    for b in ("b0", "b1"):
        got = [w for bb, w, _ in DELIVERED[tag] if bb == b]
        # every window exactly once ACROSS both manager lifetimes, and
        # each lifetime's deliveries stay in window order
        assert sorted(got) == list(range(n))
        assert len(got) == len(set(got))
        assert got[:len(phase1[b])] == phase1[b]
        assert rep2["jobs"][b]["windows_delivered"] == n
    # the journal agrees, and the recovered run replayed less than the
    # campaign committed
    led = FarmLedger(str(tmp_path))
    fin = led.replay()
    led.close()
    assert all(fin.jobs[b].delivered == n for b in ("b0", "b1"))
    total_replayed = sum(j["windows_replayed"]
                         for j in rep2["jobs"].values())
    total_committed = sum(max((c[1] for c in fin.jobs[b].commits),
                              default=0) for b in ("b0", "b1"))
    assert 0 <= total_replayed < total_committed


def test_torn_deliver_record_redelivers_only_its_own_windows(tmp_path):
    """The WAL's one honest edge: a crash BETWEEN the sink call and its
    ``deliver`` record re-delivers exactly that batch's windows once —
    nothing before the surviving cursor, nothing else twice."""
    tag = "torn-deliver"
    DELIVERED[tag] = []
    n = 8
    mgr = _farm(slots=1, mode="lockstep", evict_stragglers=False,
                ledger=FarmLedger(str(tmp_path)))
    mgr.submit_spec(_spec("b0", tag, tmp_path, n_windows=n))
    _cut_mid_stream(mgr, at_window=4)
    mgr.run(strict=False)
    mgr.ledger.close()
    phase1 = [w for _, w, _ in DELIVERED[tag]]

    # tear the LAST deliver record out of the journal: the sink already
    # ran for its windows, but the cursor on disk never advanced
    path = os.path.join(str(tmp_path), "journal.jsonl")
    lines = open(path, "rb").read().splitlines(keepends=True)
    delivers = [(i, json.loads(ln.split(b" ", 1)[1]))
                for i, ln in enumerate(lines)
                if json.loads(ln.split(b" ", 1)[1])["kind"] == "deliver"]
    assert len(delivers) >= 2, "pacing produced too few deliver batches"
    torn_i, torn = delivers[-1]
    prev_upto = delivers[-2][1]["upto"]
    assert phase1 == list(range(torn["upto"]))
    with open(path, "wb") as f:
        f.writelines(ln for i, ln in enumerate(lines) if i != torn_i)

    mgr2 = _recover(tmp_path, slots=1, mode="lockstep",
                    evict_stragglers=False)
    rep2 = mgr2.run(strict=False)
    mgr2.ledger.close()
    assert rep2["jobs"]["b0"]["status"] == "done"
    counts = Counter(w for _, w, _ in DELIVERED[tag])
    dup = set(range(prev_upto, torn["upto"]))
    assert {w for w, c in counts.items() if c == 2} == dup
    assert all(c <= 2 for c in counts.values())
    assert set(counts) == set(range(n))
    # and the re-delivered values are bit-identical to the originals
    by_window = {}
    for _, w, v in DELIVERED[tag]:
        by_window.setdefault(w, []).append(v)
    assert all(len(set(vs)) == 1 for vs in by_window.values())


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_ledger_on_delivery_bit_identical_to_ledger_off(tmp_path, mode):
    """Attaching a ledger switches delivery to incremental-at-commit; the
    delivered stream (order AND values) must not change."""
    n = 6
    tag_off, tag_on = f"id-off-{mode}", f"id-on-{mode}"
    for tag, ledger in ((tag_off, None),
                        (tag_on, FarmLedger(str(tmp_path)))):
        DELIVERED[tag] = []
        mgr = _farm(slots=2, mode=mode, evict_stragglers=False,
                    poll_s=0.01, ledger=ledger)
        for i in range(2):
            mgr.submit_spec(_spec(f"b{i}", tag, tmp_path / tag,
                                  n_windows=n, delay=0.0,
                                  scale=float(i + 1)))
        mgr.run()
        if ledger is not None:
            ledger.close()
    for b in ("b0", "b1"):
        off = [(w, v) for bb, w, v in DELIVERED[tag_off] if bb == b]
        on = [(w, v) for bb, w, v in DELIVERED[tag_on] if bb == b]
        assert off == on


# ========================================================== satellites ==
def test_checkpoint_save_is_immune_to_caller_mutation(tmp_path):
    """``save`` must force host COPIES: a caller updating its state in
    place right after save() must not tear the bytes the background
    thread is still writing."""
    cm = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(16, dtype=torch.float32),
             "b": torch.ones(4, dtype=torch.float32)}
    want = {k: v.clone() for k, v in state.items()}
    cm.save(state, step=1, blocking=False)      # async write in flight
    state["w"] += 100.0                         # caller mutates in place
    state["b"][:] = -1.0
    cm.wait()
    tree, landed = cm.restore(want, step=1)
    assert landed == 1
    assert torch.equal(tree["w"], want["w"])
    assert torch.equal(tree["b"], want["b"])
    assert cm.verify(1)


def test_signal_drain_sigterm_drains_and_reports_143():
    calls = []

    class Mgr:
        def request_shutdown(self):
            calls.append("shutdown")

    drainer = cli._SignalDrain(Mgr()).install()
    try:
        signal.raise_signal(signal.SIGTERM)
        assert calls == ["shutdown"]
        assert drainer.exit_code == 128 + int(signal.SIGTERM)  # 143
    finally:
        drainer.restore()
    # handlers restored: SIGTERM is back to its previous disposition
    assert signal.getsignal(signal.SIGTERM) != drainer._handle


def test_signal_drain_second_sigint_raises_keyboard_interrupt():
    calls = []

    class Mgr:
        def request_shutdown(self):
            calls.append("shutdown")

    drainer = cli._SignalDrain(Mgr()).install()
    try:
        signal.raise_signal(signal.SIGINT)
        assert drainer.exit_code == 130 and calls == ["shutdown"]
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)
    finally:
        drainer.restore()


# ======================================================= kill-restart ==
@pytest.mark.parametrize("mode", ["async", "lockstep"])
def test_killrestart_smoke_in_a_subprocess(mode):
    """The CLI's whole-process gate on the host: the victim subprocess
    dies by SIGKILL at a journaled commit, the ``--recover`` subprocess
    finishes the campaign, delivery is exactly once across both, and the
    window files equal the oracle's byte for byte."""
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.farm",
         "--killrestart-smoke", f"--{mode}", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, (done.stdout[-3000:], done.stderr[-2000:])
    out = json.loads(done.stdout)
    assert out["ok"] and out["problems"] == []
    assert out["victim_returncode"] == -signal.SIGKILL
    assert sum(out["pre_delivered"].values()) > 0
    assert any(r["window"] > 0 for r in out["recovered"]["recoveries"])
    # the kill lands at the reference's 8th commit, and the delivered
    # cursors trail the journaled commits by what was still in flight
    assert out["kill_after"] == 8
    assert sum(out["pre_commits"].values()) >= 8
    assert out["delivery_lag"] == {
        n: out["pre_commits"][n] - d for n, d in out["pre_delivered"].items()}
    assert min(out["delivery_lag"].values()) >= 0


def test_process_kill_sigkills_the_farm_at_the_chosen_commit(tmp_path):
    """``--ledger DIR --kill-after-commits N``: the process dies by
    SIGKILL right after its N-th commit record is on disk, and the
    journal holds exactly N commits."""
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.farm", "--ledger",
         str(tmp_path), "--kill-after-commits", "5", "--device", "cpu",
         "--ledger-boards", "2", "--ledger-windows", "8"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert done.returncode == -signal.SIGKILL, done.stderr[-2000:]
    st = FarmLedger(str(tmp_path)).replay()
    assert sum(len(j.commits) for j in st.jobs.values()) == 5


# ===================================================== vs the reference ==
@pytest.fixture(scope="module")
def jled():
    """The reference's ledger, farm manager and farm CLI."""
    pytest.importorskip("jax")
    from test_torch_ssm import import_reference
    ledger, manager, cli_ref = import_reference(
        "repro.farm.ledger", "repro.farm.manager", "repro.launch.farm")
    return dict(ledger=ledger, manager=manager, cli=cli_ref)


_RECORDS = [
    ("submit", {"job": "a", "spec": {"name": "a", "factory": "f",
                                     "kwargs": {"n": 3}}}),
    ("submit", {"job": "b", "spec": None}),
    ("admit", {"job": "a", "slot": "cpu:0#0", "attempt": 1}),
    ("commit", {"job": "a", "slot": "cpu:0#0", "step": np.int64(2),
                "window": np.int32(1)}),
    ("deliver", {"job": "a", "upto": 1}),
    ("requeue", {"job": "a", "attempt": 1, "backoff_s": 0.25,
                 "why": "evicted: straggler"}),
    ("admit", {"job": "b", "slot": "cpu:0#1", "attempt": 1}),
    ("quarantine", {"job": "b", "why": "budget spent"}),
    ("commit", {"job": "a", "slot": "cpu:0#1", "step": 4, "window": 2}),
    ("deliver", {"job": "a", "upto": 2}),
    ("done", {"job": "a", "windows": 3}),
]


def _state_dict(st):
    return {"records": st.records,
            "jobs": {n: dataclasses.asdict(j) for n, j in st.jobs.items()}}


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("damage", ["none", "torn", "flip"])
def test_journal_replays_alike_under_both_packages(jled, tmp_path, writer,
                                                   damage):
    """A journal written by one package (a torn last record, or a bit
    flipped in it) replays under the other to the same state with the
    same dropped counts, and both write the same bytes."""
    classes = {"reference": jled["ledger"].FarmLedger, "port": FarmLedger}
    raw = {}
    for name, cls in classes.items():
        led = cls(str(tmp_path / name))
        for kind, fields in _RECORDS:
            led.append(kind, **fields)
        led.close()
        raw[name] = (tmp_path / name / "journal.jsonl").read_bytes()
    assert raw["reference"] == raw["port"]
    data = raw[writer]
    last = data.rstrip(b"\n").rfind(b"\n") + 1
    if damage == "torn":
        data = data[:last + (len(data) - last) // 2]
    elif damage == "flip":
        data = bytearray(data)
        data[last + 20] ^= 0x08
        data = bytes(data)
    states = {}
    for name, cls in classes.items():
        d = tmp_path / f"read-{name}"
        d.mkdir()
        (d / "journal.jsonl").write_bytes(data)
        led = cls(str(d))
        states[name] = (_state_dict(led.replay()), led.dropped_records,
                        led.dropped_bytes)
        led.close()
        assert (d / "journal.jsonl").read_bytes() == \
            (data if damage == "none" else data[:last])
    assert states["port"] == states["reference"]
    st, dropped, _ = states["port"]
    assert dropped == (0 if damage == "none" else 1)
    assert st["jobs"]["a"]["status"] == ("done" if damage == "none"
                                         else "queued")
    assert isinstance(FarmLedger(str(tmp_path / "read-port")).replay(),
                      LedgerState)


def test_choose_resume_agrees_with_the_reference(jled):
    rng = np.random.default_rng(0)
    ref = jled["ledger"].choose_resume
    for _ in range(300):
        n = int(rng.integers(0, 8))
        windows = sorted(rng.choice(np.arange(1, 12), size=n, replace=False))
        commits = [[int(w) * 2 + int(rng.integers(0, 2)), int(w)]
                   for w in windows]
        rng.shuffle(commits)
        delivered = int(rng.integers(0, 13))
        torn = set(int(c[0]) for c in commits if rng.random() < 0.3)

        def verify(step, torn=torn):
            return step not in torn
        for v in (None, verify):
            assert choose_resume(commits, delivered, v) == \
                ref(commits, delivered, v)


def _campaign(mgr_cls, ledger_cls, spec_fn, ledger_dir, mode, **kw):
    """Submit two toy boards to a ledger farm, cut it mid-stream, then
    recover it from the journal in a second manager: both lifetimes of a
    campaign in one process."""
    mgr = mgr_cls(slots=2, mode=mode, evict_stragglers=False, poll_s=0.01,
                  ledger=ledger_cls(ledger_dir), **kw)
    for i in range(2):
        mgr.submit_spec(spec_fn(f"board{i}", float(i + 1), 8, ledger_dir))
    _cut_mid_stream(mgr, at_window=3)
    assert mgr.run(strict=False)["interrupted"]
    mgr.ledger.close()
    mgr2 = mgr_cls.recover(ledger_cls(ledger_dir), slots=2, mode=mode,
                           evict_stragglers=False, poll_s=0.01, **kw)
    rep = mgr2.run(strict=False)
    mgr2.ledger.close()
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    assert any(r["window"] > 0 for r in rep["telemetry"]["recoveries"])
    return {fn: json.loads(b) for fn, b in
            cli._read_window_files(os.path.join(ledger_dir,
                                                "outputs")).items()}


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_recovered_campaign_matches_the_reference(jled, tmp_path, mode):
    """The same toy campaign (the CLI's ``zp.ledger_board``, 2 boards of
    8 windows) cut mid-stream and recovered in each package: the same
    window files, every output within OUT_RTOL (f32) of the
    reference's."""
    ref = _campaign(jled["manager"].FarmManager, jled["ledger"].FarmLedger,
                    jled["cli"].ledger_board_spec, str(tmp_path / "ref"),
                    mode)
    port = _campaign(FarmManager, FarmLedger, cli.ledger_board_spec,
                     str(tmp_path / "port"), mode, device="cpu")
    assert sorted(port) == sorted(ref) and len(port) == 16
    for fn, rec in ref.items():
        assert port[fn]["window"] == rec["window"]
        np.testing.assert_allclose(np.float32(port[fn]["y"]),
                                   np.float32(rec["y"]), rtol=OUT_RTOL,
                                   atol=0)
