"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

  python3 chip_smoke.py

Run from the root of a checkout on a machine with a card. Any failure
exits non-zero; no phase is caught. Before each main path (a serve run,
a forward, a Scale-Down check) every kernel's launch count is set to 0,
and after it each count must read what that path launches. Phases:

  1. device  — the card's name, count and SMs, nvidia-smi's name, power
               limit and maximum SM clock, and the nvcc builds of the five
               kernels (one process per source, started together) with
               their time and each instance's registers and spills, and,
               where the toolkit has cuobjdump, the HGMMA (wgmma) and
               UTMALDG (TMA) instructions in K1's library;
  2. kernel  — K2 (decode attention) against its plain version on the
               card: the reference's test grid, glm4-9b's, granite-8b's and
               qwen3-moe-30b-a3b's decode shapes (pos on the edges of the
               split chunks too), softcap 0 and 30, f32 at 2e-5 and bf16
               at 2e-2 (the tolerances of tests/test_kernels.py), and bf16
               also at a normwise relative error of 6e-3; and K2 bitwise
               over two launches and over a CUDA-graph replay;
  3. serve   — the port's serve() on the full glm4-9b config (40 layers,
               bf16, random weights from a seed drawn on the card, kept
               for phases 7 and 8): batch 8, prompt 2048, 64 generated
               tokens, windows of 8. The K2 launch count is set to 0 just
               before and must read exactly 40 x 63 after; every decode
               window's dispatch runs under CUDA sync-debug mode "error",
               so a host sync inside a window fails the run. The decode is
               traced with torch.profiler (device activity only) from
               window 3 to its end: device busy time, span and idle share,
               device operations per step, and the kernels that take the
               most device time;
  4. parity  — the glm4-9b and granite-8b smoke configs in f32 through
               serve() on the card (kernel) and on the host (plain), from
               the same weights: the greedy tokens must be equal;
  5. kernels — K2 timed at the serve shape over launches that cycle
               through 40 distinct layer caches (so the 50 MB L2 does not
               hold the ~17 MB working set), in device time: the 40
               launches captured in one CUDA graph, replayed between CUDA
               events (and, beside it, the eager loop paced by the host);
               with its split plan, its bound, its plain version and
               F.scaled_dot_product_attention timed the same way (timed
               only; the port never calls it), and the same kernel timed
               the same way at the plans of 4 to 16 splits (the split
               sweep, uncounted launches);
  6. k1      — K1 (flash attention) against its plain version on the
               card: the reference's grid and masks, glm4-9b's,
               granite-8b's and qwen3-moe-30b-a3b's forward shapes (B=2,
               S=4096, H=32, K=2, 8 or 4, hd=128, causal) and a ragged
               S=4000 with window 33 and softcap 30, f32 at 2e-5 and bf16
               at 2e-2, and bf16 also at a normwise relative error of
               6e-3;
  7. forward — Model.loss with the commit and coverage taps on the full
               glm4-9b config and phase 3's weights, B=2, S=4096, under
               inference mode: the K1 launch count is set to 0 just before
               and must read exactly 40 after; the taps go through
               make_ingest into the P-Shell and are drained: 40 commit
               rows, none dropped, finite checksums and loss. Wall time
               (synchronised) and peak memory;
  8. scale-down — verify_extraction at layers 0, 20 and 39 of the same
               model on the same batch's activations (bitwise, 41 K1
               launches each), and scanned_vs_unrolled (0.0, 80 launches);
  9. forward parity — the glm4-9b and granite-8b smoke configs in f32
               from seed 0, the loss and each checksum's mean |x| on the
               card (K1) and on the host (plain) from the same weights
               within 1e-5 relative, each checksum's mean within 1e-5 of
               its layer's mean |x| (``testing.check_forward_parity``),
               and every layer's replay bitwise on both;
 10. k1 time — K1 timed at the glm4-9b forward shape over 40 distinct
               q/k/v sets (~2.9 GB, beyond the 50 MB L2), beside its
               bound, its plain version and F.scaled_dot_product_attention
               (timed only).

glm4-9b's weights are then freed and the peak-memory counter reset, so
the falcon-mamba-7b phases report their own peak:

 11. k3      — K3 (selective scan) against its plain version on the card,
               f32, y and h_last at 1e-4 (the tolerance of the reference's
               test_ssm_scan): the reference's grid, a ragged S=4000 with
               Din=8192, B_ and C_ as strided views, and the forward
               (B=2, S=4096) and serve-prefill (B=8, S=2048) shapes;
 12. ssm serve — serve() on the full falcon-mamba-7b config (64 layers,
               bf16, random weights from a seed drawn on the card, kept
               for 14 and 15): batch 8, prompt 2048, 64 generated tokens,
               windows of 8, every window under sync-debug mode "error".
               Exactly 64 K3 launches, all in the prefill (read when the
               first window starts), no K1 or K2 launch, 63 decode-FIFO
               rows; the decode traced from window 3 on as in phase 3;
 13. ssm parity — the falcon-mamba smoke config in f32 through serve() on
               the card and on the host: the same greedy tokens;
 14. ssm forward — Model.loss with the taps at full width and depth, B=2,
               S=4096: exactly 64 K3 launches, 64 commit rows, none
               dropped, a finite loss; wall time and peak memory;
 15. ssm scale-down — verify_extraction at layers 0, 32 and 63 (bitwise,
               65 K3 launches each) and scanned_vs_unrolled (0.0, 128);
 16. ssm forward parity — the falcon-mamba smoke config in f32 from seed
               0, the check of phase 9;
 17. k3 time — K3 timed with CUDA events at the forward and the prefill
               shapes, beside its bound and its plain version (no PyTorch
               call computes the selective scan, so no library time).

falcon-mamba-7b's weights are freed and the peak-memory counter reset
again for the recurrentgemma-2b phases (26 layers: (rglru, rglru, local)
x 8 and two rglru; d_model 2560, 10 heads on one kv head of head_dim 256,
window 2048, vocab 256000):

 18. k4      — K4 (the RG-LRU scan) against its plain version on the card,
               f32, h_all and h_last at 1e-5 (the tolerance of the
               reference's test_rglru_scan): the reference's grid, the
               chaining property (two launches, the second from the first's
               h_last, equal one), a ragged S=4000 with W=2600, and the
               forward (B=2, S=4096) and serve-prefill (B=8, S=2048) shapes;
 19. hd256   — K1 at B=2, S=4096, H=10, K=1, hd=256, causal with the
               2048-key window, and K2 at B=8, H=10, K=1, hd=256 on a
               2048-slot ring at pos 2047, 2048 and 2110 (full, then
               overwritten), f32 and bf16 at the tolerances of phases 2
               and 6;
 20. hybrid serve — serve() on the full recurrentgemma-2b config (random
               weights from a seed drawn on the card, kept for 22 and 23),
               the serve cell of phase 3 under sync-debug mode "error":
               exactly 18 K4 launches, all in the prefill, 8 x 63 K2 (the
               local layers' 2048-slot rings wrap at every step), no K1 or
               K3, 63 FIFO rows; the decode traced from window 3 on;
 21. hybrid parity — the recurrentgemma smoke config in f32 through
               serve() on the card and on the host: the same greedy tokens
               (its 16-slot rings wrap too);
 22. hybrid forward — Model.loss with the taps at full width and depth,
               B=2, S=4096: exactly 18 K4 and 8 K1 launches, 26 commit
               rows, none dropped, a finite loss; wall time and peak memory;
 23. hybrid scale-down — verify_extraction at layers 0 (rglru), 14
               (local) and 25 (the tail's rglru), bitwise, each with its
               exact launches, and scanned_vs_unrolled (0.0);
 24. hybrid forward parity — the recurrentgemma smoke config in f32 from
               seed 0, the check of phase 9;
 25. k4 time — K4 timed with CUDA events at the forward and the prefill
               shapes, beside its bound and its plain version (no PyTorch
               call computes the linear recurrence, so no library time);
 26. k1 time at hd 256 — K1 at recurrentgemma-2b's forward shape over 8
               distinct q/k/v sets, beside its bound, its plain version
               and F.scaled_dot_product_attention with the window as an
               explicit mask (timed only);
 27. k2 time at hd 256 — K2 at recurrentgemma-2b's serve shape (pos 2100,
               the ring wrapped) over 8 distinct cache sets, timed as in
               phase 5.

recurrentgemma-2b's weights are freed and the peak-memory counter reset
for the qwen3-moe-30b-a3b phases (48 layers of (attn, moe); d_model 2048,
32 heads on 4 kv heads of head_dim 128 with qk-norm, 128 experts top-8
of moe_d_ff 768, vocab 151936, untied; 61.06 GB of bf16 weights):

 28. k5      — K5 (the grouped expert GEMM) against its plain version on
               the card: the reference's grid in f32 at 2e-5 and bf16 at
               2e-2 (the tolerances of tests/test_kernels.py), bf16 also at
               a normwise relative error of 2e-3; qwen3's gate/up
               (128,C,2048)@(128,2048,768) and down (128,C,768)@
               (128,768,2048) products in bf16 at C = 640 (forward), 1280
               (serve prefill) and 8 (decode); moe_ffn against moe_ffn_ref
               in f32 at 1e-4 and in bf16 at qwen3's decode shape;
 29. moe serve — serve() on the full qwen3-moe-30b-a3b config (random
               weights from a seed drawn on the card, one period at a time,
               kept for 31 and 32), the serve cell of phase 3 under
               sync-debug mode "error": exactly 144 K5 launches and nothing
               else in the prefill, 48 x 63 K2 and 144 x 64 K5 over the run,
               63 FIFO rows; the decode traced from window 3 on;
 30. moe parity — the qwen3-moe and mixtral smoke configs in f32 through
               serve() on the card and on the host: the same greedy tokens;
 31. moe forward — Model.loss with the commit, coverage and router taps
               at full width and depth, B=2, S=4096: exactly 48 K1 and 144
               K5 launches, 48 commit rows, none dropped, the (48, 128)
               expert-toggle CSR drained, a finite loss; wall time and peak
               memory;
 32. moe scale-down — verify_extraction at layers 0, 24 and 47, bitwise,
               each with its exact launches, and scanned_vs_unrolled (0.0);
 33. moe forward parity — the qwen3-moe and mixtral smoke configs in f32
               from seed 0, the check of phase 9, and each layer's expert
               load and dropped fraction equal on the card and the host;
 34. k5 time — K5 at qwen3's three shapes, gate/up and down, with CUDA
               events, beside its bound, its plain version and torch.bmm
               (timed only; the port never calls it);
 35. k2 time at qwen3 — K2 at qwen3's serve shape (B=8, H=32, K=4,
               hd=128, W=2120, pos 2100) over 48 cache sets, timed as in
               phase 5.

K2, K1, K3, K4 and K5 go into one JSON line; K1 and K2 carry their
head_dim 256 numbers under "hd256", K2 its qwen3 numbers under "qwen3".
The last line is {"ok": true,
"device": {...}}. The full record is also written to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
# exponentials (MUFU.EX2) a clock per SM on compute capability 9.0: the
# arithmetic-instruction throughput table of the CUDA C++ Programming
# Guide; times the SMs and the maximum SM clock the card reports
SFU_PER_CLOCK_PER_SM = 16

# glm4-9b serve cell; its decode is profiled from window TRACED on
ARCH, BATCH, PROMPT, GEN, INTERVAL = "glm4-9b", 8, 2048, 64, 8
TRACED = 3
# the commit-tapped forward at glm4-9b's full width and depth
FWD_BATCH, FWD_SEQ = 2, 4096
SCALE_DOWN_LAYERS = (0, 20, 39)
# falcon-mamba-7b: the same serve cell and forward shape, full width and
# depth
SSM_ARCH = "falcon-mamba-7b"
SSM_SCALE_DOWN_LAYERS = (0, 32, 63)
# recurrentgemma-2b: the same serve cell and forward shape, full width and
# depth; layer 0 is an RG-LRU layer of the first period, 14 the local
# attention layer of the fifth, 25 the tail's second RG-LRU layer
HYB_ARCH = "recurrentgemma-2b"
HYB_SCALE_DOWN_LAYERS = (0, 14, 25)
# qwen3-moe-30b-a3b: the same serve cell and forward shape, full width and
# depth; the expert capacity C of its forward (T = 8192 tokens), serve
# prefill (16384) and decode (8) dispatch
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_SCALE_DOWN_LAYERS = (0, 24, 47)
MOE_CAPACITIES = {"forward": 640, "prefill": 1280, "decode": 8}


def kernel_ops():
    """The kernels' wrappers, each carrying its launch count."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    return {"k1": fa_ops.flash_attention, "k2": da_ops.decode_attention,
            "k3": ssm_ops.ssm_scan, "k4": lru_ops.rglru_scan,
            "k5": gg_ops.grouped_gemm}


def reset_counts():
    for fn in kernel_ops().values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in kernel_ops().items()}


def expect_counts(got, want, what):
    """Every kernel's count as ``want`` says (0 where it names none)."""
    full = {k: want.get(k, 0) for k in kernel_ops()}
    assert got == full, (what, got, full)


def log(**kw):
    print(json.dumps(kw, default=float), flush=True)


def tracing_timer(first):
    """A NoSyncInWindow timer that starts torch.profiler (device activity
    only) just before window ``first`` is enqueued. The caller stops it
    after the run, so no profiler stop or sync falls inside the decode."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.testing import NoSyncInWindow

    # the first profile of a process spends seconds setting up CUPTI:
    # spend them here, before the run the trace is taken from
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)

    class Tracing(NoSyncInWindow):
        prof = None
        counts_at_decode = None     # launch counts when window 0 starts

        @contextlib.contextmanager
        def phase(self, name):
            if name == "device" and self.windows == 0:
                self.counts_at_decode = counts()
            if name == "device" and self.windows == first:
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
            with super().phase(name):
                yield

    return Tracing()


def device_trace(prof, steps):
    """Device activity of the traced windows: busy time (the sum of their
    kernels and copies) over their span (first start to last end on the
    card), operations, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    span_us = max(e.time_range.end for e in evs) \
        - min(e.time_range.start for e in evs)
    busy_us = sum(e.time_range.elapsed_us() for e in evs)
    by_name: dict = {}
    for e in evs:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us()
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    return {"steps": steps,
            "device_span_ms": span_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": 1.0 - busy_us / span_us,
            "device_ops": len(evs), "device_ops_per_step": len(evs) / steps,
            "top_kernels": [{"name": n[:90], "ms": us / 1e3, "count": c}
                            for n, (us, c) in top]}


def time_ms(torch, fn, n_args, reps):
    """ms per call of fn(i) over reps passes through n_args inputs, with
    CUDA events, after one warm-up pass."""
    for i in range(n_args):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for i in range(n_args):
            fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n_args)


def graph_ms(torch, fn, n_args, reps):
    """ms per call of fn(i) in device time: the n_args calls captured once
    in one CUDA graph (after an eager warm-up pass), the graph replayed
    ``reps`` times between two CUDA events. The host issues one replay
    for n_args launches, so the time is the kernels', not the Python
    wrapper's."""
    from repro_torch.testing import capture_graph

    for i in range(n_args):
        fn(i)
    torch.cuda.synchronize()
    graph, _ = capture_graph(lambda: [fn(i) for i in range(n_args)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * n_args)


def forward_phase(cfg, params, B=FWD_BATCH, S=FWD_SEQ):
    """Model.loss with the commit and coverage taps (and the router tap
    for a MoE config) on one make_batch_fn batch on the card, its taps
    ingested into the P-Shell and drained. Checks the launch counts (each
    layer's kernels, nothing else), the commit rows, the expert-toggle
    CSR and the loss; returns the record, the model and the batch."""
    import torch

    from repro_torch.core import (default_shell_config, drain, make_ingest,
                                  shell_init)
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import Runtime, build_model
    from repro_torch.testing import TAPS, layer_kernels, tally

    taps = TAPS | {"router"} if cfg.num_experts else TAPS
    model = build_model(cfg, Runtime(taps=taps))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             make_batch_fn(cfg, B, S, seed=0)(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    with torch.inference_mode():
        loss, (metrics, aux) = model.loss(params, batch)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launch_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    shell = make_ingest(cfg)(shell_init(default_shell_config(cfg), "cuda"),
                             aux, metrics)
    records, _ = drain(shell)
    commits = records["fifos"]["commits"]
    L = cfg.num_layers
    loss_val = float(loss)
    want = tally(layer_kernels(cfg))
    expect_counts(launch_counts, want, "forward")
    assert commits["count"] == L, commits["count"]
    assert commits["dropped"] == 0, commits["dropped"]
    assert commits["data"][:, 0].tolist() == list(range(L))
    assert np.isfinite(commits["data"]).all()
    assert np.isfinite(loss_val)
    assert float(records["csrs"]["loss_last"]) == loss_val
    assert int(records["csrs"]["steps"]) == 1
    assert not records["csrs"]["nan_bits"].any()
    rec = {"arch": cfg.name, "batch": B, "seq": S, "layers": L,
           "loss": loss_val, "wall_s": wall_s, "max_memory_allocated": peak,
           **{f"{k}_launches": launch_counts[k] for k in want},
           "launches": launch_counts, "commit_rows": commits["count"],
           "dropped": commits["dropped"],
           "checksums_first_last": [commits["data"][0, 1:].tolist(),
                                    commits["data"][-1, 1:].tolist()]}
    if cfg.num_experts:
        toggles = records["csrs"]["expert_toggles"]
        n_moe = sum(1 for _, f in cfg.layer_specs if f == "moe")
        assert toggles.shape == (n_moe, cfg.num_experts), toggles.shape
        assert toggles.any(axis=1).all()
        assert records["fifos"]["router"]["count"] == 0
        rec.update(moe_aux=float(metrics["moe_aux"]),
                   ce=float(metrics["ce"]),
                   expert_toggle_rows=int(toggles.shape[0]),
                   experts_toggled=int(toggles.sum()),
                   experts_toggled_per_layer_min=int(toggles.sum(1).min()))
    return rec, model, batch


def scale_down_phase(cfg, params, model, batch, layers):
    """verify_extraction at ``layers`` on the batch's activations (bitwise;
    each layer's kernel once in the capture, and the replayed layer's once
    more), then scanned_vs_unrolled (0.0, each layer's kernel twice)."""
    import torch

    from repro_torch.core.decompose import (scanned_vs_unrolled,
                                            verify_extraction)
    from repro_torch.models.layers import embed_apply
    from repro_torch.testing import layer_kernels, tally

    B, S = batch["tokens"].shape
    kinds = layer_kernels(cfg)
    positions = torch.arange(S, dtype=torch.int32,
                             device="cuda").expand(B, S)
    reports = {}
    with torch.inference_mode():
        x = embed_apply(params["embed"], batch["tokens"])
        for layer in layers:
            reset_counts()
            t = time.perf_counter()
            rep = verify_extraction(params, cfg, x, positions, model.rt,
                                    layer)
            torch.cuda.synchronize()
            got = counts()
            rep.update(seconds=time.perf_counter() - t, launches=got)
            expect_counts(got, tally(kinds + [kinds[layer]]),
                          f"verify layer {layer}")
            assert rep["bitwise_identical"], rep
            reports[layer] = rep
        reset_counts()
        svu = scanned_vs_unrolled(params, cfg, x, positions, model.rt)
        got = counts()
    expect_counts(got, tally(kinds, 2), "scanned_vs_unrolled")
    assert svu == 0.0, svu
    return {"verify_extraction": reports, "scanned_vs_unrolled": svu,
            "scanned_vs_unrolled_launches": got}


def serve_phase(cfg, params):
    """serve() on ``cfg`` at the serve cell with ``params``, every decode
    window under sync-debug mode "error" and the decode traced from window
    TRACED on. All launch counts are set to 0 just before. When the first
    window starts, the prefill must have launched K3 or K4 once per mamba
    or RG-LRU layer and K5 three times per MoE layer, and nothing else
    (its attention is plain, as in the reference); at the end K2 must have
    run once per attention layer and K5 three times per MoE layer per
    decode step besides (``testing.serve_kernels``). Returns the serve
    record and the trace."""
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.testing import serve_kernels

    timer = tracing_timer(TRACED)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve(cfg, BATCH, PROMPT, GEN, seed=0, sample_interval=INTERVAL,
                device="cuda", params=params, timer=timer)
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    t = time.perf_counter()
    timer.prof.stop()
    stop_s = time.perf_counter() - t
    trace = device_trace(timer.prof, GEN - 1 - TRACED * INTERVAL)
    trace.update(windows=f"{TRACED}-end", profiler_stop_s=stop_s)
    steps = GEN - 1
    n_windows = -(-steps // INTERVAL)
    toks = out["tokens"]
    prefill_counts, total_counts = serve_kernels(cfg, steps)
    expect_counts(timer.counts_at_decode, prefill_counts, "serve prefill")
    expect_counts(got, total_counts, "serve")
    assert out["decode_fifo_rows"] == steps, out["decode_fifo_rows"]
    assert len(out["drained"]) == n_windows == timer.windows, \
        (len(out["drained"]), timer.windows)
    assert [d["tokens_csr"] for d in out["drained"]][-1] == BATCH * steps
    assert len(toks) == BATCH and all(len(r) == GEN for r in toks)
    assert all(0 <= t < cfg.vocab_size for r in toks for t in r)
    assert not out["hung"]
    rec = {k: out[k] for k in ("prefill_s", "decode_s", "decode_tok_per_s",
                               "decode_window_ms", "decode_fifo_rows",
                               "generated")}
    rec.update(arch=cfg.name, batch=BATCH, prompt_len=PROMPT, gen=GEN,
               sample_interval=INTERVAL, layers=cfg.num_layers,
               launches=got, launches_in_prefill=timer.counts_at_decode,
               windows=n_windows, max_memory_allocated=peak)
    return rec, trace


def serve_parity(archs):
    """Each arch's smoke config in f32 through serve() on the card
    (kernels) and on the host (plain), from the same weights: the greedy
    tokens must be equal. Returns the tokens per arch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.testing import NoSyncInWindow
    from repro_torch.utils import tree_map

    parity = {}
    for arch in archs:
        scfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        host = build_model(scfg).init(0, device="cpu")
        on_card = serve(scfg, 2, 16, 8, sample_interval=3, device="cuda",
                        params=tree_map(lambda x: x.to("cuda"), host),
                        timer=NoSyncInWindow())
        on_host = serve(scfg, 2, 16, 8, sample_interval=3, device="cpu",
                        params=host)
        assert on_card["tokens"] == on_host["tokens"], (arch, on_card,
                                                        on_host)
        assert on_card["decode_fifo_rows"] == on_host["decode_fifo_rows"]
        parity[arch] = on_card["tokens"]
    return parity


def k3_check_phase(cfg):
    """K3 against its plain version on the card (``check_ssm_scan``, f32,
    y and h_last at 1e-4). Returns, per case group, the max abs errors of
    y and of h_last."""
    from repro_torch.testing import check_ssm_scan

    Din, N = cfg.d_inner, cfg.ssm_state
    errs: dict = {}

    def case(key, *a, **kw):
        got = check_ssm_scan(*a, **kw)
        errs[key] = [max(x, y) for x, y in zip(errs.get(key, got), got)]

    for shape in ((2, 64, 32, 8), (1, 100, 48, 4)):
        case("grid", *shape)
    case("ragged", FWD_BATCH, 4000, Din, N)
    for shape in ((2, 64, 32, 8), (1, 100, 48, 4), (FWD_BATCH, 4000, Din,
                                                     N)):
        case("strided", *shape, strided=True)
    case("forward", FWD_BATCH, FWD_SEQ, Din, N, strided=True)
    case("prefill", BATCH, PROMPT, Din, N, strided=True)
    return errs


def k3_time(cfg, B, S, exp_per_s):
    """K3 and its plain version timed with CUDA events on inputs shaped as
    the model passes them (B_ and C_ strided views of one projection),
    cycling through two input sets of ~0.5 GB each or more, beside the
    bound: the larger of the bytes over the memory rate and the
    exponentials and f32 operations over their rates."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    Din, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    g = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    sets = []
    for _ in range(2):
        _, B_, C_ = torch.split(rand(B, S, R + 2 * N), [R, N, N], dim=-1)
        sets.append((F.softplus(rand(B, S, Din)),
                     -torch.exp(0.5 * rand(Din, N)), B_, C_,
                     rand(B, S, Din)))
    ms = time_ms(torch, lambda i: ssm_ops.ssm_scan(*sets[i]), 2, reps=5)
    plain_ms = time_ms(torch, lambda i: ssm_scan_ref(*sets[i]), 1, reps=1)
    ms_2 = time_ms(torch, lambda i: ssm_ops.ssm_scan(*sets[i]), 2, reps=5)
    elems = B * S * Din
    # dt, x in and y out; A, B_, C_ in and h_last out, all f32
    nbytes = 4 * (3 * elems + Din * N + 2 * B * S * N + B * Din * N)
    exps = elems * N
    # per state: dt*A, (dt*x)*B, the state's multiply-add, y's
    # multiply-add; and dt*x per channel and step
    flops = elems * (6 * N + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    exp_ms = exps / exp_per_s * 1e3
    flop_ms = flops / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, exp_ms, flop_ms)
    return {"ms": ms, "ms_repeat": ms_2, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= max(exp_ms, flop_ms)
            else "operations",
            "bound_share": bound_ms / ms, "bytes": nbytes, "bytes_ms": bytes_ms,
            "exps": exps, "exp_ms": exp_ms, "flops": flops,
            "flop_ms": flop_ms,
            "shape": {"B": B, "S": S, "Din": Din, "N": N,
                      "dtype": "float32", "B_C": "strided views"}}


def k2_time(B, H, K, W, hd, pos_val, n_sets, seed):
    """K2, its plain version and F.scaled_dot_product_attention (timed
    only; the port never calls it) over ``n_sets`` distinct bf16 q/cache
    sets, beside the bound: the larger of the bytes over the memory rate
    (q and out, and the valid cache slots, each once) and the products
    over the bf16 tensor-core rate. K2 and the library call are timed in
    device time through a CUDA-graph replay of the n_sets launches
    (``ms``, ``library_ms``) and also as eager calls paced by the host
    (``host_paced_ms``); the plain version eagerly. The split plan
    (chunk, n_split, blocks) goes with them, and the kernel's device time
    at each plan of 4 to 16 splits (``split_sweep_ms``, by n_split)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    qs = [torch.randn(B, H, hd, generator=g, device=dev).to(bf16)
          for _ in range(n_sets)]
    ks = [torch.randn(B, W, K, hd, generator=g, device=dev).to(bf16)
          for _ in range(n_sets)]
    vs = [torch.randn(B, W, K, hd, generator=g, device=dev).to(bf16)
          for _ in range(n_sets)]
    pos = torch.tensor(pos_val, dtype=torch.int32, device=dev)
    valid = (torch.arange(W, device=dev) <= pos) | (pos + 1 >= W)
    mask = valid.reshape(1, 1, 1, W)

    def kernel(i):
        return ops.decode_attention(qs[i], ks[i], vs[i], pos=pos, window=W)

    def plain(i):
        return decode_attention_ref(qs[i], ks[i], vs[i], pos=pos, window=W)

    def library(i):
        return F.scaled_dot_product_attention(
            qs[i][:, :, None], ks[i].transpose(1, 2), vs[i].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    lib_err = float((library(0)[:, :, 0].float()
                     - kernel(0).float()).abs().max())
    kernel_ms = graph_ms(torch, kernel, n_sets, reps=20)
    host_paced_ms = time_ms(torch, kernel, n_sets, reps=10)
    plain_ms = time_ms(torch, plain, n_sets, reps=2)
    library_ms = graph_ms(torch, library, n_sets, reps=20)
    library_host_paced_ms = time_ms(torch, library, n_sets, reps=10)
    kernel_ms_2 = graph_ms(torch, kernel, n_sets, reps=20)
    chunk, n_split = ops.split_plan(B * K, W, ops.sm_count(dev))
    # the plans of 4 to 16 splits, each timed the same way (uncounted
    # launches of the same kernel), beside the wrapper's own plan
    sweep = {}
    for n in range(4, ops.MAX_SPLIT + 1):
        plan = ops.splits(W, n)
        if plan[1] not in sweep:
            sweep[plan[1]] = graph_ms(torch, lambda i, plan=plan: ops.launch(
                qs[i], ks[i], vs[i], pos, W, 0.0, *plan), n_sets, reps=20)
    n_slots = W if pos_val + 1 >= W else min(W, pos_val + 1)
    elt = 2                                             # bf16
    nbytes = (2 * B * H * hd * elt                      # q in, out
              + 2 * B * n_slots * K * hd * elt          # k, v slots read
              + 4)                                      # pos
    flops = 4 * B * H * n_slots * hd                    # QK^T and PV
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "ms_repeat": kernel_ms_2,
            "host_paced_ms": host_paced_ms,
            "library_host_paced_ms": library_host_paced_ms,
            "timed": "CUDA-graph replay of the n_sets launches",
            "plan": {"chunk": chunk, "n_split": n_split,
                     "blocks": B * K * n_split},
            "split_sweep_ms": sweep,
            "split_sweep_fastest": min(sweep, key=sweep.get),
            "bound_share": bound_ms / kernel_ms, "bytes": nbytes,
            "flops": flops,
            "shape": {"B": B, "H": H, "K": K, "hd": hd, "W": W,
                      "pos": pos_val, "dtype": "bfloat16"},
            "library_max_abs_err": lib_err,
            "library_call": "F.scaled_dot_product_attention(attn_mask="
                            "valid slots, enable_gqa=True)"}


def k1_time(B, S, H, K, hd, window, n_sets, seed):
    """K1, its plain version and F.scaled_dot_product_attention (timed
    only; the port never calls it; the window, where there is one, as an
    explicit mask) with CUDA events over ``n_sets`` distinct bf16 q/k/v
    sets, causal, beside the bound: the larger of the bytes over the
    memory rate and the products of the unmasked (query, key) pairs over
    the bf16 tensor-core rate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    qs = [torch.randn(B, S, H, hd, generator=g, device=dev).to(bf16)
          for _ in range(n_sets)]
    ks = [torch.randn(B, S, K, hd, generator=g, device=dev).to(bf16)
          for _ in range(n_sets)]
    vs = [torch.randn(B, S, K, hd, generator=g, device=dev).to(bf16)
          for _ in range(n_sets)]
    # the library call in its own layout, (B, heads, S, hd), made outside
    # the timing
    qt = [t.transpose(1, 2).contiguous() for t in qs]
    kt = [t.transpose(1, 2).contiguous() for t in ks]
    vt = [t.transpose(1, 2).contiguous() for t in vs]
    qpos = torch.arange(S, device=dev)
    mask = (qpos[None, :] <= qpos[:, None]) \
        & (qpos[None, :] > qpos[:, None] - window) if window > 0 else None

    def kernel(i):
        return fa_ops.flash_attention(qs[i], ks[i], vs[i], causal=True,
                                      window=window)

    def plain(i):
        return flash_attention_ref(qs[i], ks[i], vs[i], causal=True,
                                   window=window)

    def library(i):
        if mask is None:
            return F.scaled_dot_product_attention(
                qt[i], kt[i], vt[i], is_causal=True, enable_gqa=True)
        return F.scaled_dot_product_attention(
            qt[i], kt[i], vt[i], attn_mask=mask, enable_gqa=True)

    lib_err = float((library(0).transpose(1, 2).float()
                     - kernel(0).float()).abs().max())
    ms = time_ms(torch, kernel, n_sets, reps=2)
    plain_ms = time_ms(torch, plain, n_sets, reps=1)
    library_ms = time_ms(torch, library, n_sets, reps=5)
    ms_2 = time_ms(torch, kernel, n_sets, reps=2)
    # unmasked (query, key) pairs: row r sees min(r + 1, window) keys
    w = window if window > 0 else S
    pairs = sum(min(r + 1, w) for r in range(S))
    flops = 4 * B * H * pairs * hd                 # QK^T and PV
    nbytes = (2 * B * S * H * hd + 2 * B * S * K * hd) * 2  # q,out,k,v
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "ms_repeat": ms_2,
            "bound_share": bound_ms / ms, "bytes": nbytes, "flops": flops,
            "shape": {"B": B, "S": S, "T": S, "H": H, "K": K, "hd": hd,
                      "causal": True, "window": window, "dtype": "bfloat16"},
            "library_max_abs_err": lib_err,
            "library_call": "F.scaled_dot_product_attention(" + (
                "is_causal=True" if mask is None else
                "attn_mask=causal window") + ", enable_gqa=True)"}


def k4_check_phase(cfg):
    """K4 against its plain version on the card (``check_rglru_scan``,
    f32, h_all and h_last at 1e-5). Returns, per case group, the max abs
    errors of h_all and of h_last."""
    from repro_torch.testing import check_rglru_scan

    W = cfg.lru_width
    errs: dict = {}

    def case(key, *a, **kw):
        got = check_rglru_scan(*a, **kw)
        errs[key] = [max(x, y) for x, y in zip(errs.get(key, got), got)]

    for shape in ((2, 64, 32), (1, 96, 64)):
        case("grid", *shape)
    case("chained", 1, 40, 16, split=17)
    case("chained", FWD_BATCH, FWD_SEQ, W, split=1000)
    case("ragged", FWD_BATCH, 4000, 2600)
    case("forward", FWD_BATCH, FWD_SEQ, W)
    case("prefill", BATCH, PROMPT, W)
    return errs


def k4_time(cfg, B, S):
    """K4 and its plain version timed with CUDA events, cycling through two
    input sets of 168 MB or more (a and b), beside the bound: the bytes
    over the memory rate (a, b and h0 read, h_all and h_last written)."""
    import torch

    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    W = cfg.lru_width
    g = torch.Generator(device="cuda").manual_seed(3)
    sets = [(torch.rand(B, S, W, generator=g, device="cuda"),
             torch.randn(B, S, W, generator=g, device="cuda"),
             torch.randn(B, W, generator=g, device="cuda"))
            for _ in range(2)]
    ms = time_ms(torch, lambda i: lru_ops.rglru_scan(*sets[i]), 2, reps=10)
    plain_ms = time_ms(torch, lambda i: rglru_scan_ref(*sets[i]), 1, reps=1)
    ms_2 = time_ms(torch, lambda i: lru_ops.rglru_scan(*sets[i]), 2,
                   reps=10)
    nbytes = 4 * (3 * B * S * W + 2 * B * W)
    flops = 2 * B * S * W
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flop_ms = flops / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, flop_ms)
    return {"ms": ms, "ms_repeat": ms_2, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flop_ms else "operations",
            "bound_share": bound_ms / ms, "bytes": nbytes,
            "bytes_ms": bytes_ms, "flops": flops, "flop_ms": flop_ms,
            "shape": {"B": B, "S": S, "W": W, "dtype": "float32"}}


def forward_parity_phase(archs):
    """Each arch's smoke config in f32 from seed 0 through
    ``check_forward_parity`` (card against host, replays bitwise), with
    each kernel's launches on the card: per layer of its kind, one in the
    loss, one in every layer's verify_extraction capture and one in its
    own replay."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.testing import check_forward_parity, layer_kernels, tally

    out = {}
    for arch in archs:
        scfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        got = check_forward_parity(scfg)
        want = tally(layer_kernels(scfg), scfg.num_layers + 2)
        assert {k: got[f"{k}_launches"] for k in ("k1", "k3", "k4", "k5")} \
            == {k: want.get(k, 0) for k in ("k1", "k3", "k4", "k5")}, got
        out[arch] = got
    return out


def k5_check_phase(cfg):
    """K5 against its plain version on the card (``check_grouped_gemm``):
    the reference's grid in f32 and bf16, a ragged tile in bf16 with the
    16-byte copies, and the model's gate/up and down products at each
    capacity of MOE_CAPACITIES in bf16; ``moe_ffn`` (three launches)
    against ``moe_ffn_ref``. Returns, per case group, the max abs error
    and the normwise relative error."""
    import torch

    from repro_torch.testing import check_grouped_gemm, check_moe_ffn

    errs: dict = {}

    def case(key, check, *a):
        got = check(*a)
        errs[key] = [max(x, y) for x, y in zip(errs.get(key, got), got)]

    bf16 = torch.bfloat16
    for dtype in (torch.float32, bf16):
        dname = str(dtype).replace("torch.", "")
        for shape in ((4, 128, 64, 128), (3, 50, 33, 17), (1, 8, 8, 8),
                      (8, 256, 128, 64)):
            case(f"grid_{dname}", check_grouped_gemm, *shape, dtype)
    case("ragged_bfloat16", check_grouped_gemm, 5, 77, 136, 200, bf16)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    for name, C in MOE_CAPACITIES.items():
        case(f"{name}_gate_up", check_grouped_gemm, E, C, D, F, bf16)
        case(f"{name}_down", check_grouped_gemm, E, C, F, D, bf16)
    case("moe_ffn_float32", check_moe_ffn, 4, 64, 32, 48, torch.float32)
    case("moe_ffn_bfloat16", check_moe_ffn, E, MOE_CAPACITIES["decode"], D,
         F, bf16)
    return errs


def k5_time(E, M, K, N, seed):
    """K5, its plain version and torch.bmm (timed only; the port never
    calls it) with CUDA events over two distinct bf16 x/w sets (w alone is
    0.4 GB a set at qwen3's shapes, beyond the 50 MB L2), beside the
    bound: the larger of the bytes over the memory rate (x and w read and
    the output written, each once) and the products over the bf16
    tensor-core rate."""
    import torch

    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    sets = [(torch.randn(E, M, K, generator=g, device="cuda").to(bf16),
             (torch.randn(E, K, N, generator=g, device="cuda")
              * K ** -0.5).to(bf16)) for _ in range(2)]

    def kernel(i):
        return gg_ops.grouped_gemm(*sets[i])

    def plain(i):
        return grouped_gemm_ref(*sets[i])

    def library(i):
        return torch.bmm(*sets[i])

    lib_err = float((library(0).float() - kernel(0).float()).abs().max())
    ms = time_ms(torch, kernel, 2, reps=10)
    plain_ms = time_ms(torch, plain, 2, reps=1)
    library_ms = time_ms(torch, library, 2, reps=10)
    ms_2 = time_ms(torch, kernel, 2, reps=10)
    flops = 2 * E * M * K * N
    nbytes = 2 * (E * M * K + E * K * N + E * M * N)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"ms": ms, "ms_repeat": ms_2, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_share": bound_ms / ms, "bytes": nbytes,
            "bytes_ms": bytes_ms, "flops": flops, "flop_ms": ops_ms,
            "shape": {"E": E, "M": M, "K": K, "N": N, "dtype": "bfloat16"},
            "library_max_abs_err": lib_err, "library_call": "torch.bmm"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import build_model
    from repro_torch.testing import (check_decode_attention,
                                     check_decode_determinism,
                                     check_flash_attention, layer_kernels,
                                     tally)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record: dict = {}

    # ---------------------------------------------------------- 1. device --
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def smi_query(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]

    smi = smi_query("name,power.limit")
    sm_clock_mhz = float(smi_query("clocks.max.sm").split()[0])
    exp_per_s = SFU_PER_CLOCK_PER_SM * sms * sm_clock_mhz * 1e6
    print(f"device: {name} count={count} sms={sms} "
          f"max_sm_clock_mhz={sm_clock_mhz}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    record["device"] = {"name": name, "count": count, "nvidia_smi": smi,
                        "sms": sms, "max_sm_clock_mhz": sm_clock_mhz,
                        "exp_per_s": exp_per_s,
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    sources = ("decode_attention", "flash_attention", "ssm_scan",
               "rglru_scan", "grouped_gemm")
    t = time.perf_counter()
    build_logs = _build.build(*sources)
    build_s = time.perf_counter() - t
    for kname, text in build_logs.items():
        # registers, shared memory and spills of each instance
        print(f"nvcc {kname}:", flush=True)
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "error" in line:
                print("  " + line.strip(), flush=True)
    # whether K1's library holds Hopper's warpgroup products (HGMMA) and
    # TMA loads (UTMALDG), where the toolkit has cuobjdump
    sass_counts = None
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run(
            [str(cuobjdump), "-sass",
             str(_build.library_path("flash_attention"))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        sass_counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
        print(f"cuobjdump flash_attention: {sass_counts}", flush=True)
    log(phase="build", seconds=build_s, built=list(sources),
        k1_sass=sass_counts)
    record["build_s"] = build_s
    record["k1_sass"] = sass_counts
    record["build_logs"] = build_logs

    # ---------------------------------------------------------- 2. kernel --
    errs: dict = {}         # case group -> [max abs err, normwise err]

    def case(key, **kw):
        got = check_decode_attention(**kw)
        errs[key] = [max(a, b) for a, b in zip(errs.get(key, got), got)]

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for W, pos in ((64, 5), (64, 63), (100, 31), (64, 200)):
            for H, K in ((8, 2), (4, 4), (10, 1)):
                case(f"grid_{dname}", B=2, H=H, K=K, W=W, hd=32, pos=pos,
                     dtype=dtype)
        for hd, H, K in ((16, 4, 1), (16, 4, 2), (64, 16, 1)):
            case(f"grid_{dname}", B=3, H=H, K=K, W=77, hd=hd, pos=40,
                 dtype=dtype)
        for pos in (2047, 2100, 5000):
            case(f"glm4_{dname}", B=BATCH, H=32, K=2, W=PROMPT + GEN + 8,
                 hd=128, pos=pos, dtype=dtype)
        for softcap in (0.0, 30.0):
            case(f"granite_{dname}", B=BATCH, H=32, K=8, W=PROMPT + GEN + 8,
                 hd=128, pos=2100, dtype=dtype, softcap=softcap)
        # qwen3-moe-30b-a3b's decode; pos on either side of the first
        # split chunk's end
        chunk = da_ops.split_plan(BATCH * 4, PROMPT + GEN + 8, sms)[0]
        for pos in (chunk - 1, chunk, 2100):
            case(f"qwen3_{dname}", B=BATCH, H=32, K=4, W=PROMPT + GEN + 8,
                 hd=128, pos=pos, dtype=dtype)
    check_decode_determinism(BATCH, 32, 2, PROMPT + GEN + 8, 128,
                             (700, 2100), seed=11)
    k2_bitwise = {"two_launches": True, "graph_replay": True,
                  "pos": [700, 2100]}
    log(phase="kernel", max_abs_err_and_normwise_err=errs,
        bitwise=k2_bitwise)
    record["kernel_errors"] = errs

    # ----------------------------------------------------------- 3. serve --
    cfg = get_config(ARCH)
    params = build_model(cfg).init(0, device="cuda")   # kept for 7 and 8
    serve_rec, trace = serve_phase(cfg, params)
    launches = serve_rec["launches"]["k2"]
    serve_rec["k2_launches"] = launches
    log(phase="serve", **serve_rec)
    record["serve"] = serve_rec
    log(phase="trace", **trace)
    record["trace"] = trace

    # ---------------------------------------------------------- 4. parity --
    parity = serve_parity(("glm4-9b", "granite-8b"))
    log(phase="parity", tokens_equal=True, tokens=parity)
    record["parity"] = parity

    # --------------------------------------------------------- 5. kernels --
    L, H, K, hd = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    # pos 2100 lies inside the serve run's decode range; one cache set per
    # layer (~17 MB each, beyond the 50 MB L2 together)
    k2_t = k2_time(BATCH, H, K, PROMPT + GEN + 8, hd, 2100, L, seed=1)
    k2 = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/"
                    "decode_attention.py:67",
        "launches": launches,
        "max_abs_err": errs["glm4_bfloat16"][0],
        **k2_t,
        "launches_per_step": cfg.num_layers,
    }

    # -------------------------------------------------------------- 6. k1 --
    fa_errs: dict = {}      # case group -> [max abs err, normwise err]
    qwen3 = get_config("qwen3-moe-30b-a3b")   # its forward's K1 shape, G=8

    def fa_case(key, *a, **kw):
        got = check_flash_attention(*a, **kw)
        fa_errs[key] = [max(x, y) for x, y in zip(fa_errs.get(key, got),
                                                   got)]

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for shape in ((1, 128, 4, 2, 32), (2, 256, 4, 4, 64),
                      (1, 96, 2, 1, 16), (1, 160, 8, 2, 32)):
            fa_case(f"grid_{dname}", *shape, dtype)
        for window, causal, softcap in ((64, True, 0.0), (33, True, 0.0),
                                        (0, False, 0.0), (0, True, 20.0)):
            fa_case(f"grid_{dname}", 1, 192, 4, 2, 32, dtype, window=window,
                    causal=causal, softcap=softcap)
        fa_case(f"glm4_{dname}", FWD_BATCH, FWD_SEQ, 32, 2, 128, dtype)
        fa_case(f"granite_{dname}", FWD_BATCH, FWD_SEQ, 32, 8, 128, dtype)
        fa_case(f"qwen3_{dname}", FWD_BATCH, FWD_SEQ, qwen3.num_heads,
                qwen3.num_kv_heads, qwen3.head_dim, dtype)
        fa_case(f"ragged_{dname}", FWD_BATCH, 4000, 32, 8, 128, dtype,
                window=33, softcap=30.0)
    log(phase="k1", max_abs_err_and_normwise_err=fa_errs)
    record["k1_errors"] = fa_errs
    torch.cuda.empty_cache()

    # --------------------------------------------------------- 7. forward --
    fwd, model, batch = forward_phase(cfg, params)
    log(phase="forward", **fwd)
    record["forward"] = fwd

    # ------------------------------------------------------ 8. scale-down --
    scale_down = scale_down_phase(cfg, params, model, batch,
                                  SCALE_DOWN_LAYERS)
    log(phase="scale_down", **scale_down)
    record["scale_down"] = scale_down
    del batch
    torch.cuda.empty_cache()

    # ------------------------------------------------- 9. forward parity --
    fwd_parity = forward_parity_phase(("glm4-9b", "granite-8b"))
    log(phase="forward_parity", **fwd_parity)
    record["forward_parity"] = fwd_parity

    # --------------------------------------------------------- 10. k1 time --
    # one q/k/v set per layer (~2.9 GB together, beyond the 50 MB L2)
    k1_t = k1_time(FWD_BATCH, FWD_SEQ, H, K, hd, 0, L, seed=1)
    k1 = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/"
                    "flash_attention.py:84",
        "launches": fwd["k1_launches"],
        "max_abs_err": fa_errs["glm4_bfloat16"][0],
        **k1_t,
        "launches_per_step": cfg.num_layers,
    }
    del params, model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -------------------------------------------------------------- 11. k3 --
    scfg = get_config(SSM_ARCH)
    k3_errs = k3_check_phase(scfg)
    log(phase="k3", max_abs_err_y_and_h_last=k3_errs)
    record["k3_errors"] = k3_errs
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 12. ssm serve --
    sparams = build_model(scfg).init(0, device="cuda")   # kept for 14, 15
    ssm_serve, ssm_trace = serve_phase(scfg, sparams)
    log(phase="ssm_serve", **ssm_serve)
    record["ssm_serve"] = ssm_serve
    log(phase="ssm_trace", **ssm_trace)
    record["ssm_trace"] = ssm_trace

    # ------------------------------------------------------- 13. ssm parity --
    ssm_parity = serve_parity((SSM_ARCH,))
    log(phase="ssm_parity", tokens_equal=True, tokens=ssm_parity)
    record["ssm_parity"] = ssm_parity

    # ------------------------------------------------------ 14. ssm forward --
    ssm_fwd, smodel, sbatch = forward_phase(scfg, sparams)
    log(phase="ssm_forward", **ssm_fwd)
    record["ssm_forward"] = ssm_fwd

    # --------------------------------------------------- 15. ssm scale-down --
    ssm_sd = scale_down_phase(scfg, sparams, smodel, sbatch,
                              SSM_SCALE_DOWN_LAYERS)
    log(phase="ssm_scale_down", **ssm_sd)
    record["ssm_scale_down"] = ssm_sd
    del sparams, smodel, sbatch
    torch.cuda.empty_cache()

    # ----------------------------------------------- 16. ssm forward parity --
    ssm_fwd_parity = forward_parity_phase((SSM_ARCH,))[SSM_ARCH]
    log(phase="ssm_forward_parity", **ssm_fwd_parity)
    record["ssm_forward_parity"] = ssm_fwd_parity

    # ---------------------------------------------------------- 17. k3 time --
    k3_fwd = k3_time(scfg, FWD_BATCH, FWD_SEQ, exp_per_s)
    k3_pre = k3_time(scfg, BATCH, PROMPT, exp_per_s)
    k3 = {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/ssm_scan.py:55",
        "launches": ssm_fwd["k3_launches"],
        "max_abs_err": max(k3_errs["forward"]),
        "ms": k3_fwd["ms"], "plain_ms": k3_fwd["plain_ms"],
        "bound_ms": k3_fwd["bound_ms"], "bound_by": k3_fwd["bound_by"],
        "library_ms": None,
        "launches_per_forward": scfg.num_layers,
        "launches_serve": ssm_serve["launches"]["k3"],
        "forward_shape": k3_fwd, "prefill_shape": k3_pre,
        "max_abs_err_prefill": max(k3_errs["prefill"]),
        "library_call": "none: no PyTorch call computes the selective scan",
    }
    log(phase="k3_time", forward=k3_fwd, prefill=k3_pre)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -------------------------------------------------------------- 18. k4 --
    hcfg = get_config(HYB_ARCH)
    k4_errs = k4_check_phase(hcfg)
    log(phase="k4", max_abs_err_h_all_and_h_last=k4_errs)
    record["k4_errors"] = k4_errs
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 19. hd 256 ----
    HH, HK, Hhd, HW = hcfg.num_heads, hcfg.num_kv_heads, hcfg.head_dim, \
        hcfg.window
    hd256_errs: dict = {}   # case group -> [max abs err, normwise err]

    def hd256_case(key, check, *a, **kw):
        got = check(*a, **kw)
        hd256_errs[key] = [max(x, y) for x, y in
                           zip(hd256_errs.get(key, got), got)]

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        hd256_case(f"k1_{dname}", check_flash_attention, FWD_BATCH, FWD_SEQ,
                   HH, HK, Hhd, dtype, window=HW)
        for pos in (HW - 1, HW, PROMPT + GEN - 2):
            hd256_case(f"k2_{dname}", check_decode_attention, B=BATCH, H=HH,
                       K=HK, W=HW, hd=Hhd, pos=pos, dtype=dtype)
    log(phase="hd256", max_abs_err_and_normwise_err=hd256_errs)
    record["hd256_errors"] = hd256_errs
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 20. hybrid serve --
    hparams = build_model(hcfg).init(0, device="cuda")   # kept for 22, 23
    hyb_serve, hyb_trace = serve_phase(hcfg, hparams)
    log(phase="hybrid_serve", **hyb_serve)
    record["hybrid_serve"] = hyb_serve
    log(phase="hybrid_trace", **hyb_trace)
    record["hybrid_trace"] = hyb_trace

    # --------------------------------------------------- 21. hybrid parity --
    hyb_parity = serve_parity((HYB_ARCH,))
    log(phase="hybrid_parity", tokens_equal=True, tokens=hyb_parity)
    record["hybrid_parity"] = hyb_parity

    # -------------------------------------------------- 22. hybrid forward --
    hyb_fwd, hmodel, hbatch = forward_phase(hcfg, hparams)
    log(phase="hybrid_forward", **hyb_fwd)
    record["hybrid_forward"] = hyb_fwd

    # ----------------------------------------------- 23. hybrid scale-down --
    hyb_sd = scale_down_phase(hcfg, hparams, hmodel, hbatch,
                              HYB_SCALE_DOWN_LAYERS)
    log(phase="hybrid_scale_down", **hyb_sd)
    record["hybrid_scale_down"] = hyb_sd
    del hparams, hmodel, hbatch
    torch.cuda.empty_cache()

    # ------------------------------------------- 24. hybrid forward parity --
    hyb_fwd_parity = forward_parity_phase((HYB_ARCH,))[HYB_ARCH]
    log(phase="hybrid_forward_parity", **hyb_fwd_parity)
    record["hybrid_forward_parity"] = hyb_fwd_parity

    # ---------------------------------------------------------- 25. k4 time --
    k4_fwd = k4_time(hcfg, FWD_BATCH, FWD_SEQ)
    k4_pre = k4_time(hcfg, BATCH, PROMPT)
    k4 = {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/rglru_scan.py:41",
        "launches": hyb_fwd["k4_launches"],
        "max_abs_err": max(k4_errs["forward"]),
        "ms": k4_fwd["ms"], "plain_ms": k4_fwd["plain_ms"],
        "bound_ms": k4_fwd["bound_ms"], "bound_by": k4_fwd["bound_by"],
        "library_ms": None,
        "launches_per_forward": hyb_fwd["k4_launches"],
        "launches_serve": hyb_serve["launches"]["k4"],
        "forward_shape": k4_fwd, "prefill_shape": k4_pre,
        "max_abs_err_prefill": max(k4_errs["prefill"]),
        "library_call": "none: no PyTorch call computes the linear "
                        "recurrence",
    }
    log(phase="k4_time", forward=k4_fwd, prefill=k4_pre)

    # ------------------------------------------------ 26. k1 time at 256 --
    # one q/k/v set per local layer (~0.7 GB together)
    n_local = tally(layer_kernels(hcfg))["k1"]
    k1["hd256"] = {
        "launches": hyb_fwd["k1_launches"],
        "max_abs_err": hd256_errs["k1_bfloat16"][0],
        **k1_time(FWD_BATCH, FWD_SEQ, HH, HK, Hhd, HW, n_local, seed=4)}
    log(phase="k1_time_hd256", **k1["hd256"])

    # ------------------------------------------------ 27. k2 time at 256 --
    # pos 2100: the ring is full and wraps, inside the serve run's decode;
    # one 16.8 MB cache set per local layer (134 MB together)
    k2["hd256"] = {
        "launches": hyb_serve["launches"]["k2"],
        "max_abs_err": hd256_errs["k2_bfloat16"][0],
        **k2_time(BATCH, HH, HK, HW, Hhd, 2100, n_local, seed=5)}
    log(phase="k2_time_hd256", **k2["hd256"])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -------------------------------------------------------------- 28. k5 --
    mcfg = get_config(MOE_ARCH)
    k5_errs = k5_check_phase(mcfg)
    log(phase="k5", max_abs_err_and_normwise_err=k5_errs)
    record["k5_errors"] = k5_errs
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 29. moe serve --
    # 61.06 GB of bf16 weights, drawn one period at a time; kept for 31, 32
    mparams = build_model(mcfg).init(0, device="cuda")
    moe_serve, moe_trace = serve_phase(mcfg, mparams)
    log(phase="moe_serve", **moe_serve)
    record["moe_serve"] = moe_serve
    log(phase="moe_trace", **moe_trace)
    record["moe_trace"] = moe_trace
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 30. moe parity --
    moe_parity = serve_parity((MOE_ARCH, "mixtral-8x7b"))
    log(phase="moe_parity", tokens_equal=True, tokens=moe_parity)
    record["moe_parity"] = moe_parity

    # ----------------------------------------------------- 31. moe forward --
    moe_fwd, mmodel, mbatch = forward_phase(mcfg, mparams)
    log(phase="moe_forward", **moe_fwd)
    record["moe_forward"] = moe_fwd

    # -------------------------------------------------- 32. moe scale-down --
    moe_sd = scale_down_phase(mcfg, mparams, mmodel, mbatch,
                              MOE_SCALE_DOWN_LAYERS)
    log(phase="moe_scale_down", **moe_sd)
    record["moe_scale_down"] = moe_sd
    del mparams, mmodel, mbatch
    torch.cuda.empty_cache()

    # ---------------------------------------------- 33. moe forward parity --
    moe_fwd_parity = forward_parity_phase((MOE_ARCH, "mixtral-8x7b"))
    log(phase="moe_forward_parity", **moe_fwd_parity)
    record["moe_forward_parity"] = moe_fwd_parity

    # ---------------------------------------------------------- 34. k5 time --
    E, D, F = mcfg.num_experts, mcfg.d_model, mcfg.moe_d_ff
    k5_t = {f"{name}_{prod}": k5_time(E, C, *dims, seed=6)
            for name, C in MOE_CAPACITIES.items()
            for prod, dims in (("gate_up", (D, F)), ("down", (F, D)))}
    log(phase="k5_time", **k5_t)
    fwd_t = k5_t["forward_gate_up"]
    k5 = {
        "name": "grouped_gemm", "route": "cuda",
        "source": "src/repro_torch/csrc/grouped_gemm.cu",
        "replaces": "src/repro/kernels/grouped_gemm/grouped_gemm.py:37",
        "launches": moe_fwd["k5_launches"],
        "max_abs_err": k5_errs["forward_gate_up"][0],
        "ms": fwd_t["ms"], "plain_ms": fwd_t["plain_ms"],
        "bound_ms": fwd_t["bound_ms"], "bound_by": fwd_t["bound_by"],
        "library_ms": fwd_t["library_ms"],
        "launches_per_forward": moe_fwd["k5_launches"],
        "launches_serve": moe_serve["launches"]["k5"],
        "launches_serve_prefill": moe_serve["launches_in_prefill"]["k5"],
        "shapes": k5_t,
        "library_call": "torch.bmm",
    }

    # ------------------------------------------- 35. k2 time at qwen3 --
    # qwen3's serve decode: pos 2100, one 17.4 MB cache set for each of
    # its 48 layers (0.83 GB together)
    k2["qwen3"] = {
        "launches": moe_serve["launches"]["k2"],
        "max_abs_err": errs["qwen3_bfloat16"][0],
        **k2_time(BATCH, mcfg.num_heads, mcfg.num_kv_heads,
                  PROMPT + GEN + 8, mcfg.head_dim, 2100, mcfg.num_layers,
                  seed=7)}
    log(phase="k2_time_qwen3", **k2["qwen3"])

    kernels = [k2, k1, k3, k4, k5]
    record["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                        default=float))
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
