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
               where the toolkit has cuobjdump, the HGMMA (wgmma), UTMALDG
               (TMA load) and UTMASTG (TMA store) instructions in K1's,
               K4's and K5's libraries;
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
               tokens, windows of 8, twice on the same weights: with the
               eager engine (graph=False), then with every window one
               CUDA-graph replay (seven full windows and the tail of 7,
               both lengths captured before the first window). Each run's
               K2 launch count is set to 0 just before and must read
               exactly 40 x 63 after (replays counted); every decode
               window's dispatch runs under CUDA sync-debug mode "error",
               so a host sync inside a window fails the run. The two runs
               must agree to the bit: tokens, every drained FIFO row and
               CSR, the final KV cache. The graph run's decode is traced with
               torch.profiler (device activity only) from window 3 to its
               end: device busy time, span and idle share, device
               operations per step, and the kernels that take the most
               device time. Phases 12, 20 and 29 serve the same way;
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
               Din=8192, B_ and C_ as strided views, the forward (B=2,
               S=4096) and serve-prefill (B=8, S=2048) shapes, the lane
               groups' edges (N = 4, 8, 16; S = 1, 15, 17, 33; Din = 100)
               and every lane group forced (S = 33, Din = 300); and
               bitwise over two launches and a CUDA-graph replay at both
               slice shapes;
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
               call computes the selective scan, so no library time), with
               its plan (design, lane group, warps) and its registers and
               spills.

falcon-mamba-7b's weights are freed and the peak-memory counter reset
again for the recurrentgemma-2b phases (26 layers: (rglru, rglru, local)
x 8 and two rglru; d_model 2560, 10 heads on one kv head of head_dim 256,
window 2048, vocab 256000):

 18. k4      — K4 (the RG-LRU scan) against its plain version on the card,
               f32, h_all and h_last equal to the bit, through the
               wrapper's path and each path forced ("tma" where TMA maps
               the shape, "registers" everywhere): the reference's grid,
               the chaining property (two launches, the second from the
               first's h_last, equal one), ragged S=4000 and 2000 with
               W=2600 (B=2 and 8), W = 33 and 5 ("registers" only), a and b 4 bytes off a
               16-byte boundary, and the forward (B=2, S=4096) and
               serve-prefill (B=8, S=2048) shapes; and each path bitwise
               over two launches and a CUDA-graph replay at those two;
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
               call computes the linear recurrence, so no library time),
               with its plan (path, channels a block, steps a stage,
               stages, blocks, bytes in flight), each path forced, a
               device copy of a as the card's streaming rate (timed
               only), the wrapper's host time a call and the registers
               and spills of each instance;
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
               (serve prefill) and 8 (decode); each bf16 kernel ("wgmma",
               "mma") at M = 1 to 1280 rows and at qwen3's widths; shapes
               TMA cannot map (K or N off 8, a misaligned base), which
               fall to "mma"; moe_ffn against moe_ffn_ref in
               f32 at 1e-4 and in bf16 at qwen3's decode shape; each path
               bitwise over two launches and a CUDA-graph replay;
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
               (timed only; the port never calls it), the path each took,
               every bf16 path at the decode shape, the wrapper's host
               time a call, and the registers and spills of the new
               kernels;
 35. k2 time at qwen3 — K2 at qwen3's serve shape (B=8, H=32, K=4,
               hd=128, W=2120, pos 2100) over 48 cache sets, timed as in
               phase 5.

The train phases run last, after qwen3-moe-30b-a3b's weights are freed:

 36. train   — glm4-9b at full width, 8 of its 40 layers (2.873e9
               parameters, 34.48 GB of bf16 params and gradients and
               f32 moments; all 40 would take 112.8 GB), on the
               reference's train path (attention_impl "xla"), B=2,
               S=1024, the commit, coverage and router taps, windows
               of 4, AdamW peaking at 3e-5 after 10 warmup steps, 8
               steps, under deterministic mode: per
               step through PShell.run, then from a fresh draw of the same
               seed through PShell.run_grouped of make_group_step (the
               first window run eagerly; the second captured, then
               replayed), then with the shell off. The grouped
               run's state (params, m, v, count, step), every step's
               metrics and every drained record equal the per-step run's
               to the bit (kept on the host); the shell-off params too;
               one commit row a layer a step, none dropped; no port kernel
               launched; the loss lower at the end than at the start.
               Peak memory and wall time of each run, and one window
               timed with CUDA events as a replay and run eagerly;
 37. train parity — one make_group_step window (3 steps) of the glm4-9b,
               falcon-mamba-7b, recurrentgemma-2b and qwen3-moe-30b-a3b
               smoke configs in f32 on the card and on the host from the
               same state: losses and gradient norms within 1e-4, every
               parameter within 3 x the window's summed learning rates
               (``testing.check_train_parity``).
 38. coemu  — CoEmulator.verify at granite-8b's full width on 4 of its 36
               layers (1.275e9 parameters; a verify holds a bf16 DUT state,
               an f32 oracle state and a working copy of each, 44 B a
               parameter, 56.1 GB), B=2, S=1024, 8 steps, the bf16 DUT the
               train step on the "xla" path with the commit tap, under
               deterministic mode, TF32 off: (a) the DUT against itself
               (rtol 1e-6) step-locked, then group-locked in windows of 4
               overlapped and serial: no divergence, max_rel_err exactly
               0, the three reports equal, 1 eager + 1 graph window a
               side; (b) inject_fault at layers 0, 2 and 3 named (0, k)
               step-locked and group-locked; (c) determinism True; (d)
               the bf16 DUT against the f32 oracle drawn from the same
               seed: max_rel_err per layer and component and the loss
               difference recorded, gated finite only, verified steps/s
               step-locked, group-locked overlapped and serial (wall and
               CUDA-event span a step, capture seconds, peak memory, each
               side's state bytes); (e) a forward-only step on the kernels
               (K1 at hd 128, bf16) against the same step on the plain
               path in f32, and inject_fault at layer 2 against the clean
               kernel step named (0, 2), K1 launched exactly 4 times a step
               a kernel side (replays counted). The caller's states equal
               their host copies after every verify and determinism;
 39. loop   — train_loop at granite-8b's full width on 2 of its 36 layers
               (8.4 GB of DUT state a checkpoint), 8 steps, windows of 2,
               checkpoints every 4 into a temporary directory the phase
               deletes, under deterministic mode: fused with the clean
               oracle (the same step, rtol 1e-5) publishes [4, 8]; an
               oracle state from another seed raises CommitDivergence
               with nothing published, fused and per step; a second
               train_loop resumed from step 4 replays steps 4-7 with the
               uninterrupted run's losses to the bit; seconds a save and
               bytes written.

The ZP-Scope plane, remat and the examples (this order in the run: phase
40 right after phase 10, on phase 3's weights; 41, 42 and the examples
after phase 39):

 40. scope-serve — serve() at phase 3's cell and weights four times: the
               graph engine with the plane off, with the plane on unfused
               (ScopeSpec(every_n_windows=2): the counter update runs
               eagerly after each replay), with the plane fused (the update
               captured into each window's graph: still one replay a
               window), and the eager engine with the plane on. Each
               run's launch counts are set to 0 just before and must read
               exactly 40 x 63 K2 after, every window under sync-debug
               mode "error"; tokens, every drained FIFO row and CSR and
               the final cache equal the plane-off run's to the bit; every
               sample's cumulative digest and digest ring equal
               ``digest_tree`` of the same windows' host tokens. Decode
               tok/s of each run, and the device operations and time of
               one eager counter update (profiled). The bytes allocated
               in CUDA-graph private pools after each run
               (``memory_after_serve``) must not grow after the second
               (every capture runs on the card's one capture stream, so
               cuBLAS keeps one workspace there however many pools the
               process makes);
 41. scope-loop — phase 39's train_loop cell (granite-8b, 2 of 36 layers,
               8 steps, windows of 2, one checkpoint, at step 8) with the plane
               off and on (ScopeSpec()), fused and per step, under
               deterministic mode: losses and the final state equal to
               the bit, and each published checkpoint's manifest (every
               leaf's path, shape, dtype and crc32) equal; the report
               counts 4 windows (8 steps fused; per step, a window of
               scalar losses counts one step, as in the reference) and
               its gate bits are folded into the coverage map. Then the
               fused run's drained window digests through a
               CommitStreamVerifier whose oracle is the same bf16 step,
               with the expected digests of its own run: digest_hits 4;
               an oracle from another seed misses, falls through to the
               row compare and raises CommitDivergence;
 42. remat  — phase 36's train cell (glm4-9b, 8 of 40 layers, B=2,
               S=1024, windows of 4, 8 steps, lr 3e-5, the "xla" path)
               through run_grouped under remat "none", "dots" and "full":
               losses and updated params equal to the bit across the three
               (deterministic mode), no port kernel launched; peak memory
               and a window replay timed with CUDA events for each, and
               the bytes one forward (B=2, S=1024) leaves allocated for
               the backward and its forward and backward peaks;
 examples — the five examples/torch_*.py with --device cuda at their
               smoke budgets, each in a subprocess that must exit 0.

The ZP-Farm (right after phase 40, on phase 3's weights, before they are
freed):

 50. farm    — verify_subsystems at glm4-9b's full width and depth: 4
               steps of B=2, S=1024 bf16 activations drawn on the card
               from seed 0, windows of 2, every one of the 40 layers a
               board of a lockstep FarmManager on the one card: (a) solo,
               8 virtual slots; (b) lanes, lane capacity 8 (5 fused runs
               of 8 same-spec layers, torch.func.vmap of the shared
               engine, K1 through its vmap rule). The farm pass's launch
               counts are set to 0 just before mgr.run() and must read K1
               exactly 160 solo and 20 with lanes, nothing else. Gates:
               no divergence in either self-verify; each layer's lane
               checksums within the verifier's rtol of its solo ones
               (bitwise-ness reported; rtol 1e-3, FARM_RTOL: 50x tighter
               than the default, which a fault in the last layer passes);
               inject_fault at layer 0 and
               at layer 39 named (0, k) in both modes on layers 0, 1, 38,
               39 (one fused run of 4). Board-steps/s (host clock after a
               sync), window dispatches, the farm telemetry and the peak;
 51. mixed   — one run_many pass: phase 3's graphed decode engine (its
               WindowGraphs, captured before the pass, with its P-Shell
               drain) as one client beside 8 of phase 50's boards as
               shell-less clients. The counts are set to 0 just before:
               K2 exactly phase 3's 40 x 63, K1 exactly 8 x 4. The greedy
               tokens equal phase 3's to the bit and each board's
               checksums equal phase 50's solo ones to the bit. Decode
               tok/s beside phase 3's.

The async ZP-Farm (after phase 51, on phase 3's weights, before they are
freed): one dispatcher thread and one CUDA stream per slot.

 52. farm-async — phase 50's cell with mode="async": solo (8 slots) and
               lanes (capacity 8); the counts set to 0 just before
               mgr.run() read K1 exactly 160 solo and 20 with lanes,
               nothing else. Gates: each board's solo checksums equal
               phase 50's lockstep ones to the bit; lanes within the
               verifier's rtol of solo; faults at layers 0 and 39 named
               (0, k) on layers 0, 1, 38, 39 in both; the solo pass and
               nine more async solo passes right after it, in one
               process, each delivering the first's checksums: from the
               second on each leaves exactly the bytes it found (a
               seat's thread and stream, and so its cuBLAS workspace,
               live for the process), the bytes allocated after each
               printed. Board-steps/s of lockstep and async
               solo passes in turns (lockstep, async, async, lockstep);
               queue-wait, idle and depth telemetry; peak memory; one
               lockstep and one async pass traced (torch.profiler, CUDA
               activity) for the card's idle share (busy = the union of
               the kernels' and copies' intervals over all streams);
 53. farm-mixed — run_farm's workload at full width, from the CLI's own
               submit_decode_job (phase 3's cell and weights, graphed,
               captured by prewarm), submit_train_job (glm4-9b at full
               width on 2 of 40 layers, B=2, S=1024, 8 steps in windows
               of 2, the "xla" path, lr 3e-5) and submit_subsystem_jobs
               (layers 0-7 of the decode's weights), on 4 slots, async
               then lockstep, under deterministic mode. Gates: K2 exactly
               phase 3's 2,520 and K1 exactly 32; the tokens equal phase
               3's to the bit; the losses equal between the modes to the
               bit; the boards clean and equal to phase 50's solo
               checksums. Then async with submit_soak_straggler beside
               the decode and the boards (no train board): the soak
               board is evicted as "straggler" on wall time alone,
               requeued, its outputs preserved. Decode tok/s (the decode
               job's own span) beside phase 3's, s a train step, peak;
 54. farm-cli — the CLI's gates in-process on the card, both modes:
               run_restart_smoke, run_lanes_smoke(8, chaos_lane=True),
               run_scope_smoke (lanes 1 and 8) and run_chaos_smoke(7)
               (every injected fault fired and recovered, the poisoned
               board quarantined); then `python -m
               repro_torch.launch.farm --steps 8` in a subprocess (exit
               0), and one with --synthetic-straggler sent SIGINT once
               its farm runs (exit 130 with a partial report).
 56. farm-certify — ZP-Cert on the same weights, before they are freed:
               (a) trace-only certification (one engine call on fake
               tensors) of phase 50's 40 layer boards, phase 51's graphed
               decode board and phase 53's train board, their trees (the
               first window's stack, the train state drawn by its
               factory) built first: no error finding on any; while it
               runs, the allocated bytes, the allocator's peak (reset just
               before), every kernel's launches and the build directory
               stay exactly as they were (under no_dispatch_guard); the
               layer boards' reports list 2 flash_attention calls a
               window, 160 over the 40 boards' windows (phase 50's
               launches), the decode's 40 decode_attention calls a step;
               seconds per certification. (b) Two FarmManager(certify=
               True) farms, lockstep then async (4 slots, a journal in a
               temporary directory), each given layers 0-7 as boards,
               the CLI's graphed decode board (submit_decode_job,
               captured by prewarm) and the CLI's poison board (.item()
               in its window body): the poison board is quarantined at
               submit, its engine never runs, the journal holds its
               certify_fail record and the telemetry a failed
               certification; the boards' checksums equal phase 50's
               solo ones and the tokens phase 3's, to the bit; K1
               exactly 8 x 4 and K2 exactly 40 x 63 over the run. (c) In
               subprocesses, together: `python -m repro_torch.launch.farm
               --certify-smoke` (async and --lockstep) and `python -m
               repro_torch.analysis --strict --archs`, each exiting 0.
 57. roofline — the measured-window roofline (roofline/) on the same
               weights. (a) Phase 3's graphed serve carries its capture:
               8 windows and 63 steps; one step's counted FLOPs within 2 %
               of the analytic count (2 x the products' parameters x B,
               and K2's 4·B·H·ring·hd a layer: testing.decode_step_flops);
               a step's counted bytes at least the weights' bf16 bytes;
               its tokens equal the eager run's to the bit. The cost pass
               alone, on the graphed run's own decode cache right after
               it, under no_dispatch_guard: the allocated bytes, the peak
               (reset just before), the launches and the build directory
               unchanged, its seconds printed, its FLOPs x 63 the capture's.
               The HBM and bf16 shares over the pipelined wall and over
               the windows' device time (CUDA events). (b) Phase 39's
               clean train_loop with its capture: its windows and steps
               the loop's, each window's device time above 0, their sum
               within the loop's wall. (c) A capture on layer 0's board of
               a farm of phase 50's boards 0, 1, 38 and 39 (K1 on its
               path), force-evicted once, lockstep then async: its rows
               exactly the windows delivered (0 and 1), each with a device
               time; K1 exactly 2 a window dispatch, 16 for the four
               boards plus the evicted attempt's; the checksums equal
               phase 50's solo ones to the bit. Beside them, in
               subprocesses: `python -m repro_torch.launch.farm --roofline`
               (async and --lockstep), each exiting 0 and printing
               "roofline". (d) Every kernel's bound in phases 5, 10, 17,
               25-27, 34, 35 and 49 is its module's cost (kernels/*/ops.py
               ::cost) over roofline/hw.py's rates (K3's exponentials at
               hw.exp_rate of the card's SMs and maximum SM clock).

The last four archs run after the examples, each at full width and
depth from random weights drawn on the card from seed 0, with every
earlier model's weights freed and the peak-memory counter reset before
each (``last_four_phases``; internlm2-20b 48 layers of 48 heads on 8 kv
heads, command-r-35b 40 of 64 on 8, both head_dim 128; whisper-small's
12-layer encoder over 1,500 frames and 12-layer decoder, 12 heads,
head_dim 64; internvl2-1b 24 layers of 14 heads on 2, head_dim 64, 256
patches of 1024 wide):

 43. kernels — K2 at the four decode shapes (B=8, the serve rings: 2,120
               slots, 2,376 for internvl2-1b's patch prefix) with pos on
               the edges of the first split chunk and inside the decode,
               K1 at the four forward shapes (B=2, S=4096, causal) and
               ragged (S=4000) at head_dim 64, f32 at 2e-5, bf16 at 2e-2
               and 6e-3 normwise; K1 and K2 at the head_dim-64 shapes
               bitwise over two launches and a CUDA-graph replay; and
               both at head_dim 8 (command-r-35b's smoke config, which
               phase 45 serves on the card): K2 on a 32-slot ring, K1
               causal, non-causal with S != T, windowed and soft-capped,
               and bitwise;
 44. serve   — the serve cell of phase 3 per arch, eager and graph
               engines bitwise, under sync-debug mode "error", traced
               from window 3: K2 exactly layers x 63 (3,024 / 2,520 /
               756 / 1,512), K1 0 (the prefill attention is plain, as in
               the reference); the frames and patches go to the card in
               the model's dtype;
 45. parity  — the four smoke configs in f32 through serve() on the card
               and on the host: the same greedy tokens;
 46. forward — the tapped Model.loss at B=2, S=4096 (the pipeline's
               f32 frames and patches): K1 exactly 48 / 40 / 12 / 24, as
               many commit rows, none dropped; wall time and peak memory;
 47. scale-down — verify_extraction at layers 0/24/47 of internlm2-20b
               and 0/12/23 of internvl2-1b, bitwise, each with its exact
               launches, and scanned_vs_unrolled (0.0);
 48. verify  — CoEmulator.verify at the full width and depth of
               whisper-small and internvl2-1b, B=2, S=1024 (whisper's
               1,500 f32 frames), 4 steps, step-locked, the bf16 "xla"
               train step with the commit tap under deterministic mode:
               the self-verify exactly 0.0, faults at internvl2-1b's
               layers 0 and 23 named (0, k), and the bf16 DUT against the
               f32 oracle (gated finite); verified steps/s, peak memory;
 49. k1/k2 time at hd 64 — K1 at whisper-small's and internvl2-1b's
               forward shapes and K2 at their serve shapes, one input
               set a layer, timed as in phases 10 and 5, beside the
               bound, the plain version and F.scaled_dot_product_attention.

ZP-Ledger, run last, once every model is freed and the parent holds
under 1 GiB of reserved device memory (its reserved bytes and the card's
free memory printed first):

 55. farm-ledger — (a) the CLI's --killrestart-smoke (run_killrestart_
               smoke: toy boards paced at 5 ms a window, the victim
               killed at the 8th journaled commit) async and lockstep
               together, each in its own process with --device cuda (its
               oracle in it, the victim and the recovery its children),
               before (b): the victim died by SIGKILL at a journaled
               commit, a board resumed mid-stream, fewer windows replayed
               than committed, every window delivered once across both
               lifetimes, the window files equal the oracle's byte for
               byte (launch.farm.killrestart_problems); each board's
               commits, delivered cursor and their lag at the kill
               printed. (b) The same gates on glm4-9b at full width:
               layers 0, 5, 10, 15, 20, 25, 30 and 39 as layer boards (a
               JobSpec each, through a factory this script registers as
               "chip_smoke.glm4_layer_board" that draws the weights as
               phase 3 does and captures 8 steps of B=2, S=1024
               activations from seed 0, whose first 4 are phase 50's),
               windows of 2 (4 a board, 32 commits), 4 async slots,
               snapshots on disk (4 kept a board) and the journal in a
               temporary directory (its free space printed first), under
               deterministic mode. Three lifetimes, each the CLI's
               run_ledger_farm: the oracle here (K1 exactly 64, nothing
               else; each board's first 4 steps, read back from its
               window files, equal to phase 50's solo checksums to the
               bit), a victim child SIGKILLed at its 12th journaled
               commit, and, once the card has its memory back, a
               recovery child (`chip_smoke.py --ledger-child ROLE DIR`,
               each with a timeout; a failed one's stderr tail printed):
               the CLI's gates (its window files, written by both
               lifetimes, equal the oracle's to the bit), its K1 count
               above 0 and under 64. Each lifetime's seconds, each
               child's peak memory, the journal's records, bytes and
               append (fsync) times, the bytes written, and the seconds
               from the victim's death (its exit reaped here) to the
               recovery's first commit.

K2, K1, K3, K4 and K5 go into one JSON line; K1 and K2 carry their
head_dim 256 numbers under "hd256", their head_dim 64 numbers under
"hd64" (by arch) and the last four archs' launches, K2 its qwen3
numbers under "qwen3".
The last line is {"ok": true,
"device": {...}}. The full record is also written to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# a fixed cuBLAS workspace, set before CUDA initialises: a CUDA-graph
# capture (on a side stream) then picks the same algorithms as the eager
# run, and deterministic mode (the train phase) allows cuBLAS
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT / "src"))

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
# the train cell: glm4-9b at full width, 8 of its 40 layers (2.873e9
# parameters; 12 B a parameter, bf16 params and gradients and f32
# moments, is 34.48 GB, where all 40 layers would take 112.8 GB), B=2,
# S=1024, windows of 4, 8 steps
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_INTERVAL, TRAIN_STEPS = 2, 1024, 4, 8
# AdamW's peak rate, reached after 10 warmup steps. At the reference's
# default 3e-4 this width's loss rose after the first step (12.41, 10.76,
# 13.10, ..., 15.84 over 8 steps, H100); at 3e-5 it falls at every step
TRAIN_LR = 3e-5
TRAIN_TAPS = frozenset({"commits", "coverage", "router"})
# the co-emulation cell: granite-8b at full width, 4 of its 36 layers
# (1.275e9 parameters). A verify holds a bf16 DUT state (2 B params + 8 B
# f32 moments), an f32 oracle state (4 + 8 B) and a working copy of each:
# 44 B a parameter, 56.1 GB, plus the oracle's f32 gradients (5.1 GB) and
# the activations; glm4-9b's embedding and head alone hold 1.242e9
# parameters, and 2 of its 40 layers would need 72.6 GB
COEMU_ARCH, COEMU_LAYERS = "granite-8b", 4
COEMU_BATCH, COEMU_SEQ, COEMU_STEPS, COEMU_GROUP = 2, 1024, 8, 4
COEMU_FAULT_LAYERS = (0, 2, 3)
COEMU_KERNEL_FAULT_LAYER = 2
# the example's tolerance for a bf16 DUT against the f32 oracle
# (examples/coemu_verify.py); the phase gates only that the errors are
# finite, since this error sits near it and can cross it
COEMU_BF16_RTOL = 0.3
# the train loop with the verifier: 2 of granite-8b's 36 layers (8.4 GB of
# DUT state a checkpoint)
LOOP_LAYERS, LOOP_STEPS, LOOP_INTERVAL, LOOP_EVERY = 2, 8, 2, 4
# phase 41 publishes one checkpoint a run, at its last step: its gate
# compares the manifests of the plane-off and plane-on runs, and each
# 8.4 GB save takes 9-10 s (H100 80GB HBM3)
SCOPE_LOOP_EVERY = LOOP_STEPS
# the ZP-Scope plane's read rate in the scoped serve (phase 40)
SCOPE_EVERY = 2
# the last four archs (phases 43-49), each at full width and depth, in
# this order, at the forward's B=2 (command-r-35b's 60.6 GB of weights,
# its 8.4 GB of f32 logits and a logsumexp temporary as large peaked at
# 77.45 GB, under the card's 85 GB, once ``free_device_memory`` clears
# what the earlier phases leave)
NEW_ARCHS = ("internlm2-20b", "command-r-35b", "whisper-small",
             "internvl2-1b")
NEW_SCALE_DOWN_LAYERS = {"internlm2-20b": (0, 24, 47),
                         "internvl2-1b": (0, 12, 23)}
# the verify at full width and depth (phase 48): B=2, S=1024, 4 steps;
# internvl2-1b's faults at its first and last layer
VERIFY_ARCHS = ("whisper-small", "internvl2-1b")
VERIFY_BATCH, VERIFY_SEQ, VERIFY_STEPS = 2, 1024, 4
VERIFY_FAULT_LAYERS = (0, 23)
# the ZP-Farm cell (phases 50-51): verify_subsystems on glm4-9b's 40
# layers, FARM_STEPS steps of B=FARM_BATCH, S=FARM_SEQ activations in
# windows of FARM_GROUP; FARM_SLOTS virtual slots solo, lane capacity
# FARM_LANES; faults at the first and the last layer on FARM_FAULT_LAYERS
# (inject_fault clones the 18.8 GB tree, so those runs take 4 boards);
# FARM_MIXED boards beside the decode client in phase 51
FARM_STEPS, FARM_BATCH, FARM_SEQ, FARM_GROUP = 4, 2, 1024, 2
FARM_SLOTS, FARM_LANES = 8, 8
FARM_FAULT_LAYERS = (0, 1, 38, 39)
FARM_MIXED = 8
# the verifier's rtol in phases 50-51, 50x tighter than verify_subsystems'
# default 5e-2: the port replays a captured block bitwise solo and within
# ~2e-7 with lanes (H100), while at 5e-2 a fault in the last layer passes
# unseen (its k projection scaled 100x moves that block's checksums by
# 9.6e-3: the residual stream dominates the output there)
FARM_RTOL = 1e-3
# the mixed async farm (phase 53): MIXED_SLOTS virtual slots; the train
# board on MIXED_TRAIN_LAYERS of glm4-9b's 40 layers (1.65e9 parameters,
# 16.5 GB of bf16 params and f32 moments, drawn at admission: alone on
# an H100 beside the weights it peaked at 72.6 GB with a second, initial
# copy kept as the replay source) for MIXED_TRAIN_STEPS
# steps; the soak board (MIXED_SOAK_WINDOWS
# windows, MIXED_SOAK_DELAY s a window on its first seat) against a
# straggler floor of MIXED_MIN_S s
MIXED_SLOTS, MIXED_TRAIN_LAYERS, MIXED_TRAIN_STEPS = 4, 2, 8
MIXED_SOAK_WINDOWS, MIXED_SOAK_DELAY, MIXED_MIN_S = 30, 1.0, 0.5
# consecutive async solo passes of phase 52's cell whose memory is gated
# (from the second on, each leaves exactly the bytes it found)
ASYNC_MEMORY_PASSES = 10
# the ledger cell (phase 55): LEDGER_LAYERS of glm4-9b's 40 layers as
# layer boards of LEDGER_STEPS steps (B=FARM_BATCH, S=FARM_SEQ, windows of
# FARM_GROUP: 4 windows and 4 commits a board) on LEDGER_SLOTS async
# slots; the victim dies at its LEDGER_KILL_AT-th journaled commit; each
# child gets LEDGER_CHILD_TIMEOUT_S; the recovery starts once the card's
# free memory is back within LEDGER_FREE_SLACK of what it was before the
# victim, waiting at most LEDGER_FREE_TIMEOUT_S; the parent holds under
# LEDGER_PARENT_RESERVED bytes when the phase starts
LEDGER_LAYERS = (0, 5, 10, 15, 20, 25, 30, 39)
LEDGER_STEPS, LEDGER_SLOTS, LEDGER_KILL_AT = 8, 4, 12
LEDGER_CHILD_TIMEOUT_S = 400
LEDGER_FREE_SLACK, LEDGER_FREE_TIMEOUT_S = 4 * 2**30, 60.0
LEDGER_PARENT_RESERVED = 2**30
# the disk the phase needs under tempfile.gettempdir(): the 4 snapshots a
# board kept (8 boards x 4 x 0.41 GB) and some room
LEDGER_DISK_BYTES = 16 * 10**9

# the examples and their smoke budgets, run on the card last
EXAMPLES = (("torch_quickstart.py", ["--steps", "4"]),
            ("torch_coemu_verify.py", ["--steps", "2"]),
            ("torch_train_e2e.py", ["--steps", "20"]),
            ("torch_fault_tolerance.py", []),
            ("torch_scale_down_extraction.py", []))


def ptxas_info(text):
    """Registers and spill bytes of each kernel instance in nvcc's
    ``-Xptxas=-v`` log, by kernel name and template arguments."""
    import re
    out: dict = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            # _ZN <len><id> ... <len><name> [I<template args>E]: the last
            # id of the nested name (after the anonymous namespace)
            i, ids = 3, []
            while i < len(mangled) and mangled[i].isdigit():
                j = i
                while mangled[j].isdigit():
                    j += 1
                ids.append(mangled[j:j + int(mangled[i:j])])
                i = j + int(mangled[i:j])
            # template arguments: ints, bools, float and bf16
            targs = re.match(r"I(.*?E)E", mangled[i:])
            args = ""
            if targs:
                args = re.sub(r"\d+__nv_bfloat16", "bf16,", targs.group(1))
                args = re.sub(r"L[ib](\d+)E", r"\1,", args)
                args = "<" + re.sub(r"^f", "float,", args).rstrip(",") + ">"
            name = (ids[-1] if ids else mangled) + args
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def kernel_ops():
    """The kernels' wrappers, each carrying its launch count."""
    from repro_torch.core.graphs import counted_kernels
    return counted_kernels()


def reset_counts():
    for fn in kernel_ops().values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in kernel_ops().items()}


def expect_counts(got, want, what):
    """Every kernel's count as ``want`` says (0 where it names none)."""
    full = {k: want.get(k, 0) for k in kernel_ops()}
    assert got == full, (what, got, full)


T0 = time.perf_counter()


def log(**kw):
    """One JSON line, with the seconds since the script started."""
    kw["t_s"] = time.perf_counter() - T0
    print(json.dumps(kw, default=float), flush=True)


def tracing_timer(first, trace=True):
    """A NoSyncInWindow timer that keeps the launch counts when window 0
    starts and, with ``trace``, starts torch.profiler (device activity
    only) just before window ``first`` is enqueued. The caller stops it
    after the run, so no profiler stop or sync falls inside the decode."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.testing import NoSyncInWindow

    if trace:
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
            if trace and name == "device" and self.windows == first:
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
            with super().phase(name):
                yield

    return Tracing()


def device_events(prof):
    """(name, start ns, end ns) of every device event (kernels, copies,
    fills) of a stopped torch.profiler run, read from its kineto results
    (names as the trace holds them). ``prof.events()`` builds a Python
    FunctionEvent and a tree of them for every event, device and runtime
    alike, at tens of microseconds of host time an event: a glm4-9b serve
    trace holds 112,171 device operations and as many launches."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()]


def device_trace(prof, steps):
    """Device activity of the traced windows: busy time (the union of
    their kernels' and copies' intervals, over all streams: on one stream
    the sum of their times) over their span (first start to last end on
    the card), operations, and the kernels that take the most device
    time."""
    evs = device_events(prof)
    span_us = (max(b for _, _, b in evs) - min(a for _, a, _ in evs)) / 1e3
    busy_ns, end = 0, None
    for a, b in sorted((a, b) for _, a, b in evs):
        if end is None or a > end:
            busy_ns, end = busy_ns + b - a, b
        elif b > end:
            busy_ns, end = busy_ns + b - end, b
    busy_us = busy_ns / 1e3
    by_name: dict = {}
    for name, a, b in evs:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += (b - a) / 1e3
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


def _serve_run(cfg, params, graph):
    """serve() at the serve cell, the graph engine traced from window
    TRACED on (the eager one, the bitwise reference, untraced: its
    profile cost ~25 s of profiler stops over the script's eight serve
    phases on an H100); all launch counts set to 0 just before. Returns
    (serve record, timer, launch counts, peak memory, trace or None)."""
    import torch

    from repro_torch.launch.serve import serve

    timer = tracing_timer(TRACED, trace=graph)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve(cfg, BATCH, PROMPT, GEN, seed=0, sample_interval=INTERVAL,
                device="cuda", params=params, timer=timer, graph=graph,
                return_cache=True)
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    if not graph:
        return out, timer, got, peak, None
    t = time.perf_counter()
    timer.prof.stop()
    stop_s = time.perf_counter() - t
    trace = device_trace(timer.prof, GEN - 1 - TRACED * INTERVAL)
    trace.update(windows=f"{TRACED}-end", profiler_stop_s=stop_s)
    return out, timer, got, peak, trace


def serve_phase(cfg, params, roofline_gate=False):
    """serve() on ``cfg`` at the serve cell with ``params``, twice: with
    the eager engine (``graph=False``), then with every decode window one
    CUDA-graph replay (the full window and the tail captured before the
    first window, after a one-step warm-up on clones), each window under
    sync-debug mode "error" and the graph run's decode traced from window TRACED
    on. All launch counts are set to 0 just before each run. When the
    first window starts, the prefill must have launched K3 or K4 once per
    mamba or RG-LRU layer and K5 three times per MoE layer, and nothing
    else (its attention is plain, as in the reference); at the end K2
    must have run once per attention layer and K5 three times per MoE
    layer per decode step besides (``testing.serve_kernels``), counted as
    replays in the graph run. The two runs must agree to the bit (tokens,
    every drained FIFO row and CSR, the final cache). Each record keeps
    its run's measured-window roofline; ``roofline_gate`` runs phase 57
    (a) on the graph run (``serve_roofline_gate``, on its own decode
    cache before it leaves the card). Returns the graph run's record (the
    eager run's under "eager") and its trace."""
    from repro_torch.testing import assert_serve_equal, serve_kernels
    from repro_torch.utils import tree_map

    steps = GEN - 1
    n_windows = -(-steps // INTERVAL)
    prefill_counts, total_counts = serve_kernels(cfg, steps)
    runs = {}
    for engine in ("eager", "graph"):
        out, timer, got, peak, trace = _serve_run(cfg, params,
                                                  engine == "graph")
        gate = None
        if roofline_gate and engine == "graph":
            gate = serve_roofline_gate(cfg, params, out)
        # the final cache waits for the comparison on the host, so the
        # next run's prefill has its memory (2.6 GB at command-r-35b)
        out["cache"] = tree_map(lambda t: t.cpu(), out["cache"])
        toks = out["tokens"]
        expect_counts(timer.counts_at_decode, prefill_counts,
                      f"serve prefill ({engine})")
        expect_counts(got, total_counts, f"serve ({engine})")
        assert out["engine"] == engine, out["engine"]
        assert out["windows_by_engine"] == {
            "graph": n_windows if engine == "graph" else 0,
            "eager": 0 if engine == "graph" else n_windows}, \
            out["windows_by_engine"]
        assert out["decode_fifo_rows"] == steps, out["decode_fifo_rows"]
        assert len(out["drained"]) == n_windows == timer.windows, \
            (len(out["drained"]), timer.windows)
        assert [d["tokens_csr"] for d in out["drained"]][-1] \
            == BATCH * steps
        assert len(toks) == BATCH and all(len(r) == GEN for r in toks)
        assert all(0 <= t < cfg.vocab_size for r in toks for t in r)
        assert not out["hung"]
        rec = {k: out[k] for k in ("prefill_s", "decode_s",
                                   "decode_tok_per_s", "decode_window_ms",
                                   "decode_fifo_rows", "generated",
                                   "tokens", "engine", "windows_by_engine",
                                   "capture_s", "roofline")}
        if gate is not None:
            rec["roofline_gate"] = gate
        rec.update(arch=cfg.name, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                   sample_interval=INTERVAL, layers=cfg.num_layers,
                   launches=got, launches_in_prefill=timer.counts_at_decode,
                   windows=n_windows, max_memory_allocated=peak)
        runs[engine] = (out, rec, trace)
    assert_serve_equal(runs["graph"][0], runs["eager"][0],
                       f"{cfg.name} serve, graph vs eager")
    rec, trace = runs["graph"][1], runs["graph"][2]
    if roofline_gate:
        # the capture rode both runs and moved no token (phase 57 (a))
        rec["roofline_gate"]["tokens_bitwise_vs_eager"] = True
    rec["eager"] = runs["eager"][1]
    rec["bitwise_vs_eager"] = True
    return rec, trace


def serve_roofline_gate(cfg, params, out):
    """Phase 57 (a) on a graphed serve record ``out`` of the serve cell
    (with its final decode cache, still on the card): the capture's
    windows and steps, one step's counted FLOPs against the analytic
    count, a step's counted bytes against the weights' bytes, and the
    cost pass alone under no_dispatch_guard on that cache (nothing
    allocated, launched or built; its FLOPs x 63 the capture's). Returns
    the record."""
    import torch

    from repro_torch.analysis import no_dispatch_guard, warm_fake_device
    from repro_torch.core.pshell import shell_init
    from repro_torch.launch.serve import (decode_shell_config,
                                          make_decode_engine)
    from repro_torch.models import build_model
    from repro_torch.roofline import HW_H100
    from repro_torch.roofline.cost import count_cost
    from repro_torch.testing import decode_step_flops
    from repro_torch.utils import tree_leaves

    roof = out["roofline"]
    steps = GEN - 1
    assert (roof["windows"], roof["steps"]) == (-(-steps // INTERVAL),
                                                steps) == (8, 63), roof
    ring = PROMPT + GEN + 8
    want = decode_step_flops(cfg, BATCH, ring)
    per_step = roof["hlo_flops"] / steps
    assert abs(per_step / want - 1) <= 0.02, (per_step, want)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                  if torch.is_tensor(t))
    assert roof["hlo_bytes"] / steps >= weights, (roof["hlo_bytes"],
                                                  weights)
    assert roof["device_s"] > 0, roof
    # the cost pass alone, on this run's decode cache
    dev = torch.device("cuda")
    tok = torch.tensor([r[-1] for r in out["tokens"]], dtype=torch.int32,
                       device=dev)[:, None]
    sh = shell_init(decode_shell_config(INTERVAL), dev)
    engine = make_decode_engine(build_model(cfg), params)
    warm_fake_device(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    builds = _build_listing()
    with torch.inference_mode(), no_dispatch_guard():
        t = time.perf_counter()
        cost = count_cost(engine, (out["cache"], tok), sh, np.arange(1))
        cost_s = time.perf_counter() - t
    assert (torch.cuda.memory_allocated(),
            torch.cuda.max_memory_allocated()) == mem, mem
    assert _build_listing() == builds
    assert cost["flops"] * steps == roof["hlo_flops"], (cost, roof)
    assert cost["bytes"] * steps == roof["hlo_bytes"], (cost, roof)
    rec = {
        "windows": roof["windows"], "steps": roof["steps"],
        "flops_per_step": per_step, "analytic_flops_per_step": want,
        "flops_rel_err": per_step / want - 1,
        "bytes_per_step": roof["hlo_bytes"] / steps,
        "weight_bytes": weights, "cost_pass_s": cost_s,
        "device_s": roof["device_s"],
        "device_s_per_step": roof["device_s_per_step"],
        "wall_s_per_step": roof["s_per_step"],
        "hbm_share_wall": roof["peak_hbm_fraction"],
        "bf16_share_wall": roof["peak_flops_fraction"],
        "hbm_share_device": roof["hlo_bytes"] / roof["device_s"]
        / HW_H100.hbm_bw,
        "bf16_share_device": roof["hlo_flops"] / roof["device_s"]
        / HW_H100.peak_flops_bf16,
        "unchanged_under_cost_pass": ["allocated", "peak", "launches",
                                      "builds"]}
    print(f"roofline serve: {rec}", flush=True)
    return rec


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
    y and h_last at 1e-4), and bitwise over launches and a CUDA-graph
    replay. Returns, per case group, the max abs errors of y and of
    h_last."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.testing import check_ssm_scan, check_ssm_scan_bitwise

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
    # the lane groups' edges: the wrapper's group at N = 4, 8, 16 (1, 2
    # and 4 lanes at B = 2, Din = 100) and every group forced, one step
    # and either side of the 16-step chunk, Din off the channel block
    for n_state in (4, 8, 16):
        for S in (1, 15, 17, 33):
            case("lane_groups", 2, S, 100, n_state, strided=True)
        for group in ssm_ops.lane_groups(n_state):
            case(f"group_{group}", 2, 33, 300, n_state, strided=True,
                 group=group)
    # bitwise over two launches and a CUDA-graph replay, at the forward's
    # and the prefill's groups
    check_ssm_scan_bitwise(FWD_BATCH, FWD_SEQ, Din, N)
    check_ssm_scan_bitwise(BATCH, PROMPT, Din, N)
    check_ssm_scan_bitwise(2, 33, 100, 8)
    errs["bitwise_over_launches_and_graph_replay"] = True
    return errs


def k3_time(cfg, B, S, exp_per_s, ptxas=None):
    """K3 and its plain version timed with CUDA events on inputs shaped as
    the model passes them (B_ and C_ strided views of one projection),
    cycling through two input sets of ~0.5 GB each or more, beside the
    bound: the larger of the bytes over the memory rate and the
    exponentials and f32 operations over their rates."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import sm_count
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.roofline.hw import bound

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
    plan = ssm_ops.plan(B, Din, N, sm_count(torch.device("cuda")))
    ms = time_ms(torch, lambda i: ssm_ops.ssm_scan(*sets[i]), 2, reps=5)
    plain_ms = time_ms(torch, lambda i: ssm_scan_ref(*sets[i]), 1, reps=1)
    ms_2 = time_ms(torch, lambda i: ssm_ops.ssm_scan(*sets[i]), 2, reps=5)
    # the bound from roofline/: K3's cost of these inputs (f32 bytes,
    # FLOPs and exponentials) over the card's rates
    cost = ssm_ops.cost(*sets[0])
    b = bound(cost, torch.float32, exps_per_s=exp_per_s)
    return {"ms": ms, "ms_repeat": ms_2, "plain_ms": plain_ms,
            "bound_ms": b["bound_s"] * 1e3, "bound_by": b["bound_by"],
            "bound_share": b["bound_s"] * 1e3 / ms, "bytes": cost["bytes"],
            "bytes_ms": b["bytes_s"] * 1e3, "exps": cost["exps"],
            "exp_ms": b["exps_s"] * 1e3, "flops": cost["flops"],
            "flop_ms": b["flops_s"] * 1e3, "plan": plan,
            "ptxas": (ptxas or {}).get(
                f"ssm_scan_kernel<{N},{plan['group']}>"),
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
    from repro_torch.roofline.hw import bound

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
    # the bound from roofline/: K2's cost over the slots this run's pos
    # makes live (the ring's min(W, pos + 1)) over the card's rates
    cost = ops.cost(qs[0], ks[0], vs[0], slots=pos_val + 1)
    b = bound(cost, torch.bfloat16)
    bound_ms, nbytes, flops = b["bound_s"] * 1e3, cost["bytes"], \
        cost["flops"]
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": b["bound_by"],
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
    from repro_torch.roofline.hw import bound

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
    # the bound from roofline/: K1's cost (the unmasked pairs' products;
    # q, k, v and the output once each) over the card's rates
    cost = fa_ops.cost(qs[0], ks[0], vs[0], causal=True, window=window)
    b = bound(cost, torch.bfloat16)
    bound_ms, nbytes, flops = b["bound_s"] * 1e3, cost["bytes"], \
        cost["flops"]
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": b["bound_by"],
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
    f32, h_all and h_last equal to the bit), every case through the
    wrapper's path and through each path forced where it takes the shape;
    and each path bitwise over launches and a CUDA-graph replay at the
    forward and prefill shapes. Returns, per case group (and path), the
    max abs errors of h_all and of h_last."""
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.testing import check_rglru_scan, check_rglru_scan_bitwise

    W = cfg.lru_width
    errs: dict = {}

    def case(key, *a, **kw):
        for path in (None, *lru_ops.PATHS):
            if path == "tma" and not lru_ops.tma_maps(
                    a[2], 4 * kw.get("offset", False), 0):
                continue
            got = check_rglru_scan(*a, path=path, **kw)
            k = key if path is None else f"{key}_{path}"
            errs[k] = [max(x, y) for x, y in zip(errs.get(k, got), got)]

    for shape in ((2, 64, 32), (1, 96, 64)):
        case("grid", *shape)
    case("chained", 1, 40, 16, split=17)
    case("chained", FWD_BATCH, FWD_SEQ, W, split=1000)
    case("ragged", FWD_BATCH, 4000, 2600)
    case("ragged", BATCH, 2000, 2600)         # "registers" by the wrapper
    case("ragged", 3, 9, 33)
    case("ragged", 1, 1, 5)
    case("offset", 2, 100, W, offset=True)    # a, b off 16 bytes
    case("forward", FWD_BATCH, FWD_SEQ, W)
    case("prefill", BATCH, PROMPT, W)
    for B, S in ((FWD_BATCH, FWD_SEQ), (BATCH, PROMPT)):
        for path in (None, *lru_ops.PATHS):
            check_rglru_scan_bitwise(B, S, W, path=path)
    errs["bitwise_over_launches_and_graph_replay"] = True
    return errs


def k4_bytes_in_flight(plan, B, W, sms):
    """Bytes of a and b K4 keeps in flight card-wide under ``plan``:
    "tma" its ring in every block resident at once (as many as an SM's
    228 KB of shared memory holds, each block taking its ring, two output
    boxes, 128 bytes of alignment and the 1 KB the runtime reserves);
    "registers" its steps in flight a channel."""
    if plan["path"] == "registers":
        return B * W * plan["steps_in_flight"] * 8
    box = plan["steps_per_stage"] * plan["channels_per_block"] * 4
    block_smem = (2 * plan["stages"] + 2) * box + 128 + 1024
    resident = min(plan["blocks"], 228 * 1024 // block_smem * sms)
    return resident * plan["stages"] * 2 * box


def k4_time(cfg, B, S, ptxas=None):
    """K4 and its plain version timed with CUDA events, cycling through two
    input sets of 168 MB or more (a and b), beside the bound: the bytes
    over the memory rate (a, b and h0 read, h_all and h_last written);
    with the plan, each path forced, a device copy of a (two thirds of
    K4's bytes: the card's streaming rate at this size, timed only), the
    wrapper's host time a call and each kernel instance's registers and
    spills."""
    import torch

    from repro_torch.kernels import sm_count
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.roofline.hw import bound

    W = cfg.lru_width
    g = torch.Generator(device="cuda").manual_seed(3)
    sets = [(torch.rand(B, S, W, generator=g, device="cuda"),
             torch.randn(B, S, W, generator=g, device="cuda"),
             torch.randn(B, W, generator=g, device="cuda"))
            for _ in range(2)]
    sms = sm_count(torch.device("cuda"))
    plan = lru_ops.plan(B, S, W, sms)
    plan["bytes_in_flight"] = k4_bytes_in_flight(plan, B, W, sms)
    ms = time_ms(torch, lambda i: lru_ops.rglru_scan(*sets[i]), 2, reps=10)
    plain_ms = time_ms(torch, lambda i: rglru_scan_ref(*sets[i]), 1, reps=1)
    path_ms = {p: time_ms(torch, lambda i: lru_ops._launch(*sets[i], p), 2,
                          reps=10) for p in lru_ops.PATHS}
    ms_2 = time_ms(torch, lambda i: lru_ops.rglru_scan(*sets[i]), 2,
                   reps=10)
    dst = torch.empty_like(sets[0][0])
    copy_ms = time_ms(torch, lambda i: dst.copy_(sets[i][0]), 2, reps=10)
    host = host_us(torch, lambda: lru_ops.rglru_scan(*sets[0]))
    # the bound from roofline/: K4's cost over the card's rates
    cost = lru_ops.cost(*sets[0])
    b = bound(cost, torch.float32)
    nbytes, flops = cost["bytes"], cost["flops"]
    bytes_ms, flop_ms = b["bytes_s"] * 1e3, b["flops_s"] * 1e3
    bound_ms = b["bound_s"] * 1e3
    return {"ms": ms, "ms_repeat": ms_2, "plain_ms": plain_ms,
            "path_ms": path_ms, "plan": plan, "copy_ms": copy_ms,
            "copy_tb_per_s": 8 * B * S * W / copy_ms / 1e9,
            "tb_per_s": nbytes / ms / 1e9,
            "host_us_per_call": host,
            "bound_ms": bound_ms, "bound_by": b["bound_by"],
            "bound_share": bound_ms / ms, "bytes": nbytes,
            "bytes_ms": bytes_ms, "flops": flops, "flop_ms": flop_ms,
            "ptxas": ptxas,
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
    capacity of MOE_CAPACITIES in bf16; each bf16 kernel ("wgmma",
    "mma") at 1 to 1280 rows, on either side of its tiles, and at qwen3's
    widths; the shapes TMA cannot map (they fall to "mma");
    ``moe_ffn`` (three launches) against ``moe_ffn_ref``; and each path
    bitwise over launches and a CUDA-graph replay. Returns, per case
    group, the max abs error and the normwise relative error."""
    import torch

    from repro_torch.testing import (check_grouped_gemm,
                                     check_grouped_gemm_bitwise,
                                     check_moe_ffn)

    errs: dict = {}

    def case(key, check, *a, **kw):
        got = check(*a, **kw)
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
    # every bf16 path from the decode's rows to the prefill's, on either
    # side of the wgmma kernel's 128-row tiles (K and N off the slices and
    # tiles), and at qwen3's widths at the decode's 8 rows
    for path in ("wgmma", "mma"):
        for M in (1, 7, 8, 9, 63, 64, 65, 127, 129, 640, 1280):
            case(f"path_{path}", check_grouped_gemm, 3, M, 200, 136, bf16,
                 path=path)
        case(f"path_{path}_qwen3", check_grouped_gemm, E, 8, D, F, bf16,
             path=path)
        case(f"path_{path}_qwen3", check_grouped_gemm, E, 8, F, D, bf16,
             path=path)
    # TMA cannot map these: K or N off 8, x's base off 16 bytes
    case("mma_fallback", check_grouped_gemm, 3, 640, D - 1, F, bf16)
    case("mma_fallback", check_grouped_gemm, 3, 8, D, F - 1, bf16)
    case("mma_fallback", check_grouped_gemm, 3, 8, D, F, bf16, offset=True)
    case("moe_ffn_float32", check_moe_ffn, 4, 64, 32, 48, torch.float32)
    case("moe_ffn_bfloat16", check_moe_ffn, E, MOE_CAPACITIES["decode"], D,
         F, bf16)
    for path, M in (("wgmma", MOE_CAPACITIES["forward"]),
                    ("wgmma", MOE_CAPACITIES["decode"]), ("mma", 100)):
        check_grouped_gemm_bitwise(E, M, D, F, bf16, path=path)
    check_grouped_gemm_bitwise(16, 50, 512, 768, torch.float32, path="fma")
    errs["bitwise_over_launches_and_graph_replay"] = True
    return errs


def k5_time(E, M, K, N, seed, paths=()):
    """K5, its plain version and torch.bmm (timed only; the port never
    calls it) with CUDA events over two distinct bf16 x/w sets (w alone is
    0.4 GB a set at qwen3's shapes, beyond the 50 MB L2), beside the
    bound: the larger of the bytes over the memory rate (x and w read and
    the output written, each once) and the products over the bf16
    tensor-core rate. ``paths``: each named kernel also timed on the same
    sets."""
    import torch

    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref
    from repro_torch.roofline.hw import bound

    g = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    sets = [(torch.randn(E, M, K, generator=g, device="cuda").to(bf16),
             (torch.randn(E, K, N, generator=g, device="cuda")
              * K ** -0.5).to(bf16)) for _ in range(2)]

    def kernel(i, path=None):
        if path is None:
            return gg_ops.grouped_gemm(*sets[i])
        return gg_ops._launch(*sets[i], path)

    def plain(i):
        return grouped_gemm_ref(*sets[i])

    def library(i):
        return torch.bmm(*sets[i])

    lib_err = float((library(0).float() - kernel(0).float()).abs().max())
    ms = time_ms(torch, kernel, 2, reps=10)
    plain_ms = time_ms(torch, plain, 2, reps=1)
    library_ms = time_ms(torch, library, 2, reps=10)
    ms_2 = time_ms(torch, kernel, 2, reps=10)
    path_ms = {p: time_ms(torch, lambda i, p=p: kernel(i, p), 2, reps=10)
               for p in paths}
    # the bound from roofline/: K5's cost over the card's rates
    cost = gg_ops.cost(*sets[0])
    b = bound(cost, bf16)
    flops, nbytes = cost["flops"], cost["bytes"]
    bytes_ms, ops_ms = b["bytes_s"] * 1e3, b["flops_s"] * 1e3
    bound_ms = b["bound_s"] * 1e3
    x, w = sets[0]
    return {"ms": ms, "ms_repeat": ms_2, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": b["bound_by"],
            "bound_share": bound_ms / ms, "bytes": nbytes,
            "bytes_ms": bytes_ms, "flops": flops, "flop_ms": ops_ms,
            "path": gg_ops.choose_path(bf16, M, K, N, x.data_ptr(),
                                       w.data_ptr()),
            "path_ms": path_ms,
            "shape": {"E": E, "M": M, "K": K, "N": N, "dtype": "bfloat16"},
            "library_max_abs_err": lib_err, "library_call": "torch.bmm"}


def train_phase():
    """glm4-9b at full width, TRAIN_LAYERS of its layers, on the "xla"
    path (the reference's train path), under deterministic mode: 8 steps
    through PShell.run (one dispatch a step, serial drains), then from a
    fresh draw of the same seed through PShell.run_grouped of
    make_group_step (the first window run eagerly; the second captured,
    then replayed), then run_grouped with the shell off.
    Gates: the grouped run's whole state (params, m, v, count, step),
    every step's metrics and every drained record (commit rows, counts,
    dropped credits, CSRs) equal to the per-step run's to the bit, kept
    on the host; the shell-off params equal too; one commit row a layer a
    step, none dropped; no kernel of the port launched (the train path is
    plain, as in the reference); the loss lower after 8 steps than at the
    first. Then times, with CUDA events after one warm-up call each, a
    graph replay of a window and an eager run of the same window (4
    steps each, state advancing).
    Returns the record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import Runtime
    from repro_torch.testing import (assert_records_equal,
                                     assert_trees_equal, deterministic,
                                     train_run)
    from repro_torch.train import OptConfig
    from repro_torch.utils import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    rt = Runtime(attention_impl="xla", taps=TRAIN_TAPS)
    kw = dict(opt_cfg=OptConfig(lr=TRAIN_LR, warmup_steps=10))
    fn = make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    batches = [fn(i) for i in range(TRAIN_STEPS)]
    rec: dict = {"arch": cfg.name, "layers": TRAIN_LAYERS,
                 "of_layers": get_config(ARCH).num_layers,
                 "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                 "sample_interval": TRAIN_INTERVAL, "steps": TRAIN_STEPS,
                 "lr": TRAIN_LR, "warmup_steps": 10}
    with deterministic():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        a = train_run(cfg, rt, batches, TRAIN_INTERVAL, grouped=False,
                      **kw)
        expect_counts(counts(), {}, "train per step")
        rec["params"] = sum(t.numel() for t in
                            tree_leaves(a["state"]["params"]))
        rec["state_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(a["state"]))
        rec["per_step"] = {"seconds": a["seconds"],
                           "s_per_step": a["seconds"] / TRAIN_STEPS,
                           "max_memory_allocated":
                               torch.cuda.max_memory_allocated()}
        host = tree_map(lambda t: t.cpu(), a["state"])
        recs_a = a["records"]
        del a
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        b = train_run(cfg, rt, batches, TRAIN_INTERVAL, **kw)
        expect_counts(counts(), {}, "train grouped")
        assert b["windows"] == {"graph": 1, "eager": 1}, b["windows"]
        assert_trees_equal(host, b["state"], "train state, fused vs "
                           "per step")
        assert_records_equal(recs_a, b["records"], "train records, fused "
                             "vs per step")
        rec["grouped"] = {"seconds": b["seconds"],
                          "s_per_step": b["seconds"] / TRAIN_STEPS,
                          "windows": b["windows"],
                          "capture_s": b["engine"].capture_s,
                          "max_memory_allocated":
                              torch.cuda.max_memory_allocated()}
        # window timing on the card, state advancing: one replay of the
        # captured window, then the same window run eagerly
        graphs = b["engine"]
        window = graphs.graphs[TRAIN_INTERVAL]
        replay_ms = time_ms(torch, lambda i: window.graph.replay(), 1, 2)
        state, shell_in, xs_in = window.state_in, window.shell_in, \
            window.xs_in
        graphs.graphs.clear()
        del window, b
        torch.cuda.empty_cache()
        eager_ms = time_ms(
            torch, lambda i: graphs.engine(state, shell_in, xs_in), 1, 1)
        rec["window_ms"] = {"graph_replay": replay_ms, "eager": eager_ms,
                            "graph_ms_per_step": replay_ms / TRAIN_INTERVAL,
                            "eager_ms_per_step": eager_ms / TRAIN_INTERVAL}
        del graphs, state, shell_in, xs_in
        torch.cuda.empty_cache()
        c = train_run(cfg, rt, batches, TRAIN_INTERVAL, shell=False, **kw)
        assert_trees_equal(host["params"], c["state"]["params"],
                           "train params, shell off vs on")
        del c
        torch.cuda.empty_cache()
    losses = np.concatenate([r["metrics"]["loss"] for _, r in recs_a])
    commits = [r["fifos"]["commits"] for _, r in recs_a]
    assert all(f["count"] == TRAIN_INTERVAL * TRAIN_LAYERS
               and f["dropped"] == 0 for f in commits), commits
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    rec.update(losses=losses.tolist(),
               grad_norms=np.concatenate(
                   [r["metrics"]["grad_norm"] for _, r in recs_a]).tolist(),
               commit_rows=[f["count"] for f in commits],
               dropped=[f["dropped"] for f in commits],
               bitwise_fused_vs_per_step=True, bitwise_shell_off=True)
    return rec


def train_parity_phase():
    """One make_group_step window (3 steps) of each family's smoke config
    in f32, on the card and on the host from the same state
    (``testing.check_train_parity``). Returns the errors per arch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.testing import check_train_parity
    return {arch: check_train_parity(dataclasses.replace(
        get_smoke_config(arch), dtype="float32"))
        for arch in (ARCH, SSM_ARCH, HYB_ARCH, MOE_ARCH)}


def _nbytes(tree):
    from repro_torch.utils import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _recording(step, sink, on):
    """``step`` that, while ``on[0]``, keeps a device copy of each step's
    commit checksums in ``sink`` (no host sync; eager runs only)."""
    from repro_torch.core.commit import layer_checksums

    def recorded(state, batch):
        out = step(state, batch)
        if on[0]:
            sink.append(layer_checksums(out[2]).detach().clone())
        return out
    return recorded


def _layer_errors(sink):
    """max over steps of the co-emulator's relative error, per layer and
    component ([mean, mean |x|]), from a recorded DUT and oracle."""
    import torch
    n = len(sink) // 2
    d = torch.stack(sink[0::2]).cpu().double().numpy()
    o = torch.stack(sink[1::2]).cpu().double().numpy()
    assert d.shape[0] == n
    return (np.abs(d - o) / (np.abs(o) + 1e-6)).max(axis=0)


def _timed_verify(emu, *args, **kw):
    """emu.verify(...) between two synchronises: the report, and the wall
    and CUDA-event span a verified step (the span includes the card's idle
    time between dispatches)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    rep = emu.verify(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return rep, {"wall_s": wall, "verified_steps_per_s": rep.steps / wall,
                 "wall_ms_per_step": wall * 1e3 / rep.steps,
                 "device_span_ms_per_step":
                     start.elapsed_time(end) / rep.steps}


def _windows(emu):
    return {side: dict(engine.windows) for side, engine in
            emu._engines.items()}


def coemu_phase():
    """CoEmulator at granite-8b's full width on COEMU_LAYERS layers (see
    the module docstring, phase 38). Returns the record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import CoEmulator
    from repro_torch.core.coemu import inject_fault
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import Runtime, build_model
    from repro_torch.testing import (assert_trees_equal, deterministic,
                                     forward_step)
    from repro_torch.train import init_state, make_train_step
    from repro_torch.utils import tree_leaves, tree_map

    # the golden model in f32: no TF32 in its products
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    cfg = dataclasses.replace(get_config(COEMU_ARCH), num_layers=COEMU_LAYERS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    commits = frozenset({"commits"})
    model = build_model(cfg, Runtime(attention_impl="xla", taps=commits))
    model32 = build_model(cfg32, Runtime(attention_impl="xla", taps=commits))
    step, step32 = make_train_step(model), make_train_step(model32)
    fn = make_batch_fn(cfg, COEMU_BATCH, COEMU_SEQ, 0)
    batches = [fn(i) for i in range(COEMU_STEPS)]
    rec: dict = {"arch": cfg.name, "layers": COEMU_LAYERS,
                 "of_layers": get_config(COEMU_ARCH).num_layers,
                 "batch": COEMU_BATCH, "seq": COEMU_SEQ,
                 "steps": COEMU_STEPS, "group_size": COEMU_GROUP,
                 "allow_tf32": torch.backends.cuda.matmul.allow_tf32}

    def host(tree):
        return tree_map(lambda t: t.cpu(), tree)

    def _mem():
        return {"allocated": torch.cuda.memory_allocated(),
                "reserved": torch.cuda.memory_reserved(),
                "max_allocated": torch.cuda.max_memory_allocated()}
    mem: dict = {}
    rec["memory"] = mem

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with deterministic():
        state = init_state(model, 0, device="cuda")
        kept = host(state)
        rec["params"] = sum(t.numel() for t in
                            tree_leaves(state["params"]))
        # (a) clean self-verify, three modes; (b) faults named at full
        # width, step-locked before any window is captured (an eager step
        # beside the sides' graph pool would not fit), group-locked after,
        # the same graphs replayed on the faulted and the clean copies
        emu = CoEmulator(step, step, rtol=1e-6)
        rep_s, t_s = _timed_verify(emu, state, state, batches)
        mem["self_verify_step_locked"] = _mem()
        faults = {}
        for k in COEMU_FAULT_LAYERS:
            bad = {**state, "params": inject_fault(state["params"], cfg, k)}
            rep = emu.verify(bad, state, batches)
            del bad
            assert rep.diverged and \
                (rep.first.step, rep.first.layer) == (0, k), (k, rep)
            faults[k] = [rep.summary()]
        rep_g, t_g = _timed_verify(emu, state, state, batches,
                                   group_size=COEMU_GROUP)
        mem["self_verify_group_locked"] = _mem()
        windows = _windows(emu)
        rep_ser, t_ser = _timed_verify(emu, state, state, batches,
                                       group_size=COEMU_GROUP,
                                       overlap=False)
        for rep in (rep_s, rep_g, rep_ser):
            assert rep.steps == COEMU_STEPS and not rep.diverged, rep
            assert rep.max_rel_err == 0.0 and rep.loss_max_abs_diff == 0.0
        assert rep_s == rep_g == rep_ser, (rep_s, rep_g, rep_ser)
        assert windows == {side: {"graph": 1, "eager": 1}
                           for side in ("dut", "orc")}, windows
        rec["self_verify"] = {
            "step_locked": t_s, "group_locked": t_g, "serial": t_ser,
            "windows_first_grouped_call": windows,
            "capture_s": {side: e.capture_s
                          for side, e in emu._engines.items()},
            "summary": rep_s.summary()}
        for k in COEMU_FAULT_LAYERS:
            bad = {**state, "params": inject_fault(state["params"], cfg, k)}
            rep = emu.verify(bad, state, batches, group_size=COEMU_GROUP)
            del bad
            assert rep.diverged and \
                (rep.first.step, rep.first.layer) == (0, k), (k, rep)
            faults[k].append(rep.summary())
        assert all(w["eager"] == 1 for w in _windows(emu).values())
        rec["faults"] = faults
        rec["windows_after_faults"] = _windows(emu)
        del emu
        torch.cuda.empty_cache()
        # (c) determinism on clones
        assert CoEmulator.determinism(step, state, batches[0])
        assert_trees_equal(kept, state, "caller's state after (a)-(c)")
        rec["determinism"] = True
        torch.cuda.empty_cache()
        # (d) the bf16 DUT against the f32 oracle from the same seed
        state32 = init_state(model32, 0, device="cuda")
        kept32 = host(state32)
        rec["state_bytes"] = {"dut": _nbytes(state), "orc": _nbytes(state32)}
        sink, on = [], [True]
        emu = CoEmulator(_recording(step, sink, on),
                         _recording(step32, sink, on), rtol=COEMU_BF16_RTOL)
        torch.cuda.reset_peak_memory_stats()
        rep_s, t_s = _timed_verify(emu, state, state32, batches)
        mem["bf16_vs_f32_step_locked"] = _mem()
        on[0] = False
        rep_g1, t_g1 = _timed_verify(emu, state, state32, batches,
                                     group_size=COEMU_GROUP)
        rep_ser, t_ser = _timed_verify(emu, state, state32, batches,
                                       group_size=COEMU_GROUP, overlap=False)
        rep_g, t_g = _timed_verify(emu, state, state32, batches,
                                   group_size=COEMU_GROUP)
        mem["bf16_vs_f32_group_locked"] = _mem()
        errs = _layer_errors(sink)
        assert np.isfinite(errs).all() and \
            np.isfinite(rep_s.loss_max_abs_diff), (errs, rep_s)
        assert float(errs.max()) == rep_s.max_rel_err
        assert rep_g == rep_g1 == rep_ser == rep_s, (rep_s, rep_g, rep_ser)
        rec["bf16_vs_f32"] = {
            "rtol": COEMU_BF16_RTOL, "summary": rep_s.summary(),
            "diverged_at_rtol": rep_s.diverged,
            "max_rel_err": rep_s.max_rel_err,
            "max_rel_err_per_layer_mean_absmean": errs.tolist(),
            "loss_max_abs_diff": rep_s.loss_max_abs_diff,
            "step_locked": t_s, "group_locked": t_g, "serial": t_ser,
            "group_locked_first_call": t_g1,
            "windows": _windows(emu),
            "capture_s": {side: e.capture_s
                          for side, e in emu._engines.items()},
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del emu, sink
        torch.cuda.empty_cache()
        assert_trees_equal(kept, state, "caller's DUT state after (d)")
        assert_trees_equal(kept32, state32, "caller's oracle state after (d)")
        del kept, kept32
        # (e) the kernel path: a forward-only step on K1
        params, params32 = state["params"], state32["params"]
        del state, state32
        torch.cuda.empty_cache()
        kstep = forward_step(build_model(cfg, Runtime(attention_impl="cuda",
                                                      taps=commits)))
        xstep32 = forward_step(model32)
        kern: dict = {}
        for g in (1, COEMU_GROUP):
            sink, on = [], [g == 1]
            emu = CoEmulator(_recording(kstep, sink, on),
                             _recording(xstep32, sink, on),
                             rtol=COEMU_BF16_RTOL)
            reset_counts()
            rep, t = _timed_verify(emu, params, params32, batches,
                                   group_size=g)
            expect_counts(counts(), {"k1": COEMU_LAYERS * COEMU_STEPS},
                          f"kernel DUT, group {g}")
            entry = {"summary": rep.summary(),
                     "max_rel_err": rep.max_rel_err,
                     "loss_max_abs_diff": rep.loss_max_abs_diff,
                     "k1_launches": counts()["k1"], **t}
            if g == 1:
                errs = _layer_errors(sink)
                assert np.isfinite(errs).all(), errs
                entry["max_rel_err_per_layer_mean_absmean"] = errs.tolist()
            else:
                entry["windows"] = _windows(emu)
            kern[f"group_{g}"] = entry
            del emu, sink
        k = COEMU_KERNEL_FAULT_LAYER
        bad = inject_fault(params, cfg, k)
        emu = CoEmulator(kstep, kstep)
        for g in (1, COEMU_GROUP):
            reset_counts()
            rep = emu.verify(bad, params, batches, group_size=g)
            assert rep.diverged and (rep.first.step, rep.first.layer) == \
                (0, k), (g, rep)
            expect_counts(counts(), {"k1": 2 * COEMU_LAYERS * COEMU_STEPS},
                          f"kernel fault, group {g}")
            kern[f"fault_group_{g}"] = rep.summary()
        kern["windows_fault"] = _windows(emu)
        rec["kernel_dut"] = kern
        del emu, bad, params, params32
        torch.cuda.empty_cache()
    return rec


def loop_phase():
    """train_loop with the commit-stream verifier at granite-8b's full
    width on LOOP_LAYERS layers (see the module docstring, phase 39).
    Returns the record."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.coemu import CommitDivergence
    from repro_torch.models import Runtime, build_model
    from repro_torch.roofline import WindowCapture
    from repro_torch.testing import deterministic
    from repro_torch.train import (LoopConfig, init_state, make_train_step,
                                   train_loop)

    cfg = dataclasses.replace(get_config(COEMU_ARCH), num_layers=LOOP_LAYERS)
    model = build_model(cfg, Runtime(attention_impl="xla",
                                     taps=frozenset({"commits"})))
    oracle = make_train_step(model)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    run = tmp / "run"
    lc = LoopConfig(steps=LOOP_STEPS, batch=COEMU_BATCH, seq=COEMU_SEQ,
                    sample_interval=LOOP_INTERVAL,
                    checkpoint_every=LOOP_EVERY, checkpoint_dir=str(run))
    rec: dict = {"arch": cfg.name, "layers": LOOP_LAYERS,
                 "steps": LOOP_STEPS, "sample_interval": LOOP_INTERVAL,
                 "checkpoint_every": LOOP_EVERY,
                 "disk_free_bytes": shutil.disk_usage(tmp).free}
    try:
        with deterministic():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            capture = WindowCapture()
            clean = train_loop(model, lc, resume=False, oracle_step=oracle,
                               capture=capture)
            torch.cuda.synchronize()
            rec["clean"] = {"seconds": time.perf_counter() - t0,
                            "profile": clean["profile"],
                            "losses": clean["losses"]}
            # phase 57 (b): the loop's capture, one row a window, each
            # timed on the card, within the loop's wall
            roof = clean["roofline"]
            assert (roof["windows"], roof["steps"]) == (
                LOOP_STEPS // LOOP_INTERVAL, LOOP_STEPS), roof
            dev_s = [r["device_s"] for r in capture.rows]
            assert [r["window"] for r in capture.rows] == list(
                range(LOOP_STEPS // LOOP_INTERVAL)), capture.rows
            assert all(d is not None and d > 0 for d in dev_s), dev_s
            assert sum(dev_s) <= rec["clean"]["seconds"], (
                dev_s, rec["clean"]["seconds"])
            rec["roofline"] = {**roof, "window_device_s": dev_s}
            print(f"roofline loop: {rec['roofline']}", flush=True)
            assert CheckpointManager(str(run)).steps() == [4, 8]
            assert np.isfinite(clean["losses"]).all(), clean["losses"]
            rec["state_bytes"] = _nbytes(clean["state"])
            last = run / "step_00000008"
            rec["bytes_written_per_save"] = sum(
                f.stat().st_size for f in last.iterdir())
            shutil.rmtree(last)
            t0 = time.perf_counter()
            CheckpointManager(str(run)).save(clean["state"], 8,
                                             blocking=True)
            rec["seconds_per_blocking_save"] = time.perf_counter() - t0
            shutil.rmtree(last)         # resume from step 4 below
            del clean["state"]
            torch.cuda.empty_cache()
            for fused in (True, False):
                vdir = tmp / f"veto_{'fused' if fused else 'per_step'}"
                bad = init_state(model, 99, device="cuda")
                try:
                    train_loop(model, dataclasses.replace(
                        lc, steps=LOOP_EVERY, fused=fused,
                        checkpoint_dir=str(vdir)), resume=False,
                        oracle_step=oracle, oracle_state=bad)
                except CommitDivergence as e:
                    rec[f"veto_{'fused' if fused else 'per_step'}"] = str(e)
                else:
                    raise AssertionError("the faulted oracle did not veto")
                assert CheckpointManager(str(vdir)).steps() == []
                del bad
                torch.cuda.empty_cache()
            resumed = train_loop(model, lc, resume=True, oracle_step=oracle)
            assert resumed["losses"] == clean["losses"][LOOP_EVERY:], (
                resumed["losses"], clean["losses"])
            assert CheckpointManager(str(run)).steps() == [4, 8]
            rec["resumed_losses_bitwise"] = True
            del resumed
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def _unfused_update_ops(spec, ys):
    """Device operations (kernels, copies, fills) one eager counter update
    of the plane launches on a window's ys, read from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scope import make_update, scope_init
    upd = make_update(spec)
    sc = scope_init(spec, device="cuda")
    upd(sc, ys)                      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        upd(sc, ys)
        torch.cuda.synchronize()
    evs = device_events(prof)
    return {"device_ops": len(evs),
            "device_us": sum(b - a for _, a, b in evs) / 1e3}


def scope_serve_phase(cfg, params):
    """serve() at the serve cell with the ZP-Scope plane (phase 40): the
    graph engine with the plane off, on unfused and on fused, then the
    eager engine with the plane on; all launch counts set to 0 just before
    each run, every window under sync-debug mode "error". Returns the
    record."""
    import torch

    from repro_torch.core.scope import ScopeSpec
    from repro_torch.launch.serve import serve
    from repro_torch.testing import (NoSyncInWindow, assert_serve_equal,
                                     check_scope_digests,
                                     private_pool_bytes,
                                     serve_window_digests, serve_kernels)
    from repro_torch.utils import tree_map

    steps = GEN - 1
    n_windows = -(-steps // INTERVAL)
    _, total_counts = serve_kernels(cfg, steps)
    spec = ScopeSpec(every_n_windows=SCOPE_EVERY)
    runs, rec = {}, {"every_n_windows": SCOPE_EVERY, "windows": n_windows}
    for name, graph, sc in (("off", True, None), ("unfused", True, spec),
                            ("fused", True,
                             dataclasses.replace(spec, fuse=True)),
                            ("eager", False, spec)):
        timer = NoSyncInWindow()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = serve(cfg, BATCH, PROMPT, GEN, seed=0,
                    sample_interval=INTERVAL, device="cuda", params=params,
                    timer=timer, graph=graph, return_cache=True, scope=sc)
        got = counts()
        expect_counts(got, total_counts, f"scope serve ({name})")
        assert timer.windows == n_windows, (name, timer.windows)
        assert out["windows_by_engine"] == {
            "graph": n_windows if graph else 0,
            "eager": 0 if graph else n_windows}, out["windows_by_engine"]
        r = {k: out[k] for k in ("decode_s", "decode_tok_per_s",
                                 "decode_window_ms", "capture_s", "engine")}
        r.update(k2_launches=got["k2"],
                 max_memory_allocated=torch.cuda.max_memory_allocated())
        if sc is not None:
            rep = out["scope"]
            assert rep["windows"] == n_windows and rep["steps"] == steps
            assert rep["tokens"] == float(BATCH * steps), rep["tokens"]
            r.update(samples=check_scope_digests(
                rep, serve_window_digests(out["tokens"], INTERVAL)),
                gates=rep["gates"], digest=rep["digest"])
        # the final cache waits on the host: its ``pos`` leaf is the last
        # replay's output, which lies in the graph's private pool
        out["cache"] = tree_map(lambda t: t.cpu(), out["cache"])
        runs[name] = out
        r["memory_after_serve"] = private_pool_bytes()
        rec[name] = r
    pools = [rec[n]["memory_after_serve"]
             for n in ("off", "unfused", "fused", "eager")]
    rec["memory_after_serve"] = pools
    print(f"scope serve: bytes in CUDA-graph private pools after each "
          f"run: {pools}", flush=True)
    assert max(pools[1:]) <= pools[1], \
        f"graph private pools grew across serves: {pools}"
    for name in ("unfused", "fused", "eager"):
        assert_serve_equal(runs[name], runs["off"],
                           f"scope serve, {name} vs off")
    assert rec["fused"]["samples"] == n_windows // SCOPE_EVERY
    assert rec["unfused"]["digest"] == rec["fused"]["digest"] \
        == rec["eager"]["digest"]
    ys = torch.tensor(np.asarray(runs["off"]["tokens"], np.int32)[
        :, 1:1 + INTERVAL].T[:, :, None].copy(), device="cuda")
    rec["unfused_update_per_window"] = _unfused_update_ops(spec, ys)
    rec["bitwise_vs_off"] = True
    return rec


def _farm_inputs(cfg, steps=FARM_STEPS):
    """Phase 50's activations and positions, drawn on the card from seed
    0 (phase 51 draws the same; phase 55 draws ``steps`` of them, whose
    first FARM_STEPS are these)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(FARM_BATCH, FARM_SEQ, cfg.d_model, generator=g,
                      device="cuda").to(torch.bfloat16)
          for _ in range(steps)]
    pos = torch.arange(FARM_SEQ, dtype=torch.int32, device="cuda")[
        None].expand(FARM_BATCH, FARM_SEQ).contiguous()
    return xs, pos


def _farm_run(cfg, params, xs, pos, layers, lanes, dut=None,
              mode="lockstep", trace=None):
    """One verify_subsystems pass (``submit_subsystem_jobs`` + the farm's
    run + finalize, so the counts can be set to 0 just before the farm
    pass, after the in-situ capture) on a FarmManager in ``mode``: 8
    virtual slots, lane capacity FARM_LANES with ``lanes``. ``trace`` (a
    dict) receives the device trace of the pass (``device_trace``).
    Returns (reports, {layer name: (steps, 2) host checksums}, launch
    counts, seconds, telemetry report, memory: the bytes allocated before
    the capture, before the farm pass and after the farm and its results
    are dropped, and the farm pass's peak)."""
    import torch

    from repro_torch.core.coemu import submit_subsystem_jobs
    from repro_torch.farm import FarmManager
    from repro_torch.models import Runtime

    mem = {"before_capture": torch.cuda.memory_allocated()}
    mgr = FarmManager(slots=FARM_SLOTS, lanes=FARM_LANES if lanes else 1,
                      evict_stragglers=False, mode=mode)
    with torch.inference_mode():
        finalize = submit_subsystem_jobs(
            mgr, params, cfg, Runtime(), xs, pos, layers,
            group_size=FARM_GROUP, rtol=FARM_RTOL, dut_params=dut,
            lanes=lanes)
        torch.cuda.synchronize()
        mem["before_run"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prof = None
        if trace is not None:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        reset_counts()
        t = time.perf_counter()
        rep = mgr.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = counts()
        mem["peak_in_run"] = torch.cuda.max_memory_allocated()
        if prof is not None:
            prof.stop()
            trace.update(device_trace(prof, len(layers) * len(xs)),
                         seconds=secs)
    cks = {name: torch.cat([y for _, _, y in outs])
           for name, outs in mgr.outputs.items()}
    assert all(j["status"] == "done" for j in rep["jobs"].values()), rep
    tele = rep["telemetry"]
    reports = finalize()
    del mgr, finalize, rep
    mem["after_run"] = torch.cuda.memory_allocated()
    # nothing of the pass outlives it: the captures, the boards and the
    # lane stacks are freed by reference counting alone
    assert mem["after_run"] - mem["before_capture"] < 2**30, mem
    return reports, cks, got, secs, tele, mem


def _board_timing(cfg, params, xs, pos, reps=3):
    """One board of phase 50 outside the farm, timed with CUDA events:
    its engine on one window (FARM_GROUP steps of layer 0) and the replay
    copy the farm makes of its state at each admission (and, on the host
    clock, FARM_SLOTS such copies into fresh memory); ms each."""
    import torch

    from repro_torch.core.coemu import _stack_on_device, subsystem_boards
    from repro_torch.farm.manager import _replay_copy
    from repro_torch.models import Runtime

    with torch.inference_mode():
        engine, state, x_ins, _, _ = subsystem_boards(
            params, cfg, Runtime(), xs[:1], pos, [0])[0]
        stack = _stack_on_device(x_ins * FARM_GROUP)
        out: dict = {}
        # the admission of a wave of FARM_SLOTS boards: each a replay
        # copy into fresh device memory (the copies are kept, as the
        # farm's results keep them), host clock after a sync
        torch.cuda.synchronize()
        t = time.perf_counter()
        kept = [_replay_copy(state) for _ in range(FARM_SLOTS)]
        torch.cuda.synchronize()
        out["fresh_replay_copy_ms"] = \
            (time.perf_counter() - t) * 1e3 / FARM_SLOTS
        del kept
        for name, fn in (("window", lambda: engine(state, {}, stack)),
                         ("replay_copy", lambda: _replay_copy(state))):
            fn()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            out[f"{name}_ms"] = start.elapsed_time(end) / reps
    out["board_step_ms"] = out["window_ms"] / FARM_GROUP
    return out


def farm_phase(cfg, params):
    """verify_subsystems on every layer of ``cfg`` at full width (phase
    50; see the module docstring). Returns the record."""
    import torch

    from repro_torch.core.coemu import inject_fault

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xs, pos = _farm_inputs(cfg)
    layers = list(range(cfg.num_layers))
    L = cfg.num_layers
    rec: dict = {"steps": FARM_STEPS, "batch": FARM_BATCH, "seq": FARM_SEQ,
                 "group": FARM_GROUP, "slots": FARM_SLOTS,
                 "lane_capacity": FARM_LANES, "layers": L, "rtol": FARM_RTOL}
    cks = {}
    for mode in ("solo", "lanes"):
        reports, cks[mode], got, secs, tele, mem = _farm_run(
            cfg, params, xs, pos, layers, lanes=mode == "lanes")
        bad = {k: r.summary() for k, r in reports.items() if r.diverged}
        assert not bad, (mode, bad)
        runs = L // FARM_LANES if mode == "lanes" else L
        expect_counts(got, {"k1": runs * FARM_STEPS}, f"farm ({mode})")
        dispatches = sum(d["dispatch_ms"]["n"]
                         for d in tele["devices"].values())
        assert dispatches == runs * -(-FARM_STEPS // FARM_GROUP), \
            (mode, dispatches)
        rec[mode] = {
            "k1_launches": got["k1"], "seconds": secs,
            "board_steps_per_s": L * FARM_STEPS / secs,
            "window_dispatches": dispatches,
            "max_rel_err": max(r.max_rel_err for r in reports.values()),
            "lanes_per_dispatch_max": tele["lanes_per_dispatch_max"],
            "occupancy_peak": tele["occupancy_peak"],
            "dispatch_ms_p50": {s: d["dispatch_ms"].get("p50")
                                for s, d in tele["devices"].items()},
            "window_ms_p50": {s: d["window_ms"].get("p50")
                              for s, d in tele["devices"].items()},
            "memory": mem,
        }
        print(f"farm {mode}: {L * FARM_STEPS / secs:.2f} board-steps/s, "
              f"{dispatches} window dispatches, K1 {got['k1']}, "
              f"memory {mem}", flush=True)
    rec["board"] = _board_timing(cfg, params, xs, pos)
    print(f"farm board: {rec['board']}", flush=True)
    errs = {n: float(((cks["lanes"][n].double() - cks["solo"][n].double())
                      .abs() / cks["solo"][n].double().abs()).max())
            for n in cks["solo"]}
    rec["lanes_vs_solo"] = {
        "max_rel_err": max(errs.values()),
        "bitwise": all(torch.equal(cks["lanes"][n], cks["solo"][n])
                       for n in cks["solo"]),
        "bitwise_layers": sum(torch.equal(cks["lanes"][n], cks["solo"][n])
                              for n in cks["solo"])}
    assert rec["lanes_vs_solo"]["max_rel_err"] <= FARM_RTOL, \
        rec["lanes_vs_solo"]
    faults = {}
    for layer in (FARM_FAULT_LAYERS[0], FARM_FAULT_LAYERS[-1]):
        bad = inject_fault(params, cfg, layer)
        for mode in ("solo", "lanes"):
            reports, _, got, _, tele, mem = _farm_run(
                cfg, params, xs, pos, FARM_FAULT_LAYERS,
                lanes=mode == "lanes", dut=bad)
            named = {k: (r.first.step, r.first.layer)
                     for k, r in reports.items() if r.diverged}
            print(f"farm fault at layer {layer} ({mode}): " + ", ".join(
                f"{k} max_rel_err {r.max_rel_err:.4g} first {r.first}"
                for k, r in reports.items()), flush=True)
            assert named == {f"layer{layer}": (0, layer)}, (mode, named)
            if mode == "lanes":
                assert tele["lanes_per_dispatch_max"] == \
                    len(FARM_FAULT_LAYERS), tele["lanes_per_dispatch_max"]
            faults[f"layer{layer}_{mode}"] = {
                "named": named[f"layer{layer}"],
                "rel_err": reports[f"layer{layer}"].first.rel_err,
                "k1_launches": got["k1"], "memory": mem}
        del bad
        torch.cuda.empty_cache()
    rec["faults"] = faults
    rec["peak_memory_allocated"] = max(
        r["memory"]["peak_in_run"]
        for r in [rec["solo"], rec["lanes"], *faults.values()])
    rec["solo_checksums"] = {n: cks["solo"][n].tolist()
                             for n in cks["solo"]}
    torch.cuda.empty_cache()
    return rec


def mixed_pass_phase(cfg, params, serve_rec, farm_rec):
    """Phase 51: one run_many pass of phase 3's graphed decode engine
    beside FARM_MIXED of phase 50's subsystem boards (see the module
    docstring). Returns the record."""
    import torch

    from repro_torch.core.coemu import _stack_on_device, subsystem_boards
    from repro_torch.core.schedule import (Client, WindowScheduler,
                                           iter_windows)
    from repro_torch.models import Runtime
    from repro_torch.testing import serve_decode_client

    torch.cuda.empty_cache()
    xs, pos = _farm_inputs(cfg)
    layers = list(range(FARM_MIXED))
    ys = {li: [] for li in layers}
    with torch.inference_mode():
        boards = subsystem_boards(params, cfg, Runtime(), xs, pos, layers)
        decode, on_decode, tokens = serve_decode_client(
            cfg, params, BATCH, PROMPT, GEN, seed=0,
            sample_interval=INTERVAL, device="cuda")
        clients = [decode] + [
            Client(engine, list(iter_windows(x_ins, FARM_GROUP)), state, {},
                   drain_fn=None, stack_fn=_stack_on_device, reset=None)
            for engine, state, x_ins, _, _ in boards]

        def on_drain(k, plan, records, y):
            if k == 0:
                on_decode(plan, records, y)
            else:
                ys[layers[k - 1]].append(y)

        sched = WindowScheduler(interval=INTERVAL, overlap=True,
                                drain_fn=None, stack_fn=None)
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        sched.run_many(clients, on_drain=on_drain)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = counts()
    expect_counts(got, {"k2": serve_rec["launches"]["k2"],
                        "k1": FARM_MIXED * FARM_STEPS}, "mixed pass")
    assert tokens() == serve_rec["tokens"], "mixed pass tokens differ"
    for li in layers:
        got_cks = torch.cat(ys[li]).tolist()
        assert got_cks == farm_rec["solo_checksums"][f"layer{li}"], li
    tok_s = BATCH * (GEN - 1) / secs
    print(f"mixed pass: {tok_s:.1f} decode tok/s beside {FARM_MIXED} "
          f"boards (phase 3: {serve_rec['decode_tok_per_s']:.1f})",
          flush=True)
    return {"boards": FARM_MIXED, "k1_launches": got["k1"],
            "k2_launches": got["k2"], "seconds": secs,
            "decode_tok_per_s": tok_s,
            "serve_decode_tok_per_s": serve_rec["decode_tok_per_s"],
            "tokens_equal_serve": True, "checksums_equal_solo": True}


def _tele_p50(tele, channel):
    return {s: d[channel].get("p50") for s, d in tele["devices"].items()}


def farm_async_phase(cfg, params, farm_rec):
    """Phase 52: phase 50's cell on an async FarmManager (see the module
    docstring). Returns the record."""
    import torch

    from repro_torch.core.coemu import inject_fault

    torch.cuda.empty_cache()
    xs, pos = _farm_inputs(cfg)
    layers = list(range(cfg.num_layers))
    L = cfg.num_layers
    rec: dict = {"steps": FARM_STEPS, "layers": L, "slots": FARM_SLOTS,
                 "lane_capacity": FARM_LANES, "rtol": FARM_RTOL}
    cks = {}
    for mode in ("solo", "lanes"):
        reports, cks[mode], got, secs, tele, mem = _farm_run(
            cfg, params, xs, pos, layers, lanes=mode == "lanes",
            mode="async")
        bad = {k: r.summary() for k, r in reports.items() if r.diverged}
        assert not bad, (mode, bad)
        runs = L // FARM_LANES if mode == "lanes" else L
        expect_counts(got, {"k1": runs * FARM_STEPS}, f"async ({mode})")
        rec[mode] = {
            "k1_launches": got["k1"], "seconds": secs,
            "board_steps_per_s": L * FARM_STEPS / secs,
            "max_rel_err": max(r.max_rel_err for r in reports.values()),
            "lanes_per_dispatch_max": tele["lanes_per_dispatch_max"],
            "occupancy_peak": tele["occupancy_peak"],
            "queue_wait_ms_p50": _tele_p50(tele, "queue_wait_ms"),
            "idle_ms_p50": _tele_p50(tele, "idle_ms"),
            "depth_max": {s: d["queue_depth_max"]
                          for s, d in tele["devices"].items()},
            "dispatch_ms_p50": _tele_p50(tele, "dispatch_ms"),
            "window_ms_p50": _tele_p50(tele, "window_ms"),
            "memory": mem,
        }
        print(f"farm-async {mode}: {L * FARM_STEPS / secs:.2f} "
              f"board-steps/s, K1 {got['k1']}, memory {mem}", flush=True)
        if mode == "solo":
            rec["memory_passes"] = _async_memory_passes(
                cfg, params, xs, pos, layers, mem, secs, cks["solo"])
    # the async contract: lockstep's outputs byte for byte
    for n, want in farm_rec["solo_checksums"].items():
        assert cks["solo"][n].tolist() == want, n
    rec["solo_bitwise_vs_lockstep"] = True
    errs = {n: float(((cks["lanes"][n].double() - cks["solo"][n].double())
                      .abs() / cks["solo"][n].double().abs()).max())
            for n in cks["solo"]}
    rec["lanes_vs_solo_max_rel_err"] = max(errs.values())
    assert rec["lanes_vs_solo_max_rel_err"] <= FARM_RTOL, errs
    faults = {}
    for layer in (FARM_FAULT_LAYERS[0], FARM_FAULT_LAYERS[-1]):
        bad = inject_fault(params, cfg, layer)
        for mode in ("solo", "lanes"):
            reports, _, got, _, _, mem = _farm_run(
                cfg, params, xs, pos, FARM_FAULT_LAYERS,
                lanes=mode == "lanes", dut=bad, mode="async")
            named = {k: (r.first.step, r.first.layer)
                     for k, r in reports.items() if r.diverged}
            assert named == {f"layer{layer}": (0, layer)}, (mode, named)
            faults[f"layer{layer}_{mode}"] = {
                "named": named[f"layer{layer}"], "k1_launches": got["k1"],
                "memory": mem}
        del bad
        torch.cuda.empty_cache()
    rec["faults"] = faults
    # lockstep and async solo passes in turns, on the same weights
    turns = []
    for mode in ("lockstep", "async", "async", "lockstep"):
        _, _, _, secs, _, _ = _farm_run(cfg, params, xs, pos, layers,
                                        lanes=False, mode=mode)
        turns.append({"mode": mode, "seconds": secs,
                      "board_steps_per_s": L * FARM_STEPS / secs})
    rec["turns"] = turns
    traces = {}
    for mode in ("lockstep", "async"):
        traces[mode] = {}
        _farm_run(cfg, params, xs, pos, layers, lanes=False, mode=mode,
                  trace=traces[mode])
    rec["traced"] = traces
    rec["peak_memory_allocated"] = max(
        r["memory"]["peak_in_run"]
        for r in [rec["solo"], rec["lanes"], *faults.values()])
    rates = [round(t["board_steps_per_s"], 2) for t in turns]
    print(f"farm-async turns: {rates} board-steps/s; idle share lockstep "
          f"{traces['lockstep']['device_idle_share']:.3f} async "
          f"{traces['async']['device_idle_share']:.3f}", flush=True)
    torch.cuda.empty_cache()
    return rec


def _async_memory_passes(cfg, params, xs, pos, layers, first, first_s,
                         first_cks):
    """Phase 52's solo pass (``first``: its memory, ``first_s``: its
    seconds, ``first_cks``: its checksums) and ASYNC_MEMORY_PASSES - 1
    more async solo passes right after it, in one process: the bytes
    allocated after each and the bytes each leaves. From the second pass
    on each must leave exactly the bytes it found (the seats' threads and
    streams, and so their cuBLAS workspaces, are made once), and each
    must deliver the first one's checksums. Returns the passes."""
    import torch

    passes = [{"allocated": first["after_run"],
               "left": first["after_run"] - first["before_capture"],
               "seconds": first_s}]
    for _ in range(ASYNC_MEMORY_PASSES - 1):
        _, cks, _, secs, _, mem = _farm_run(cfg, params, xs, pos, layers,
                                            lanes=False, mode="async")
        passes.append({"allocated": mem["after_run"],
                       "left": mem["after_run"] - mem["before_capture"],
                       "seconds": secs})
        assert all(torch.equal(cks[n], first_cks[n]) for n in first_cks)
    print("farm-async memory after each of "
          f"{ASYNC_MEMORY_PASSES} passes: "
          f"{[p['allocated'] for p in passes]}, left "
          f"{[p['left'] for p in passes]}", flush=True)
    assert all(p["left"] == 0 for p in passes[1:]), passes
    return passes


def _mixed_run(cfg, params, mode, *, train, soak):
    """One farm pass of phase 53 (see the module docstring): the decode
    job first, the train board (``train``), the verify boards, the soak
    board (``soak``). Returns its record and the decode's tokens, the
    train losses, the boards' checksums."""
    import torch

    from repro_torch.core.coemu import submit_subsystem_jobs
    from repro_torch.farm import FarmManager
    from repro_torch.launch.farm import (prewarm, submit_decode_job,
                                         submit_soak_straggler,
                                         submit_train_job)
    from repro_torch.models import Runtime
    from repro_torch.testing import deterministic

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem = {"before": torch.cuda.memory_allocated()}
    mgr = FarmManager(slots=MIXED_SLOTS, mode=mode, straggler_factor=6.0,
                      straggler_min_s=MIXED_MIN_S, evict_stragglers=soak)
    toks = submit_decode_job(mgr, cfg, gen=GEN, interval=INTERVAL,
                             batch=BATCH, prompt_len=PROMPT, seed=0,
                             device="cuda", params=params)
    span = {}
    decode = mgr.jobs[-1]
    decode.verify = lambda p, r, y: span.__setitem__(
        "end", time.perf_counter())
    losses = None
    if train:
        tcfg = dataclasses.replace(cfg, num_layers=MIXED_TRAIN_LAYERS)
        losses = submit_train_job(mgr, tcfg, MIXED_TRAIN_STEPS, FARM_GROUP,
                                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
                                  device="cuda", lr=TRAIN_LR)
    xs, pos = _farm_inputs(cfg)
    with torch.no_grad():
        finalize = submit_subsystem_jobs(
            mgr, params, cfg, Runtime(), xs, pos, list(range(FARM_MIXED)),
            group_size=FARM_GROUP, rtol=FARM_RTOL)
    board = (submit_soak_straggler(mgr, n_windows=MIXED_SOAK_WINDOWS,
                                   delay=MIXED_SOAK_DELAY)
             if soak else None)
    prewarm_s = prewarm(mgr)
    torch.cuda.synchronize()
    mem["before_run"] = torch.cuda.memory_allocated()
    reset_counts()
    # the pass under deterministic mode (the train board's gate): the
    # decode's windows were captured by prewarm, outside it
    with deterministic():
        t = time.perf_counter()
        rep = mgr.run(strict=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    got = counts()
    failed = {n: j["error"] for n, j in rep["jobs"].items()
              if j["status"] != "done"}
    assert not failed, (mode, failed, rep["telemetry"]["retries"])
    mem["peak"] = torch.cuda.max_memory_allocated()
    reports = finalize()
    bad = {k: r.summary() for k, r in reports.items() if r.diverged}
    assert not bad, (mode, bad)
    tele = rep["telemetry"]
    out = {"mode": mode, "seconds": secs, "prewarm_s": prewarm_s,
           "k1_launches": got["k1"], "k2_launches": got["k2"],
           "counts": got,
           "decode_span_s": span["end"] - t,
           "decode_tok_per_s": BATCH * (GEN - 1) / (span["end"] - t),
           "jobs": {n: j["status"] for n, j in rep["jobs"].items()},
           "evictions": tele["evictions"], "memory": mem,
           "queue_wait_ms_p50": _tele_p50(tele, "queue_wait_ms"),
           "idle_ms_p50": _tele_p50(tele, "idle_ms")}
    if losses is not None:
        out["s_per_train_step"] = secs / MIXED_TRAIN_STEPS
    if board is not None:
        j = rep["jobs"]["soak"]
        out["soak"] = {"requeues": j["requeues"], "windows": j["windows"],
                       "preserved": board.preserved()}
    cks = {n: torch.cat([y for _, _, y in mgr.outputs[n]]).tolist()
           for n in mgr.outputs if n.startswith("layer")}
    tokens = np.concatenate(toks, axis=1).tolist()
    del mgr, finalize, rep
    torch.cuda.empty_cache()
    return out, tokens, losses, cks


def farm_mixed_phase(cfg, params, serve_rec, farm_rec):
    """Phase 53 (see the module docstring). Returns the record."""
    rec: dict = {"slots": MIXED_SLOTS, "train_layers": MIXED_TRAIN_LAYERS,
                 "train_steps": MIXED_TRAIN_STEPS, "boards": FARM_MIXED,
                 "serve_decode_tok_per_s": serve_rec["decode_tok_per_s"]}
    losses = {}
    for mode, train, soak in (("async", True, False),
                              ("lockstep", True, False),
                              ("async", False, True)):
        out, tokens, loss, cks = _mixed_run(cfg, params, mode,
                                            train=train, soak=soak)
        expect_counts(out["counts"], {
            "k2": serve_rec["launches"]["k2"],
            "k1": FARM_MIXED * FARM_STEPS}, f"farm-mixed {mode}")
        assert tokens == serve_rec["tokens"], f"{mode}: tokens differ"
        for n, got in cks.items():
            assert got == farm_rec["solo_checksums"][n], (mode, n)
        assert all(s == "done" for s in out["jobs"].values()), out
        key = mode + ("_soak" if soak else "")
        if train:
            losses[mode] = loss
            out["losses"] = loss
        if soak:
            ev = [e for e in out["evictions"] if e["job"] == "soak"]
            assert ev and all(e["why"] == "straggler" for e in ev), \
                out["evictions"]
            assert out["soak"]["requeues"] >= 1 \
                and out["soak"]["preserved"], out["soak"]
        else:
            assert not out["evictions"], out["evictions"]
        rec[key] = out
        print(f"farm-mixed {key}: {out['decode_tok_per_s']:.1f} decode "
              f"tok/s (phase 3: {serve_rec['decode_tok_per_s']:.1f}), "
              f"{out['seconds']:.2f} s, peak {out['memory']['peak']}",
              flush=True)
    assert losses["async"] == losses["lockstep"], losses
    rec["losses_equal_across_modes"] = True
    rec["tokens_equal_serve"] = True
    return rec


def farm_cli_phase():
    """Phase 54: the farm CLI's gates on the card (see the module
    docstring). Returns the record."""
    import signal

    from repro_torch.launch import farm as cli

    rec: dict = {}
    for mode in ("async", "lockstep"):
        t = time.perf_counter()
        gates = {
            "restart": cli.run_restart_smoke(mode),
            "lanes": cli.run_lanes_smoke(8, chaos_lane=True, mode=mode),
            "scope_l1": cli.run_scope_smoke(mode, lanes=1),
            "scope_l8": cli.run_scope_smoke(mode, lanes=8),
            "chaos7": cli.run_chaos_smoke(7, mode=mode)}
        for k, g in gates.items():
            assert g["ok"], (mode, k, g.get("problems"))
        chaos = gates["chaos7"]
        assert chaos["quarantined"] == ["poison"], chaos
        assert chaos["faults_injected"] == len(chaos["schedule"]), chaos
        rec[mode] = {"seconds": time.perf_counter() - t,
                     "chaos_kinds": sorted({i["kind"]
                                            for i in chaos["schedule"]}),
                     "chaos_faults_injected": chaos["faults_injected"],
                     "chaos_retries": chaos["retries"],
                     "quarantined": chaos["quarantined"]}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.farm", "--steps", "8"]
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    out, _ = _communicate("python -m repro_torch.launch.farm --steps 8",
                          proc, 600)
    rec["cli"] = {"seconds": time.perf_counter() - t,
                  "ok": json.loads(out)["ok"]}
    proc = subprocess.Popen(cmd + ["--synthetic-straggler"], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        seen = []
        while True:
            line = proc.stderr.readline()
            seen.append(line)
            if not line or line.startswith("farm: running"):
                break
        if not line:
            proc.wait(timeout=60)
            _subprocess_failed("the farm CLI before its SIGINT", proc, "",
                               "".join(seen))
        time.sleep(0.5)
        proc.send_signal(signal.SIGINT)
        out, err = _communicate("the farm CLI after SIGINT", proc, 300,
                                want=130)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    partial = json.loads(out)
    assert partial["interrupted"] and partial["jobs"], partial
    rec["sigint"] = {"returncode": proc.returncode,
                     "jobs": {n: j["status"]
                              for n, j in partial["jobs"].items()}}
    return rec


def roofline_farm_phase(cfg, params, farm_rec):
    """Phase 57 (c): a capture on layer 0's board of a farm of phase 50's
    boards FARM_FAULT_LAYERS, force-evicted once, lockstep then async,
    with the farm CLI's --roofline in subprocesses (both modes) beside
    them. Returns the record."""
    import torch

    from repro_torch.core.coemu import submit_subsystem_jobs
    from repro_torch.farm import FarmManager
    from repro_torch.models import Runtime
    from repro_torch.roofline import WindowCapture

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.farm", "--roofline"]
    procs = {m: subprocess.Popen(cmd + ([] if m == "async" else
                                        ["--lockstep"]),
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for m in ("async", "lockstep")}
    rec: dict = {"layers": list(FARM_FAULT_LAYERS), "captured": "layer0"}
    xs, pos = _farm_inputs(cfg)
    windows = FARM_STEPS // FARM_GROUP
    try:
        for mode in ("lockstep", "async"):
            mgr = FarmManager(slots=FARM_SLOTS, evict_stragglers=False,
                              mode=mode)
            cap = WindowCapture()
            with torch.inference_mode():
                finalize = submit_subsystem_jobs(
                    mgr, params, cfg, Runtime(), xs, pos,
                    list(FARM_FAULT_LAYERS), group_size=FARM_GROUP,
                    rtol=FARM_RTOL)
                job = next(j for j in mgr.jobs if j.name == "layer0")
                job.capture = cap
                cap.attach_engine(job.engine)
                mgr.force_evict("layer0")
                torch.cuda.synchronize()
                reset_counts()
                t = time.perf_counter()
                rep = mgr.run()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                got = counts()
            assert all(j["status"] == "done" for j in rep["jobs"].values())
            assert rep["jobs"]["layer0"]["requeues"] >= 1, rep["jobs"]
            outs = mgr.outputs["layer0"]
            delivered = [p.index for p, _, _ in outs]
            assert delivered == list(range(windows)), delivered
            assert [r["window"] for r in cap.rows] == delivered, cap.rows
            assert all(r["device_s"] is not None and r["device_s"] > 0
                       for r in cap.rows), cap.rows
            assert all(r["flops"] > 0 for r in cap.rows), cap.rows
            for name, o in mgr.outputs.items():
                got_ck = torch.cat([y for _, _, y in o]).tolist()
                assert got_ck == farm_rec["solo_checksums"][name], name
            dispatches = sum(d["dispatch_ms"]["n"]
                             for d in rep["telemetry"]["devices"].values())
            n_boards = len(FARM_FAULT_LAYERS)
            assert dispatches > n_boards * windows, dispatches
            expect_counts(got, {"k1": FARM_GROUP * dispatches},
                          f"roofline farm ({mode})")
            reports = finalize()
            assert not any(r.diverged for r in reports.values())
            rec[mode] = {"seconds": secs, "k1_launches": got["k1"],
                         "window_dispatches": dispatches,
                         "requeues": rep["jobs"]["layer0"]["requeues"],
                         "rows": [{k: r[k] for k in ("window", "size",
                                                     "wall_s", "device_s")}
                                  for r in cap.rows],
                         "roofline": cap.report()}
            print(f"roofline farm ({mode}): {rec[mode]}", flush=True)
            del mgr, finalize, job, outs, reports
            torch.cuda.empty_cache()
        for mode, proc in procs.items():
            t = time.perf_counter()
            out, _ = _communicate(f"python -m repro_torch.launch.farm "
                                  f"--roofline ({mode})", proc, 600)
            cli = json.loads(out)
            assert cli["ok"] and cli["roofline"]["windows"] > 0, cli
            assert cli["roofline"]["device_s"] > 0, cli["roofline"]
            rec[f"cli_{mode}"] = {"wait_s": time.perf_counter() - t,
                                  "roofline": cli["roofline"]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rec


def _build_listing():
    """The kernel build directory's files with their sizes and mtimes."""
    from repro_torch.kernels import _build
    d = _build.library_path("flash_attention").parent
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(d.iterdir())} if d.exists() else {}


def farm_certify_phase(cfg, params, serve_rec, farm_rec):
    """Phase 56: ZP-Cert at glm4-9b's full width (see the module
    docstring). Returns the record."""
    import tempfile

    import torch

    from repro_torch.analysis import certify_job, job_trees, \
        no_dispatch_guard, warm_fake_device
    from repro_torch.core.coemu import submit_subsystem_jobs
    from repro_torch.core.graphs import launch_counts
    from repro_torch.farm import FarmLedger, FarmManager
    from repro_torch.kernels import is_traced
    from repro_torch.launch import farm as cli
    from repro_torch.models import Runtime

    rec: dict = {}
    t_phase = time.perf_counter()
    # (c) the CLI gates, in subprocesses started first, together
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = {"certify_smoke_async": ["-m", "repro_torch.launch.farm",
                                    "--certify-smoke"],
            "certify_smoke_lockstep": ["-m", "repro_torch.launch.farm",
                                       "--certify-smoke", "--lockstep"],
            "analysis_strict_archs": ["-m", "repro_torch.analysis",
                                      "--strict", "--archs"]}
    procs = {k: subprocess.Popen([sys.executable, *c], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    try:
        # (a) trace-only certification of the full-width boards
        torch.cuda.empty_cache()
        xs, pos = _farm_inputs(cfg)
        holder = FarmManager(slots=1, device="cuda")    # never run
        with torch.inference_mode():
            submit_subsystem_jobs(holder, params, cfg, Runtime(), xs, pos,
                                  list(range(cfg.num_layers)),
                                  group_size=FARM_GROUP, rtol=FARM_RTOL)
        cli.submit_decode_job(holder, cfg, gen=GEN, interval=INTERVAL,
                              batch=BATCH, prompt_len=PROMPT, seed=0,
                              device="cuda", params=params)
        cli.submit_train_job(
            holder, dataclasses.replace(cfg, num_layers=MIXED_TRAIN_LAYERS),
            MIXED_TRAIN_STEPS, FARM_GROUP, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            seed=0, device="cuda", lr=TRAIN_LR)
        boards = [(job, job_trees(job)) for job in holder.jobs]
        warm_fake_device("cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {"allocated": torch.cuda.memory_allocated(),
                  "peak": torch.cuda.max_memory_allocated(),
                  "launches": launch_counts(), "builds": _build_listing()}
        reports, secs, peaks = {}, {}, {}
        with no_dispatch_guard():
            for job, trees in boards:
                t = time.perf_counter()
                reports[job.name] = certify_job(job, trees=trees)
                secs[job.name] = time.perf_counter() - t
                if torch.cuda.max_memory_allocated() != before["peak"]:
                    peaks.setdefault(job.name,
                                     torch.cuda.max_memory_allocated())
        assert not peaks, ("the peak moved while certifying", peaks)
        after = {"allocated": torch.cuda.memory_allocated(),
                 "peak": torch.cuda.max_memory_allocated(),
                 "launches": launch_counts(), "builds": _build_listing()}
        assert after == before, (before, after)
        bad = {n: r.summary() for n, r in reports.items() if r.errors}
        assert not bad, bad
        layer_jobs = [j for j, _ in boards if j.name.startswith("layer")]
        assert len(layer_jobs) == cfg.num_layers
        assert FARM_STEPS % FARM_GROUP == 0
        windows = FARM_STEPS // FARM_GROUP
        k1_calls = sum(reports[j.name].kernels.get("flash_attention", 0)
                       * windows for j in layer_jobs)
        assert all(reports[j.name].kernels == {"flash_attention":
                                               FARM_GROUP}
                   for j in layer_jobs), \
            {j.name: reports[j.name].kernels for j in layer_jobs}
        assert k1_calls == farm_rec["solo"]["k1_launches"] \
            == cfg.num_layers * FARM_STEPS, k1_calls
        assert reports["decode"].kernels == {
            "decode_attention": cfg.num_layers * INTERVAL}, \
            reports["decode"].kernels
        rec["trace_only"] = {
            "boards": len(reports), "errors": 0,
            "warnings": {n: [str(f) for f in r.warnings]
                         for n, r in reports.items() if r.warnings},
            "unchanged": sorted(before), "memory": after["allocated"],
            "flash_attention_calls": k1_calls,
            "kernels": {n: r.kernels for n, r in reports.items()
                        if not n.startswith("layer")},
            "writes": {n: len(r.writes) for n, r in reports.items()
                       if not n.startswith("layer")},
            "seconds": {"layer_boards": [secs[j.name]
                                         for j in layer_jobs],
                        "decode": secs["decode"], "train": secs["train"],
                        "total": sum(secs.values())}}
        print(f"farm-certify (a): {len(reports)} boards clean, "
              f"{k1_calls} flash_attention calls listed, "
              f"{sum(secs.values()):.2f} s (layer board max "
              f"{max(secs[j.name] for j in layer_jobs):.3f} s, decode "
              f"{secs['decode']:.2f} s, train {secs['train']:.2f} s), "
              f"decode writes {reports['decode'].writes[:2]}...",
              flush=True)
        del holder, boards, reports, layer_jobs
        torch.cuda.empty_cache()

        # (b) two certify=True farms
        for mode in ("lockstep", "async"):
            with tempfile.TemporaryDirectory() as tmp:
                ledger = FarmLedger(tmp)
                mgr = FarmManager(slots=MIXED_SLOTS, mode=mode,
                                  evict_stragglers=False, ledger=ledger,
                                  certify=True)
                toks = cli.submit_decode_job(
                    mgr, cfg, gen=GEN, interval=INTERVAL, batch=BATCH,
                    prompt_len=PROMPT, seed=0, device="cuda", params=params)
                with torch.inference_mode():
                    finalize = submit_subsystem_jobs(
                        mgr, params, cfg, Runtime(), xs, pos,
                        list(range(FARM_MIXED)), group_size=FARM_GROUP,
                        rtol=FARM_RTOL)
                poison = cli._poison_board()
                ran = []
                real = poison.engine

                def engine(state, shell, stack, real=real, ran=ran):
                    if not is_traced(state):
                        ran.append(1)
                    return real(state, shell, stack)

                poison.engine = engine
                mgr.submit(poison)
                assert poison.status == "quarantined" \
                    and "ZC101" in poison.error, poison.error
                assert all(j.name != "poison" for j in mgr.queue)
                cli.prewarm(mgr)
                torch.cuda.synchronize()
                reset_counts()
                t = time.perf_counter()
                rep = mgr.run(strict=False)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t
                got = counts()
                kinds = [r for r in ledger.records()
                         if r["kind"] == "certify_fail"]
                ledger.close()
            assert not ran, "the poison board's engine ran"
            assert [r["job"] for r in kinds] == ["poison"] \
                and kinds[0]["rules"] == ["ZC101"], kinds
            certs = rep["telemetry"]["certifications"]
            assert [c["job"] for c in certs if not c["ok"]] == ["poison"], \
                certs
            assert rep["jobs"]["poison"]["status"] == "quarantined"
            assert all(j["status"] == "done" for n, j in rep["jobs"].items()
                       if n != "poison"), rep["jobs"]
            expect_counts(got, {"k1": FARM_MIXED * FARM_STEPS,
                                "k2": serve_rec["launches"]["k2"]},
                          f"farm-certify {mode}")
            assert np.concatenate(toks, axis=1).tolist() \
                == serve_rec["tokens"], f"{mode}: tokens differ"
            for n in (f"layer{i}" for i in range(FARM_MIXED)):
                cks = torch.cat([y for _, _, y in mgr.outputs[n]]).tolist()
                assert cks == farm_rec["solo_checksums"][n], (mode, n)
            bad = {k: r.summary() for k, r in finalize().items()
                   if r.diverged}
            assert not bad, (mode, bad)
            rec[mode] = {"k1_launches": got["k1"], "k2_launches": got["k2"],
                         "seconds": run_s, "quarantined": ["poison"],
                         "certify_fail_rules": kinds[0]["rules"],
                         "tokens_equal_serve": True,
                         "checksums_equal_solo": True}
            print(f"farm-certify (b) {mode}: poison dead-lettered "
                  f"({kinds[0]['rules']}), K1 {got['k1']}, K2 {got['k2']}, "
                  f"{run_s:.2f} s", flush=True)
            del mgr, finalize, rep
            torch.cuda.empty_cache()

        # (c) the CLI gates' results
        for k, proc in procs.items():
            out, _ = _communicate(" ".join(cmds[k]), proc, 600)
            if k.startswith("certify_smoke"):
                res = json.loads(out)
                assert res["ok"] and res["jobs"]["poison"]["status"] \
                    == "quarantined", res
            else:
                assert "0 board errors" in out and "0 race findings" in out, \
                    out[-2000:]
            rec[k] = {"returncode": proc.returncode}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"farm-certify (c): {sorted(procs)} exit 0; phase "
          f"{rec['seconds']:.1f} s", flush=True)
    return rec


def _subprocess_failed(what, proc, out, err):
    """Print a failed subprocess's stdout and stderr tails, then raise
    naming it."""
    sys.stderr.write(f"{what} exited {proc.returncode}\n--- stdout tail\n"
                     f"{(out or '')[-4000:]}\n--- stderr tail\n"
                     f"{(err or '')[-8000:]}\n")
    sys.stderr.flush()
    raise AssertionError(f"{what} exited {proc.returncode}")


def _communicate(what, proc, timeout, want=0):
    """Wait for ``proc`` (killed and reaped at ``timeout``); on a return
    code other than ``want``, print its tails and raise. Returns
    (stdout, stderr)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        _subprocess_failed(f"{what} (killed at its {timeout} s timeout)",
                           proc, out, err)
    if proc.returncode != want:
        _subprocess_failed(what, proc, out, err)
    return out, err


def _go(what, proc, timeout):
    """Tell a waiting child of phase 55 to start (one line on its
    stdin); a child that already exited is a failure, with its tails."""
    try:
        if proc.poll() is not None:
            raise BrokenPipeError
        proc.stdin.write("go\n")
        proc.stdin.flush()
    except BrokenPipeError:
        out, err = proc.communicate(timeout=timeout)
        _subprocess_failed(f"{what} (before its go)", proc, out, err)


def _json_lines(text):
    """The JSON objects among ``text``'s lines, in order."""
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


# ------------------------------------------------- 55. the farm's ledger --
LEDGER_FACTORY = "chip_smoke.glm4_layer_board"
_LEDGER_BOARDS: dict = {}       # layer -> subsystem_boards' board tuple


def _ledger_boards():
    """Phase 55's layer boards in this process, made at the first call
    and kept: glm4-9b's weights drawn on the card from seed 0 as phase 3
    draws them, LEDGER_STEPS activation batches, one in-situ capture
    (``subsystem_boards``) and one board a layer of LEDGER_LAYERS. Every
    process that calls it makes the same boards."""
    if not _LEDGER_BOARDS:
        import torch

        from repro_torch.configs import get_config
        from repro_torch.core.coemu import subsystem_boards
        from repro_torch.models import Runtime, build_model

        cfg = get_config(ARCH)
        with torch.inference_mode():
            params = build_model(cfg).init(0, device="cuda")
            xs, pos = _farm_inputs(cfg, LEDGER_STEPS)
            boards = subsystem_boards(params, cfg, Runtime(), xs, pos,
                                      LEDGER_LAYERS)
        _LEDGER_BOARDS.update(zip(LEDGER_LAYERS, boards))
    return _LEDGER_BOARDS


def _no_barrier(state, boundary):
    pass


def _ledger_board(layer, out_dir):
    """The registered factory of phase 55: glm4-9b's layer ``layer`` as a
    board of LEDGER_STEPS steps in windows of FARM_GROUP, a commit at
    every window, each window's checksums delivered to a per-window file
    under ``out_dir`` (the CLI's idempotent ``_write_window_file``)."""
    from repro_torch.core import DrainBarrier, iter_windows
    from repro_torch.core.coemu import _stack_on_device
    from repro_torch.launch.farm import _write_window_file

    engine, state, x_ins, _, _ = _ledger_boards()[int(layer)]

    def sink(plan, records, ys):
        # no fsync: the gate kills a process, whose files the page cache
        # keeps; with the 0.41 GB snapshots in write-back an fsync here
        # stalled the control thread's delivery
        _write_window_file(out_dir, f"layer{layer}", plan.index, ys,
                           fsync=False)

    return dict(engine=engine, state=state, shell={},
                windows=list(iter_windows(x_ins, FARM_GROUP)),
                stack_fn=_stack_on_device, on_drain=sink,
                barriers=(DrainBarrier(every=FARM_GROUP,
                                       action=_no_barrier),))


def _register_ledger_board():
    from repro_torch.farm import register
    register(LEDGER_FACTORY, _ledger_board)


def _ledger_specs(ledger_dir):
    """One JobSpec a layer board: journal, snapshots (on disk, 4 kept)
    and window files all under ``ledger_dir``."""
    from repro_torch.farm import JobSpec
    return [JobSpec(name=f"layer{li}", factory=LEDGER_FACTORY,
                    kwargs={"layer": li,
                            "out_dir": os.path.join(ledger_dir, "outputs")},
                    snapshot_dir=os.path.join(ledger_dir, "snaps",
                                              f"layer{li}"),
                    snapshot_keep=4, max_requeues=4)
            for li in LEDGER_LAYERS]


def _timed_ledger(path):
    """A FarmLedger whose appends (each flushed and fsynced) are timed."""
    from repro_torch.farm import FarmLedger

    class TimedLedger(FarmLedger):
        def __init__(self, directory):
            super().__init__(directory)
            self.append_s = []

        def append(self, kind, **fields):
            t = time.perf_counter()
            rec = super().append(kind, **fields)
            self.append_s.append(time.perf_counter() - t)
            return rec

    return TimedLedger(path)


def _append_stats(led):
    """The journal's fsync'd appends of a lifetime: their count, total,
    median and largest seconds."""
    s = sorted(led.append_s)
    return {"appends": len(s), "append_s_total": sum(s),
            "append_s_p50": s[len(s) // 2] if s else None,
            "append_s_max": s[-1] if s else None}


def _ledger_lifetime(ledger_dir, kill_at=None, recover=False, echo=False):
    """One process lifetime of phase 55's campaign: the farm CLI's
    ``run_ledger_farm`` on LEDGER_SLOTS async slots of the card over the
    layer boards' JobSpecs (or recovered from the journal), under
    deterministic mode and inference mode, its journal's appends timed;
    a victim armed with ``kill_at`` never returns. With ``echo`` it
    prints one JSON line at each journaled commit (with the peak memory
    so far) before the kill armed there can fire. Returns the CLI's
    report with the lifetime's seconds, peak memory and append times."""
    import torch

    from repro_torch.launch.farm import run_ledger_farm
    from repro_torch.testing import deterministic

    def echo_commit(job, n):
        print(json.dumps({"event": "commit", "commit": n, "job": job,
                          "unix": time.time(),
                          "peak_bytes": torch.cuda.max_memory_allocated()}),
              flush=True)

    t0 = time.perf_counter()
    _register_ledger_board()
    led = _timed_ledger(ledger_dir)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode(), deterministic():
        rec = run_ledger_farm(
            ledger_dir, mode="async", recover=recover, kill_after=kill_at,
            slots=LEDGER_SLOTS, device="cuda",
            specs=None if recover else _ledger_specs(ledger_dir),
            ledger=led, on_commit=echo_commit if echo else None)
        torch.cuda.synchronize()
    rec.update(seconds=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated())
    rec["journal"].update(_append_stats(led))
    return rec


def ledger_child(role, ledger_dir):
    """A child process of phase 55 (``python3 chip_smoke.py
    --ledger-child victim|recover DIR``): waits for one line on stdin
    (the parent's go: the card is free for it), then runs one lifetime —
    the victim SIGKILLs itself at its LEDGER_KILL_AT-th journaled commit,
    the recovery prints its record as the last line."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.stdin.readline()
    rec = _ledger_lifetime(
        ledger_dir, kill_at=LEDGER_KILL_AT if role == "victim" else None,
        recover=role == "recover", echo=True)
    print(json.dumps(rec, default=float), flush=True)
    return 0


def _free_bytes():
    import torch
    return torch.cuda.mem_get_info()[0]


def _board_rows(out_dir, board):
    """A board's delivered output rows in window order, read back from
    its per-window files."""
    from repro_torch.launch.farm import _read_window_files
    files = _read_window_files(out_dir)
    rows = []
    for name in sorted(f for f in files if f.startswith(f"{board}_w")):
        rows += json.loads(files[name])["y"]
    return rows


def farm_ledger_phase(solo_checksums):
    """Phase 55: ZP-Ledger's kill-restart gate on the card (see the
    module docstring); ``solo_checksums`` are phase 50's. Returns the
    record."""
    import shutil
    import signal
    import tempfile

    from repro_torch.farm import FarmLedger
    from repro_torch.launch.farm import killrestart_problems, victim_journal
    from repro_torch.utils import tree_leaves

    rec: dict = {"layers": list(LEDGER_LAYERS), "steps": LEDGER_STEPS,
                 "group": FARM_GROUP, "slots": LEDGER_SLOTS,
                 "kill_at_commit": LEDGER_KILL_AT}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tmp = tempfile.gettempdir()
    disk = shutil.disk_usage(tmp)
    rec["tmp"] = {"dir": tmp, "free_bytes": disk.free}
    print(f"farm-ledger: {tmp} has {disk.free} bytes free", flush=True)
    # a lifetime keeps up to 4 snapshots of 0.41 GB a board on disk
    assert disk.free > LEDGER_DISK_BYTES, \
        f"phase 55 needs {LEDGER_DISK_BYTES} bytes free under {tmp}"
    base = tempfile.mkdtemp(prefix="zp-ledger-glm4-")
    children = []
    try:
        # (b)'s victim process starts now: it imports while (a) and the
        # oracle run, and waits for its go
        victim_dir = os.path.join(base, "victim")
        victim = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ledger-child",
             "victim", victim_dir], cwd=ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        children.append(victim)
        # (a) the CLI's kill-restart gate on toy boards, both modes
        # together, each in its own process (the oracle in it, the victim
        # and the recovery its children), before (b): the toy board
        # paces a window at 5 ms, and (b)'s 13 GB of snapshot writes
        # slow the fsyncs its delivery waits for
        toys = {mode: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.farm",
             "--killrestart-smoke", f"--{mode}", "--device", "cuda"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for mode in ("async", "lockstep")}
        children += toys.values()
        toy = {}
        for mode, proc in toys.items():
            out, err = _communicate(f"--killrestart-smoke --{mode}", proc,
                                    LEDGER_CHILD_TIMEOUT_S)
            res = json.loads(out)
            assert res["ok"], (mode, res["problems"])
            toy[mode] = {k: res[k] for k in (
                "seconds", "kill_after", "victim_returncode",
                "pre_commits", "pre_delivered", "delivery_lag")}
            toy[mode].update({k: res["recovered"][k] for k in (
                "recoveries", "windows_replayed", "windows_committed")})
        rec["toy"] = toy
        print(f"farm-ledger toys: {json.dumps(toy)}", flush=True)

        # (b) glm4-9b's layer boards: the oracle in this process
        oracle_dir = os.path.join(base, "oracle")
        oracle = _ledger_lifetime(oracle_dir)
        assert oracle["ok"], oracle["jobs"]
        expect_counts(oracle["launches"],
                      {"k1": len(LEDGER_LAYERS) * LEDGER_STEPS},
                      "ledger oracle")
        for li in LEDGER_LAYERS:
            got = _board_rows(os.path.join(oracle_dir, "outputs"),
                              f"layer{li}")
            assert len(got) == LEDGER_STEPS, (li, len(got))
            assert got[:FARM_STEPS] == solo_checksums[f"layer{li}"], li
        # one snapshot: a board's state (its layer's weights)
        snap_bytes = sum(x.numel() * x.element_size() for x in
                         tree_leaves(_LEDGER_BOARDS[LEDGER_LAYERS[0]][1]))
        rec["snapshot_bytes"] = snap_bytes
        oracle["bytes_written"] = (oracle["commits"] * snap_bytes
                                   + oracle["journal"]["bytes"])
        rec["oracle"] = oracle
        # the oracle's window files stay for the comparison, its
        # snapshots go (the victim's and the recovery's take their room)
        shutil.rmtree(os.path.join(oracle_dir, "snaps"))
        _LEDGER_BOARDS.clear()
        free_device_memory()
        free0 = _free_bytes()
        rec["free_before_victim"] = free0
        print(f"farm-ledger oracle: {oracle['seconds']:.1f} s, K1 "
              f"{oracle['launches']['k1']}, journal {oracle['journal']}, "
              f"{oracle['bytes_written']} bytes written, peak "
              f"{oracle['peak_bytes']}", flush=True)

        t = time.perf_counter()
        _go("the ledger victim", victim, LEDGER_CHILD_TIMEOUT_S)
        out, err = _communicate("the ledger victim", victim,
                                LEDGER_CHILD_TIMEOUT_S,
                                want=-signal.SIGKILL)
        t_dead = time.time()
        # the lines echoed at its commits (the one the kill fired at may
        # be missing or not the last: slot threads echo concurrently)
        lines = [x for x in _json_lines(out) if x.get("event") == "commit"]
        assert lines, out[-2000:]
        v = {"returncode": victim.returncode,
             "seconds": time.perf_counter() - t,
             "dead_unix": t_dead,
             "peak_bytes": max(x["peak_bytes"] for x in lines),
             **victim_journal(victim_dir)}
        # the kill fires right after the LEDGER_KILL_AT-th commit record
        # is on disk (another slot thread may append one more first)
        v["commits"] = sum(v["pre_commits"].values())
        assert v["commits"] >= LEDGER_KILL_AT, v["pre_commits"]
        v["journal_bytes"] = os.path.getsize(
            os.path.join(victim_dir, FarmLedger.FILENAME))
        v["bytes_written"] = v["commits"] * snap_bytes + v["journal_bytes"]
        rec["victim"] = v
        # the card gives the dead victim's memory back before the
        # recovery starts
        t = time.perf_counter()
        while _free_bytes() < free0 - LEDGER_FREE_SLACK:
            assert time.perf_counter() - t < LEDGER_FREE_TIMEOUT_S, \
                ("the victim's memory was not returned", _free_bytes(),
                 free0)
            time.sleep(0.1)
        v["memory_returned_s"] = time.perf_counter() - t
        print(f"farm-ledger victim: exit {v['returncode']} at commit "
              f"{v['commits']}, commits {v['pre_commits']}, delivered "
              f"{v['pre_delivered']}, {v['seconds']:.1f} s, peak "
              f"{v['peak_bytes']}, memory back in "
              f"{v['memory_returned_s']:.2f} s", flush=True)

        t = time.perf_counter()
        rec_proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ledger-child",
             "recover", victim_dir], cwd=ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        children.append(rec_proc)
        _go("the ledger recovery", rec_proc, LEDGER_CHILD_TIMEOUT_S)
        out, err = _communicate("the ledger recovery", rec_proc,
                                LEDGER_CHILD_TIMEOUT_S)
        r = _json_lines(out)[-1]
        r["wall_s"] = time.perf_counter() - t
        # from the victim's death as the parent saw it (its exit reaped)
        r["kill_to_first_commit_s"] = r["first_commit_unix"] - t_dead
        r["bytes_written"] = (r["commits"] * snap_bytes
                              + r["journal"]["bytes"] - v["journal_bytes"])
        rec["recover"] = r
        print(f"farm-ledger recovery: {r['wall_s']:.1f} s, resumed "
              f"{[(x['job'], x['window']) for x in r['recoveries']]}, "
              f"replayed {r['windows_replayed']} of "
              f"{r['windows_committed']} committed, K1 "
              f"{r['launches']['k1']}, peak {r['peak_bytes']}, SIGKILL to "
              f"first commit {r['kill_to_first_commit_s']:.2f} s",
              flush=True)
        # the gates: the CLI's, then the K1 counts
        problems = killrestart_problems(
            oracle_dir, victim_dir, [f"layer{li}" for li in LEDGER_LAYERS],
            -(-LEDGER_STEPS // FARM_GROUP), victim.returncode, v, r)
        assert not problems, problems
        expect_counts(r["launches"], {"k1": r["launches"]["k1"]},
                      "ledger recovery")
        assert 0 < r["launches"]["k1"] < len(LEDGER_LAYERS) * LEDGER_STEPS
        rec["exactly_once"] = True
        rec["files_equal_oracle"] = len(LEDGER_LAYERS) \
            * -(-LEDGER_STEPS // FARM_GROUP)
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(base, ignore_errors=True)
    return rec


def scope_loop_phase():
    """train_loop at phase 39's cell with the ZP-Scope plane (phase 41):
    both engines, plane off and on, a checkpoint at the last step into a
    temporary directory the phase deletes; then the verifier's digest
    first pass on the fused run's drains. Returns the record."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.coemu import CommitDivergence, CommitStreamVerifier
    from repro_torch.core.scope import ScopeSpec
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import Runtime, build_model
    from repro_torch.testing import (assert_trees_equal, deterministic,
                                     train_window_digests)
    from repro_torch.train import (LoopConfig, init_state, make_train_step,
                                   train_loop)

    cfg = dataclasses.replace(get_config(COEMU_ARCH), num_layers=LOOP_LAYERS)
    model = build_model(cfg, Runtime(attention_impl="xla",
                                     taps=frozenset({"commits"})))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_scope_"))
    n_windows = LOOP_STEPS // LOOP_INTERVAL
    rec: dict = {"arch": cfg.name, "layers": LOOP_LAYERS,
                 "steps": LOOP_STEPS, "sample_interval": LOOP_INTERVAL,
                 "checkpoint_every": SCOPE_LOOP_EVERY, "windows": n_windows}
    drains: list = []               # the fused plane-on run's drains
    try:
        with deterministic():
            for fused in (True, False):
                engine = "fused" if fused else "per_step"
                outs = {}
                for plane in ("off", "on"):
                    lc = LoopConfig(
                        steps=LOOP_STEPS, batch=COEMU_BATCH, seq=COEMU_SEQ,
                        sample_interval=LOOP_INTERVAL,
                        checkpoint_every=SCOPE_LOOP_EVERY, fused=fused,
                        checkpoint_dir=str(tmp / plane),
                        scope=ScopeSpec() if plane == "on" else None)
                    keep = (lambda last, r: drains.append((last, r))) \
                        if fused and plane == "on" else None
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = train_loop(model, lc, resume=False,
                                     on_drain=keep)
                    torch.cuda.synchronize()
                    out["seconds"] = time.perf_counter() - t0
                    outs[plane] = out
                off, on = outs["off"], outs["on"]
                assert on["losses"] == off["losses"], engine
                assert_trees_equal(off["state"], on["state"],
                                   f"loop state, plane on vs off ({engine})")
                del off["state"], on["state"]
                torch.cuda.empty_cache()
                # each published checkpoint's manifest: every leaf's path,
                # shape, dtype and crc32 of its stored bytes
                for plane in ("off", "on"):
                    assert CheckpointManager(str(tmp / plane)).steps() \
                        == [SCOPE_LOOP_EVERY], (engine, plane)
                for step_dir in sorted((tmp / "off").glob("step_*")):
                    manifest = (step_dir / "manifest.json").read_text()
                    assert manifest == (tmp / "on" / step_dir.name /
                                        "manifest.json").read_text(), \
                        (engine, step_dir.name)
                rep = on["scope"]
                assert rep["windows"] == n_windows, rep["windows"]
                # the per-step engine's ys are a list of scalar losses:
                # as in the reference, a window of them counts one step
                assert rep["steps"] == (LOOP_STEPS if fused else n_windows)
                assert rep["samples"] == n_windows
                assert on["coverage"]["per_map"]["scope_gates"][
                    "covered"] == sum(rep["gates"])
                rec[engine] = {
                    "losses": on["losses"], "seconds_plane_off":
                        off["seconds"], "seconds_plane_on": on["seconds"],
                    "scope": {k: rep[k] for k in (
                        "windows", "steps", "tokens", "samples", "gates",
                        "digest")},
                    "checkpoint_manifests_equal": [SCOPE_LOOP_EVERY],
                    "final_state_bitwise": True}
                if fused:
                    got = [h["win_digests"][0] for h in rep["history"]]
                shutil.rmtree(tmp / "off")
                shutil.rmtree(tmp / "on")
            # the verifier's digest first pass on the fused drains: the
            # oracle is the same bf16 step, its expected digests from its
            # own run; then an oracle from another seed must miss the
            # digest, fall through to the row compare and veto
            step = make_train_step(model)
            batches = [make_batch_fn(cfg, COEMU_BATCH, COEMU_SEQ, 0)(i)
                       for i in range(LOOP_STEPS)]
            for seed in (0, 99):
                exp = train_window_digests(
                    step, init_state(model, seed, device="cuda"), batches,
                    LOOP_INTERVAL)
                torch.cuda.empty_cache()
                v = CommitStreamVerifier(
                    step, init_state(model, seed, device="cuda"), batches,
                    layers=cfg.num_layers, expected_digests=exp)
                if seed == 0:
                    assert exp == dict(enumerate(got)), (exp, got)
                    t0 = time.perf_counter()
                    for w, (last, r) in enumerate(drains):
                        v(last, r, digest=got[w], window=w)
                    assert v.digest_hits == n_windows, v.digest_hits
                    rec["digest_pass"] = {
                        "digest_hits": v.digest_hits,
                        "seconds": time.perf_counter() - t0}
                else:
                    assert all(exp[w] != got[w] for w in exp)
                    try:
                        v(*drains[0], digest=got[0], window=0)
                    except CommitDivergence as e:
                        rec["digest_pass"]["faulted_oracle"] = str(e)
                    else:
                        raise AssertionError(
                            "the faulted oracle passed the digest pass")
                    assert v.digest_hits == 0
                del v
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def remat_phase():
    """Phase 36's train cell under remat "none", "dots" and "full" (phase
    42): run_grouped of make_group_step on the "xla" path under
    deterministic mode (the first window eager, the second captured and
    replayed); each run's losses and updated params against the first's
    to the bit, its peak memory, the memory one forward holds for the
    backward (``_backward_memory``), and a window replay timed with CUDA
    events (state advancing). Returns the record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import Runtime, build_model
    from repro_torch.testing import (assert_records_equal,
                                     assert_trees_equal, deterministic,
                                     train_run)
    from repro_torch.train import OptConfig
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
    fn = make_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ, 0)
    batches = [fn(i) for i in range(TRAIN_STEPS)]
    rec: dict = {"arch": cfg.name, "layers": TRAIN_LAYERS,
                 "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                 "sample_interval": TRAIN_INTERVAL, "steps": TRAIN_STEPS}
    first = None
    with deterministic():
        for remat in ("none", "dots", "full"):
            rt = Runtime(attention_impl="xla", taps=TRAIN_TAPS, remat=remat)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            run = train_run(cfg, rt, batches, TRAIN_INTERVAL,
                            opt_cfg=OptConfig(lr=TRAIN_LR, warmup_steps=10))
            expect_counts(counts(), {}, f"train, remat {remat}")
            assert run["windows"] == {"graph": 1, "eager": 1}
            peak = torch.cuda.max_memory_allocated()
            params = run["state"]["params"]
            if first is None:
                first = (run["records"],
                         tree_map(lambda t: t.cpu(), params))
            else:
                assert_records_equal(first[0], run["records"],
                                     f"train records, remat {remat}")
                assert_trees_equal(first[1], params,
                                   f"train params, remat {remat}")
            memory = _backward_memory(build_model(cfg, rt), params,
                                      batches[0])
            graphs = run["engine"]
            window = graphs.graphs[TRAIN_INTERVAL]
            replay_ms = time_ms(torch, lambda i: window.graph.replay(), 1, 2)
            losses = np.concatenate([r["metrics"]["loss"]
                                     for _, r in run["records"]])
            rec[remat] = {"max_memory_allocated": peak, **memory,
                          "window_replay_ms": replay_ms,
                          "s_per_step_replay":
                              replay_ms / 1e3 / TRAIN_INTERVAL,
                          "seconds": run["seconds"],
                          "capture_s": graphs.capture_s,
                          "losses": losses.tolist()}
            del run, params, graphs, window
            torch.cuda.empty_cache()
    rec["bitwise_losses_and_params"] = True
    return rec


def _backward_memory(model, params, batch):
    """One forward of ``model.loss`` with grad on the card, then its
    gradients: the bytes the forward leaves allocated for the backward,
    and the peak above the start through the forward and through the
    backward (the gradients included)."""
    import torch

    from repro_torch.utils import tree_leaves, tree_unflatten
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        loss, _ = model.loss(tree_unflatten(params, leaves), batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        forward_peak = torch.cuda.max_memory_allocated() - base
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads, loss, leaves
    torch.cuda.empty_cache()
    return {"held_for_backward_bytes": held,
            "forward_peak_bytes": forward_peak,
            "forward_backward_peak_bytes": peak}


def examples_phase():
    """The five examples/torch_*.py with --device cuda at their smoke
    budgets, each in a subprocess that must exit 0, all five started
    together (small models: they share the card). Returns the seconds
    until each had exited and the last line each printed."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cuda",
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, args in EXAMPLES}
    rec = {}
    try:
        for name, proc in procs.items():
            out, _ = _communicate(name, proc, 600)
            lines = out.strip().splitlines()
            rec[name] = {"seconds_to_exit": time.perf_counter() - t0,
                         "last_line": lines[-1] if lines else ""}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return rec


def new_kernel_check_phase(sms):
    """K1 and K2 against their plain versions at the last four archs'
    shapes (phase 43): K2 at each decode shape (B=8, the serve ring) with
    pos on the edges of the first split chunk and inside the decode, K1
    at each forward shape (B=2, S=4096) and ragged (S=4000), f32 at 2e-5
    and bf16 at 2e-2 and 6e-3 normwise; then K1 and K2 at the head_dim-64
    shapes bitwise over two launches and a CUDA-graph replay. Returns the
    errors by case group."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.testing import (check_decode_attention,
                                     check_decode_determinism,
                                     check_flash_attention,
                                     check_flash_attention_bitwise)

    errs: dict = {}

    def case(key, check, *a, **kw):
        got = check(*a, **kw)
        errs[key] = [max(x, y) for x, y in zip(errs.get(key, got), got)]

    for arch in NEW_ARCHS:
        c = get_config(arch)
        H, K, hd = c.num_heads, c.num_kv_heads, c.head_dim
        P = c.num_patches if c.family == "vlm" else 0
        W = PROMPT + P + GEN + 8
        chunk = da_ops.split_plan(BATCH * K, W, sms)[0]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            for pos in (chunk - 1, chunk, PROMPT + P + GEN - 2):
                case(f"k2_{arch}_{dname}", check_decode_attention, B=BATCH,
                     H=H, K=K, W=W, hd=hd, pos=pos, dtype=dtype)
            case(f"k1_{arch}_{dname}", check_flash_attention, FWD_BATCH,
                 FWD_SEQ, H, K, hd, dtype)
            if hd == 64:
                case(f"k1_ragged_{arch}_{dname}", check_flash_attention,
                     FWD_BATCH, 4000, H, K, hd, dtype)
        torch.cuda.empty_cache()
        if hd == 64:
            check_flash_attention_bitwise(FWD_BATCH, FWD_SEQ, H, K, hd,
                                          seed=3)
            check_decode_determinism(BATCH, H, K, W, hd,
                                     (PROMPT + P, PROMPT + P + GEN - 2),
                                     seed=3)
    # head_dim 8 (command-r-35b's smoke config, served in phase 45): its
    # decode and forward shapes, the mask cases, bitwise
    sc = get_smoke_config("command-r-35b")
    H, K, hd = sc.num_heads, sc.num_kv_heads, sc.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for pos in (5, 23, 31, 40):
            case(f"k2_hd8_{dname}", check_decode_attention, B=2, H=H, K=K,
                 W=32, hd=hd, pos=pos, dtype=dtype)
        for S, T, causal, window, softcap in ((24, 24, True, 0, 0.0),
                                              (77, 77, True, 0, 0.0),
                                              (77, 130, False, 0, 0.0),
                                              (200, 200, True, 33, 30.0)):
            case(f"k1_hd8_{dname}", check_flash_attention, 2, S, H, K, hd,
                 dtype, T=T, causal=causal, window=window, softcap=softcap)
    check_flash_attention_bitwise(2, 200, H, K, hd, seed=4)
    check_decode_determinism(2, H, K, 32, hd, (20, 40), seed=4)
    errs["bitwise_over_launches_and_graph_replay"] = [
        "whisper-small", "internvl2-1b", "command-r-35b smoke (hd 8)"]
    return errs


def new_arch_phase(arch):
    """One of the last four archs at full width and depth (phases 44-47):
    random weights drawn on the card from seed 0, the serve cell through
    ``serve_phase`` (eager and graph engines, bitwise; K2 exactly layers
    x 63 and nothing else, K1 0; traced from window TRACED), the tapped
    forward at B=2, S=4096 (K1 exactly once a decoder
    layer, one commit row each), and Scale-Down at three layers where
    NEW_SCALE_DOWN_LAYERS names them. The weights are freed and the
    peak-memory counter reset before returning the record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils import tree_leaves

    cfg = get_config(arch)
    before = free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = build_model(cfg).init(0, device="cuda")
    torch.cuda.synchronize()
    rec: dict = {"memory_before": before,
                 "init_s": time.perf_counter() - t,
                 "params": sum(p.numel() for p in tree_leaves(params)),
                 "param_bytes": _nbytes(params)}
    serve_rec, trace = serve_phase(cfg, params)
    assert serve_rec["launches"]["k2"] == cfg.num_layers * (GEN - 1)
    assert serve_rec["launches"]["k1"] == 0
    log(phase=f"{arch}_serve", **serve_rec)
    log(phase=f"{arch}_trace", **trace)
    rec.update(serve=serve_rec, trace=trace,
               memory_after_serve=free_device_memory())
    fwd, model, batch = forward_phase(cfg, params)
    assert fwd["k1_launches"] == cfg.num_layers
    log(phase=f"{arch}_forward", **fwd)
    rec["forward"] = fwd
    if arch in NEW_SCALE_DOWN_LAYERS:
        sd = scale_down_phase(cfg, params, model, batch,
                              NEW_SCALE_DOWN_LAYERS[arch])
        log(phase=f"{arch}_scale_down", **sd)
        rec["scale_down"] = sd
    del params, model, batch
    rec["memory_after"] = free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    return rec


def free_device_memory():
    """Collect what only reference cycles keep alive and return the
    allocator's free blocks to the card. Returns the allocator's
    allocated and reserved bytes after, and the bytes still allocated in
    CUDA-graph private pools: cuBLAS's workspace of the card's one
    capture stream (32 MiB), first used inside a capture. While every
    capture ran on a new side stream, each left its workspace in a pool:
    5.34-5.47 GiB after the earlier phases, and command-r-35b's forward
    ran out of memory until they were released here."""
    import gc

    import torch

    from repro_torch.testing import private_pool_bytes
    gc.collect()
    torch.cuda.empty_cache()
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "allocated_in_private_pools": private_pool_bytes()}


def full_verify_phase(arch):
    """CoEmulator.verify at ``arch``'s full width and depth (phase 48),
    B=2, S=1024, 4 steps, step-locked, the bf16 train step on the "xla"
    path with the commit tap, under deterministic mode, TF32 off: the
    DUT against itself (max_rel_err and the loss difference exactly 0),
    faults at VERIFY_FAULT_LAYERS named (0, k) for a decoder-only stack
    (the enc-dec refusal of inject_fault is held on the host), and the
    bf16 DUT against the f32 oracle from the same seed (gated finite).
    Verified steps/s and peak memory of each."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import CoEmulator
    from repro_torch.core.coemu import inject_fault
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models import Runtime, build_model
    from repro_torch.testing import deterministic
    from repro_torch.train import init_state, make_train_step
    from repro_torch.utils import tree_leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    free_device_memory()
    cfg = get_config(arch)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    commits = frozenset({"commits"})
    model = build_model(cfg, Runtime(attention_impl="xla", taps=commits))
    model32 = build_model(cfg32, Runtime(attention_impl="xla", taps=commits))
    step, step32 = make_train_step(model), make_train_step(model32)
    fn = make_batch_fn(cfg, VERIFY_BATCH, VERIFY_SEQ, 0)
    batches = [fn(i) for i in range(VERIFY_STEPS)]
    rec: dict = {"arch": arch, "layers": cfg.num_layers,
                 "batch": VERIFY_BATCH, "seq": VERIFY_SEQ,
                 "steps": VERIFY_STEPS,
                 "inputs": {k: [list(v.shape), str(v.dtype)]
                            for k, v in batches[0].items()}}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with deterministic():
        state = init_state(model, 0, device="cuda")
        rec["params"] = sum(t.numel() for t in tree_leaves(state["params"]))
        emu = CoEmulator(step, step, rtol=1e-6)
        rep, t = _timed_verify(emu, state, state, batches)
        assert rep.steps == VERIFY_STEPS and not rep.diverged, rep
        assert rep.max_rel_err == 0.0 and rep.loss_max_abs_diff == 0.0, rep
        rec["self_verify"] = {**t, "summary": rep.summary(),
                              "max_memory_allocated":
                                  torch.cuda.max_memory_allocated()}
        if cfg.family != "encdec":
            faults = {}
            for k in VERIFY_FAULT_LAYERS:
                bad = {**state,
                       "params": inject_fault(state["params"], cfg, k)}
                rep = emu.verify(bad, state, batches)
                del bad
                assert rep.diverged and \
                    (rep.first.step, rep.first.layer) == (0, k), (k, rep)
                faults[k] = rep.summary()
            rec["faults"] = faults
        del emu
        torch.cuda.empty_cache()
        state32 = init_state(model32, 0, device="cuda")
        rec["state_bytes"] = {"dut": _nbytes(state), "orc": _nbytes(state32)}
        sink, on = [], [True]
        emu = CoEmulator(_recording(step, sink, on),
                         _recording(step32, sink, on), rtol=COEMU_BF16_RTOL)
        torch.cuda.reset_peak_memory_stats()
        rep, t = _timed_verify(emu, state, state32, batches)
        errs = _layer_errors(sink)
        assert np.isfinite(errs).all() and \
            np.isfinite(rep.loss_max_abs_diff), (errs, rep)
        rec["bf16_vs_f32"] = {
            **t, "rtol": COEMU_BF16_RTOL, "summary": rep.summary(),
            "diverged_at_rtol": rep.diverged, "max_rel_err": rep.max_rel_err,
            "max_rel_err_per_layer_mean_absmean": errs.tolist(),
            "loss_max_abs_diff": rep.loss_max_abs_diff,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del emu, sink, state, state32
    expect_counts(counts(), {}, f"{arch} verify (the xla path)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return rec


def last_four_phases(sms):
    """Phases 43-49 (the module docstring), with every earlier model's
    weights freed: the K1/K2 checks, then each of NEW_ARCHS at full width
    and depth (serve, forward, Scale-Down), the smoke parity, the verify
    at full depth and K1/K2 timed at head_dim 64. Returns {"record": the
    phases' records, "k1": / "k2": the entries they add to the kernels
    line}."""
    import torch

    from repro_torch.configs import get_config

    first = free_device_memory()
    log(phase="memory_before_last_four", **first)
    torch.cuda.reset_peak_memory_stats()
    # ----------------------------------------------------------- 43. k1/k2
    errs = new_kernel_check_phase(sms)
    log(phase="new_arch_kernels", max_abs_err_and_normwise_err=errs)
    torch.cuda.empty_cache()
    # ------------------------------- 44, 46, 47. serve, forward, Scale-Down
    archs = {arch: new_arch_phase(arch) for arch in NEW_ARCHS}
    # ------------------------------------------------------- 45. parity
    parity = serve_parity(NEW_ARCHS)
    log(phase="new_arch_parity", tokens_equal=True, tokens=parity)
    # ------------------------------------------------ 48. verify, full depth
    verify = {}
    for arch in VERIFY_ARCHS:
        verify[arch] = full_verify_phase(arch)
        log(phase=f"{arch}_verify", **verify[arch])
    # ------------------------------------------------ 49. k1, k2 at hd 64
    k1 = {"hd64": {}, "launches_new_arch_forwards": {
        a: r["forward"]["k1_launches"] for a, r in archs.items()}}
    k2 = {"hd64": {}, "launches_new_arch_serves": {
        a: r["serve"]["launches"]["k2"] for a, r in archs.items()}}
    for arch in VERIFY_ARCHS:
        c = get_config(arch)
        P = c.num_patches if c.family == "vlm" else 0
        # one q/k/v set and one cache set per decoder layer; pos inside
        # the serve run's decode (2048 + P + 2 to + 62)
        k1["hd64"][arch] = {
            "launches": archs[arch]["forward"]["k1_launches"],
            "max_abs_err": errs[f"k1_{arch}_bfloat16"][0],
            **k1_time(FWD_BATCH, FWD_SEQ, c.num_heads, c.num_kv_heads,
                      c.head_dim, 0, c.num_layers, seed=8)}
        log(phase=f"k1_time_{arch}", **k1["hd64"][arch])
        k2["hd64"][arch] = {
            "launches": archs[arch]["serve"]["launches"]["k2"],
            "max_abs_err": errs[f"k2_{arch}_bfloat16"][0],
            **k2_time(BATCH, c.num_heads, c.num_kv_heads,
                      PROMPT + P + GEN + 8, c.head_dim, PROMPT + P + 52,
                      c.num_layers, seed=9)}
        log(phase=f"k2_time_{arch}", **k2["hd64"][arch])
    return {"record": {"new_arch_kernel_errors": errs, "new_archs": archs,
                       "new_arch_parity": parity, "full_verify": verify,
                       "memory_before_last_four": first},
            "k1": k1, "k2": k2}


def host_us(torch, fn, calls=200, repeats=5):
    """A kernel wrapper's host time a call (its checks, the path choice,
    the outputs' allocation and the launch): ``calls`` calls of fn()
    enqueued between two synchronises, host clock, after a warm-up; the
    card's work per call is longer than the host's, so the queue never
    fills. Returns the least and the median of ``repeats`` such passes
    (the host clock of a shared machine is noisy)."""
    import statistics

    for _ in range(20):
        fn()
    passes = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        passes.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return {"min": min(passes), "median": statistics.median(passes)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--ledger-child"]:     # a child of phase 55
        return ledger_child(*sys.argv[2:4])

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.models import build_model
    from repro_torch.roofline.hw import device_exp_rate
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
    # the special-function units' exponential rate (K3's bound), from
    # roofline/: SFU_PER_CLOCK_PER_SM x SMs x the maximum SM clock
    exp_per_s = device_exp_rate()
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
            if "Used" in line or "spill" in line or "error" in line \
                    or "wgmma" in line:
                print("  " + line.strip(), flush=True)
    ptxas = {kname: ptxas_info(text) for kname, text in build_logs.items()}
    # whether K1's, K4's and K5's libraries hold Hopper's warpgroup
    # products (HGMMA), TMA loads (UTMALDG) and TMA stores (UTMASTG),
    # where the toolkit has cuobjdump
    sass_counts = {}
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    if cuobjdump.exists():
        for kname in ("flash_attention", "rglru_scan", "grouped_gemm"):
            sass = subprocess.run(
                [str(cuobjdump), "-sass", str(_build.library_path(kname))],
                capture_output=True, text=True, check=True,
                timeout=300).stdout
            sass_counts[kname] = {op: sass.count(op) for op in
                                  ("HGMMA", "UTMALDG", "UTMASTG")}
            print(f"cuobjdump {kname}: {sass_counts[kname]}", flush=True)
    log(phase="build", seconds=build_s, built=list(sources),
        sass=sass_counts)
    record["build_s"] = build_s
    record["sass"] = sass_counts
    record["ptxas"] = ptxas
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
    serve_rec, trace = serve_phase(cfg, params, roofline_gate=True)
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

    # ---------------------------------------------------- 40. scope-serve --
    # on phase 3's weights, before they are freed
    scope_serve = scope_serve_phase(cfg, params)
    log(phase="scope_serve", **scope_serve)
    record["scope_serve"] = scope_serve
    assert scope_serve["fused"]["k2_launches"] == launches, \
        (scope_serve["fused"]["k2_launches"], launches)
    k2["launches_scope_serve"] = scope_serve["fused"]["k2_launches"]

    # ---------------------------------------------------------- 50. farm --
    farm = farm_phase(cfg, params)
    log(phase="farm", **{k: v for k, v in farm.items()
                         if k != "solo_checksums"})
    record["farm"] = farm
    k1["launches_farm"] = {"solo": farm["solo"]["k1_launches"],
                           "lanes": farm["lanes"]["k1_launches"]}

    # --------------------------------------------------------- 51. mixed --
    mixed = mixed_pass_phase(cfg, params, serve_rec, farm)
    log(phase="mixed", **mixed)
    record["mixed"] = mixed
    k1["launches_mixed"] = mixed["k1_launches"]
    k2["launches_mixed"] = mixed["k2_launches"]

    # ---------------------------------------------------- 52. farm-async --
    farm_async = farm_async_phase(cfg, params, farm)
    log(phase="farm_async", **farm_async)
    record["farm_async"] = farm_async
    k1["launches_farm_async"] = {"solo": farm_async["solo"]["k1_launches"],
                                 "lanes": farm_async["lanes"]["k1_launches"]}

    # ---------------------------------------------------- 53. farm-mixed --
    farm_mixed = farm_mixed_phase(cfg, params, serve_rec, farm)
    log(phase="farm_mixed", **farm_mixed)
    record["farm_mixed"] = farm_mixed
    k1["launches_farm_mixed"] = farm_mixed["async"]["k1_launches"]
    k2["launches_farm_mixed"] = farm_mixed["async"]["k2_launches"]

    # ------------------------------------------------- 56. farm-certify --
    farm_certify = farm_certify_phase(cfg, params, serve_rec, farm)
    log(phase="farm_certify", **farm_certify)
    record["farm_certify"] = farm_certify
    k1["launches_certify"] = {m: farm_certify[m]["k1_launches"]
                              for m in ("lockstep", "async")}
    k2["launches_certify"] = {m: farm_certify[m]["k2_launches"]
                              for m in ("lockstep", "async")}

    # ------------------------------------------------------ 57. roofline --
    t = time.perf_counter()
    roofline = {"serve": serve_rec["roofline_gate"],
                "farm": roofline_farm_phase(cfg, params, farm)}
    roofline["farm_s"] = time.perf_counter() - t
    log(phase="roofline", **roofline)
    record["roofline"] = roofline
    k1["launches_roofline_farm"] = {m: roofline["farm"][m]["k1_launches"]
                                    for m in ("lockstep", "async")}
    del params, model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ------------------------------------------------------ 54. farm-cli --
    farm_cli = farm_cli_phase()
    log(phase="farm_cli", **farm_cli)
    record["farm_cli"] = farm_cli

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
    k3_fwd = k3_time(scfg, FWD_BATCH, FWD_SEQ, exp_per_s,
                     ptxas["ssm_scan"])
    k3_pre = k3_time(scfg, BATCH, PROMPT, exp_per_s, ptxas["ssm_scan"])
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
    k4_fwd = k4_time(hcfg, FWD_BATCH, FWD_SEQ, ptxas["rglru_scan"])
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
        "plan": {"forward": k4_fwd["plan"], "prefill": k4_pre["plan"]},
        "host_us_per_call": k4_fwd["host_us_per_call"],
        "ptxas": k4_fwd["ptxas"],
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
    k5_t = {f"{name}_{prod}": k5_time(
        E, C, *dims, seed=6,
        paths=("wgmma", "mma") if name == "decode" else ())
        for name, C in MOE_CAPACITIES.items()
        for prod, dims in (("gate_up", (D, F)), ("down", (F, D)))}
    log(phase="k5_time", **k5_t)
    x = torch.randn(E, MOE_CAPACITIES["decode"], D,
                    device="cuda").to(torch.bfloat16)
    w = torch.randn(E, D, F, device="cuda").to(torch.bfloat16)
    k5_host = host_us(torch, lambda: gg_ops.grouped_gemm(x, w))
    del x, w
    log(phase="k5_host", us_per_call_decode_shape=k5_host)
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
        "host_us_per_call": k5_host,
        "ptxas": {k: v for k, v in ptxas["grouped_gemm"].items()
                  if "wgmma" in k},
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

    # ---------------------------------------------------------- 36. train --
    train = train_phase()
    log(phase="train", **train)
    record["train"] = train

    # --------------------------------------------------- 37. train parity --
    train_par = train_parity_phase()
    log(phase="train_parity", **train_par)
    record["train_parity"] = train_par

    # ---------------------------------------------------------- 38. coemu --
    coemu = coemu_phase()
    log(phase="coemu", **coemu)
    record["coemu"] = coemu
    k1["launches_coemu_kernel_dut"] = coemu["kernel_dut"]["group_1"][
        "k1_launches"]

    # ----------------------------------------------------------- 39. loop --
    loop = loop_phase()
    log(phase="loop", **loop)
    record["loop"] = loop

    # ----------------------------------------------------- 41. scope-loop --
    scope_loop = scope_loop_phase()
    log(phase="scope_loop", **scope_loop)
    record["scope_loop"] = scope_loop

    # ---------------------------------------------------------- 42. remat --
    remat = remat_phase()
    log(phase="remat", **remat)
    record["remat"] = remat

    # ------------------------------------------------------- the examples --
    examples = examples_phase()
    log(phase="examples", **examples)
    record["examples"] = examples

    # ------------------------------------------ 43-49. the last four archs --
    new = last_four_phases(sms)
    record.update(new["record"])
    for kern, part in ((k1, new["k1"]), (k2, new["k2"])):
        kern.update(part)

    # --------------------------------------------------- 55. farm-ledger --
    # every model is freed: the phase's children need the card. cuBLAS
    # keeps a 32 MiB workspace for each (handle, stream) pair it has met
    # (13 after phase 54's chaos runs retired seats); no graph replays
    # after this, and the next product makes its own again
    torch._C._cuda_clearCublasWorkspaces()
    before = free_device_memory()
    before["free"], before["total"] = torch.cuda.mem_get_info()
    log(phase="memory_before_ledger", **before)
    assert before["reserved"] < LEDGER_PARENT_RESERVED, before
    farm_ledger = farm_ledger_phase(farm["solo_checksums"])
    log(phase="farm_ledger", **farm_ledger)
    record["farm_ledger"] = farm_ledger
    k1["launches_ledger"] = {
        "oracle": farm_ledger["oracle"]["launches"]["k1"],
        "recovery": farm_ledger["recover"]["launches"]["k1"]}

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
