"""Checks of the port on the card, shared by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``: the kernels each path launches, a scheduler
timer that forbids host syncs inside a decode window, K1 to K5 held
against their plain versions, the commit-tapped forward with its
Scale-Down replay on the card against the same on the host, the train
windows, a forward-only step that the co-emulator verifies, K1's vmap
rule, the bytes held in CUDA-graph private pools, and serve's decode as a
``run_many`` client."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.commit import layer_checksums, nan_bits
from repro_torch.core.decompose import verify_extraction
from repro_torch.core.scope import _FNV, _M32, digest_tree
from repro_torch.core.graphs import capture_graph  # noqa: F401
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref, moe_ffn_ref
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import Runtime, build_model
from repro_torch.models import moe as moe_mod
from repro_torch.launch.serve import serve
from repro_torch.models.layers import embed_apply
from repro_torch.utils import tree_leaves, tree_map

# elementwise rtol = atol: the tolerances of tests/test_kernels.py
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 also holds ||out - ref|| / ||ref|| under this limit. At the serve
# shapes an output element is about 0.036, so the elementwise 2e-2 alone
# passes a slot wrongly masked in or out, which moves the output by 1.8e-2
# to 2.8e-2 normwise. The kernel and its plain version round to bf16 at
# different points (the kernel rounds weights before they are normalised)
# and differ by about 3e-3 normwise on an H100.
BF16_NORM_REL = 6e-3
# K1's bf16 limit, set the same way from readings on an H100 (PERF.md):
# the kernel rounds its unnormalised weights to bf16, the plain version
# its normalised ones.
FA_BF16_NORM_REL = 6e-3
# K3 in f32, y and h_last: the tolerance of the reference's test_ssm_scan
SSM_TOL = 1e-4
# K5's bf16 limit on ||out - ref|| / ||ref||. The kernel and its plain
# version round the same products' f32 sums once to bf16, summed in
# another order, so only the few elements whose sums straddle a rounding
# boundary differ, by one bf16 ulp (well under 1e-3 normwise); a K slice
# of 16 left out of K = 2048 moves the output by 9e-2, a row or column of
# a tile masked wrongly by more.
GG_BF16_NORM_REL = 2e-3
# the composed expert FFN in f32: the tolerance of the reference's
# test_moe_ffn_composed
MOE_FFN_TOL = 1e-4
# card against host in f32: the co-emulator's relative error
# |a - b| / (|b| + 1e-6) of the loss and of each checksum's mean |x|
# component; a checksum's mean component relative to its layer's mean |x|
PARITY_RTOL = 1e-5
TAPS = frozenset({"commits", "coverage"})
# the kernel that each mixer's full-sequence forward launches once
MIXER_KERNEL = {"attn": "k1", "swa": "k1", "local": "k1", "mamba": "k3",
                "rglru": "k4"}


def layer_kernels(cfg):
    """Per layer, in period-major order, the kernels its full-sequence
    forward launches and how often: the mixer's kernel once and, for a
    MoE FFN, K5 three times (the gate, up and down products). An enc-dec
    config's layers are its decoder's (K1 once each, in the
    self-attention); its encoder and cross-attention are plain, as in the
    reference. A VLM's are its decoder stack's."""
    out = []
    for mixer, ffn in cfg.layer_specs:
        t = {MIXER_KERNEL[mixer]: 1}
        if ffn == "moe":
            t["k5"] = 3
        out.append(t)
    return out


def tally(tallies, times: int = 1):
    """The sum of per-layer (or per-path) launch tallies, ``times`` over."""
    out: dict = {}
    for t in tallies:
        for k, n in t.items():
            out[k] = out.get(k, 0) + n * times
    return out


def serve_kernels(cfg, steps: int):
    """(prefill, whole run) launch tallies of a serve run with ``steps``
    decode steps. The prefill runs K3 or K4 once a mamba or RG-LRU layer
    (its attention is plain, as in the reference) and K5 three times a
    MoE layer; each decode step runs K2 once an attention layer and K5
    three times a MoE layer (the mamba and RG-LRU steps are plain; an
    enc-dec decoder layer's K2 is its self-attention's, its encoder and
    cross-attention plain). A
    decode window run as a CUDA-graph replay counts the launches it
    executes (``core.graphs.WindowGraphs``), so the tallies hold for both
    engines."""
    prefill = [{k: n for k, n in t.items() if k != "k1"}
               for t in layer_kernels(cfg)]
    step = [{("k2" if k == "k1" else k): n for k, n in t.items()
             if k in ("k1", "k5")} for t in layer_kernels(cfg)]
    pre = tally(prefill)
    return pre, tally([pre, tally(step, steps)])


class NoSyncInWindow:
    """Scheduler timer: each window's dispatch (the "device" phase) runs
    under CUDA sync-debug mode "error", so a host sync inside a decode
    window raises. Counts the windows it has seen."""

    def __init__(self):
        self.windows = 0

    @contextlib.contextmanager
    def phase(self, name):
        if name != "device":
            yield
            return
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
        self.windows += 1


def check_decode_attention(B, H, K, W, hd, pos, dtype, softcap=0.0, seed=0):
    """K2 on random inputs drawn on the card from ``seed``, against its
    plain version on the same inputs. Raises AssertionError where they
    disagree; returns (max abs error, normwise relative error)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, W, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, W, K, hd, generator=g, device=dev).to(dtype)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = ops.decode_attention(q, k, v, pos=p, window=W, softcap=softcap)
    ref = decode_attention_ref(q, k, v, pos=p, window=W, softcap=softcap)
    case = (f"K2 vs plain, B={B} H={H} K={K} W={W} hd={hd} pos={pos} "
            f"{dtype} softcap={softcap}")
    return _compare(out, ref, dtype, case, BF16_NORM_REL)


def check_decode_determinism(B, H, K, W, hd, positions, seed=0):
    """K2 in bf16 on random inputs drawn on the card from ``seed``, at
    each of ``positions`` in turn (``pos`` rewritten on the card): two
    launches, one counted launch each, equal to the bit, and three replays
    of one CUDA graph, captured at the first position, equal to them (the
    splits merge in a fixed order, and a replay reads ``pos`` on the
    card). Raises AssertionError otherwise."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, W, K, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, W, K, hd, generator=g, device=dev).bfloat16()
    p = torch.tensor(positions[0], dtype=torch.int32, device=dev)

    def call():
        return ops.decode_attention(q, k, v, pos=p, window=W)

    graph = None
    for pos in positions:
        p.fill_(pos)
        before = ops.decode_attention.launches
        a, b = call(), call()
        assert ops.decode_attention.launches == before + 2, pos
        assert torch.equal(a, b), f"two launches differ at pos {pos}"
        if graph is None:
            graph, c = capture_graph(call)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(a, c), f"a graph replay differs at pos {pos}"


def _compare(out, ref, dtype, case, norm_limit, tol=None):
    """Elementwise at ``tol`` (default TOL), and in bf16 also normwise
    under ``norm_limit``; returns (max abs error, normwise relative
    error)."""
    assert out.dtype == dtype and out.shape == ref.shape, case
    tol = TOL[dtype] if tol is None else tol
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{case}: {m}")
    diff = out.float() - ref.float()
    rel = float(diff.norm() / ref.float().norm().clamp_min(1e-30))
    if dtype == torch.bfloat16:
        assert rel <= norm_limit, f"{case}: normwise error {rel}"
    return float(diff.abs().max()), rel


def check_flash_attention(B, S, H, K, hd, dtype, T=None, causal=True,
                          window=0, softcap=0.0, seed=0):
    """K1 on random inputs drawn on the card from ``seed`` (q and k scaled
    by 3 under a softcap, so the cap bites), against its plain version on
    the same inputs.
    Raises AssertionError where they disagree; returns (max abs error,
    normwise relative error)."""
    T = S if T is None else T
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    sc = 3.0 if softcap > 0 else 1.0
    q = (sc * torch.randn(B, S, H, hd, generator=g, device=dev)).to(dtype)
    k = (sc * torch.randn(B, T, K, hd, generator=g, device=dev)).to(dtype)
    v = torch.randn(B, T, K, hd, generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = fa_ops.flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    case = (f"K1 vs plain, B={B} S={S} T={T} H={H} K={K} hd={hd} {dtype} "
            f"causal={causal} window={window} softcap={softcap}")
    return _compare(out, ref, dtype, case, FA_BF16_NORM_REL)


def _ssm_scan_inputs(B, S, Din, N, seed, strided):
    """The reference test's distributions, drawn on the card from
    ``seed``: dt = softplus(normal), A = -exp(normal / 2), B_, C_ and x
    normal; ``strided``: B_ and C_ views into one (B, S, 8 + 2N) tensor."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    dt = torch.nn.functional.softplus(rand(B, S, Din))
    A = -torch.exp(0.5 * rand(Din, N))
    if strided:
        _, B_, C_ = torch.split(rand(B, S, 8 + 2 * N), [8, N, N], dim=-1)
    else:
        B_, C_ = rand(B, S, N), rand(B, S, N)
    return dt, A, B_, C_, rand(B, S, Din)


def check_ssm_scan(B, S, Din, N, seed=0, strided=False, group=None):
    """K3 on random inputs drawn on the card from ``seed`` (the reference
    test's distributions: dt = softplus(normal), A = -exp(normal / 2),
    B_, C_ and x normal), against its plain version on the same inputs, y
    and h_last at SSM_TOL. ``strided``: B_ and C_ are views into one
    (B, S, 8 + 2N) tensor, as the model splits them off its projection.
    ``group``: the lanes a channel (default: the wrapper's choice).
    Raises AssertionError where they disagree; returns the max abs errors
    of y and of h_last."""
    dt, A, B_, C_, x = _ssm_scan_inputs(B, S, Din, N, seed, strided)
    before = ssm_ops.ssm_scan.launches
    y, h = ssm_ops.ssm_scan(dt, A, B_, C_, x) if group is None \
        else ssm_ops._launch(dt, A, B_, C_, x, group)
    assert ssm_ops.ssm_scan.launches == before + 1
    yr, hr = ssm_scan_ref(dt, A, B_, C_, x)
    case = (f"K3 vs plain, B={B} S={S} Din={Din} N={N} strided={strided} "
            f"group={group}")
    for name, a, b in (("y", y, yr), ("h_last", h, hr)):
        assert a.dtype == torch.float32 and a.shape == b.shape, case
        torch.testing.assert_close(a, b, rtol=SSM_TOL, atol=SSM_TOL,
                                   msg=lambda m: f"{case} {name}: {m}")
    return (float((y - yr).abs().max()), float((h - hr).abs().max()))


def rglru_scan_inputs(B, S, W, seed, offset=False):
    """a = sigmoid(normal), b and h0 normal (the reference test's
    distributions), drawn on the card from ``seed``; ``offset``: a and b
    start one element past a 16-byte boundary (contiguous views into
    longer buffers)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    n = B * S * W
    a = torch.sigmoid(rand(n + offset))[int(offset):].view(B, S, W)
    b = rand(n + offset)[int(offset):].view(B, S, W)
    return a, b, rand(B, W)


def _rglru_call(path):
    return lru_ops.rglru_scan if path is None else \
        lambda a, b, h0: lru_ops._launch(a, b, h0, path)


def check_rglru_scan(B, S, W, seed=0, split=None, path=None, offset=False):
    """K4 through ``path`` (default: the wrapper's choice) on the inputs
    of ``rglru_scan_inputs``, against its plain version on the same
    inputs: h_all and h_last equal to the bit (each step is rounded as the
    plain version rounds it, in time order). ``split`` = s1 also checks
    the chaining property: the first s1 steps, then the rest from their
    h_last, equal one pass to the bit. Raises AssertionError where they
    differ; returns the max abs errors of h_all and h_last (0.0)."""
    a, b, h0 = rglru_scan_inputs(B, S, W, seed, offset)
    call = _rglru_call(path)
    before = lru_ops.rglru_scan.launches
    h, h_last = call(a, b, h0)
    assert lru_ops.rglru_scan.launches == before + 1
    hr, hr_last = rglru_scan_ref(a, b, h0)
    case = f"K4 ({path or 'wrapper'}) vs plain, B={B} S={S} W={W}"
    pairs = [("h_all", h, hr), ("h_last", h_last, hr_last)]
    if split is not None:
        h1, h1_last = call(a[:, :split].contiguous(),
                           b[:, :split].contiguous(), h0)
        h2, h2_last = call(a[:, split:].contiguous(),
                           b[:, split:].contiguous(), h1_last)
        case += f" split at {split}"
        pairs += [("chained h_all", torch.cat([h1, h2], dim=1), h),
                  ("chained h_last", h2_last, h_last)]
    for name, x, y in pairs:
        assert x.dtype == torch.float32 and x.shape == y.shape, case
        assert torch.equal(x, y), (
            f"{case} {name}: max abs difference "
            f"{float((x - y).abs().max())}")
    return (float((h - hr).abs().max()), float((h_last - hr_last).abs().max()))


def check_rglru_scan_bitwise(B, S, W, seed=0, path=None):
    """K4 through ``path`` bitwise over launches and a CUDA-graph replay
    (``check_bitwise``)."""
    a, b, h0 = rglru_scan_inputs(B, S, W, seed)
    call = _rglru_call(path)
    check_bitwise(lambda: call(a, b, h0), lru_ops.rglru_scan)


def _grouped_gemm_inputs(E, M, K, N, dtype, seed, offset=False):
    """x normal and w normal at the model's K ** -0.5 scale, drawn on the
    card from ``seed``; ``offset``: x starts one element past a 16-byte
    boundary (a contiguous view into a longer buffer)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(E * M * K + int(offset), generator=g, device=dev) \
        .to(dtype)[int(offset):].view(E, M, K)
    w = (torch.randn(E, K, N, generator=g, device=dev) * K ** -0.5) \
        .to(dtype)
    return x, w


def check_grouped_gemm(E, M, K, N, dtype, seed=0, path=None, offset=False):
    """K5 on random inputs drawn on the card from ``seed`` (x normal, w
    normal at the model's K ** -0.5 scale), through kernel ``path``
    (default: the wrapper's choice), against its plain version on the same
    inputs. ``offset``: x's base off a 16-byte boundary. Raises
    AssertionError where they disagree; returns (max abs error, normwise
    relative error)."""
    x, w = _grouped_gemm_inputs(E, M, K, N, dtype, seed, offset)
    before = gg_ops.grouped_gemm.launches
    out = gg_ops.grouped_gemm(x, w) if path is None \
        else gg_ops._launch(x, w, path)
    assert gg_ops.grouped_gemm.launches == before + 1
    taken = path or gg_ops.choose_path(dtype, M, K, N, x.data_ptr(),
                                       w.data_ptr())
    case = (f"K5 vs plain, E={E} M={M} K={K} N={N} {dtype} path={taken} "
            f"offset={offset}")
    return _compare(out, grouped_gemm_ref(x, w), dtype, case,
                    GG_BF16_NORM_REL)


def check_bitwise(call, counter, replays=3):
    """``call()`` (one kernel launch, counted on ``counter``) twice, equal
    to the bit, and ``replays`` replays of one CUDA graph that captured it,
    equal to them. Raises AssertionError otherwise."""
    def flat(out):
        return out if isinstance(out, tuple) else (out,)

    before = counter.launches
    a, b = flat(call()), flat(call())
    assert counter.launches == before + 2, "one launch a call"
    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
        "two launches differ"
    graph, c = capture_graph(call)
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, flat(c))), \
            "a graph replay differs from the eager launch"


def check_flash_attention_bitwise(B, S, H, K, hd, seed=0):
    """K1 in bf16, causal, on random inputs drawn on the card from
    ``seed``, bitwise over launches and a CUDA-graph replay
    (``check_bitwise``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(B, S, K, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(B, S, K, hd, generator=g, device="cuda").bfloat16()
    check_bitwise(lambda: fa_ops.flash_attention(q, k, v),
                  fa_ops.flash_attention)


def check_flash_attention_vmap(L, B, S, H, K, hd, window=0, causal=True,
                               seed=0, replays=2):
    """K1 under ``torch.func.vmap`` over L lanes (its vmap rule: one
    launch for all lanes, the lane axis folded into the batch axis) in
    bf16 on random inputs drawn on the card from ``seed``: counted as ONE
    launch, each lane's output equal to the bit to that lane's solo
    launch, and a CUDA graph that captured the vmapped call holding one
    launch (what ``core/graphs.py`` adds back at each replay) and equal
    to the eager call at each replay. Raises AssertionError otherwise."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(L, B, S, H, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(L, B, S, K, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(L, B, S, K, hd, generator=g, device="cuda").bfloat16()
    kw = dict(causal=causal, window=window)

    def fused():
        return torch.func.vmap(
            lambda a, b, c: fa_ops.flash_attention(a, b, c, **kw))(q, k, v)

    counter = fa_ops.flash_attention
    before = counter.launches
    out = fused()
    assert counter.launches == before + 1, "one launch for every lane"
    for lane in range(L):
        solo = fa_ops.flash_attention(q[lane], k[lane], v[lane], **kw)
        assert torch.equal(out[lane], solo), \
            f"lane {lane} differs from its solo launch"
    before = counter.launches
    graph, c = capture_graph(fused)
    assert counter.launches == before, "a capture counts no launch"
    # what core/graphs.py re-adds to the counts at each replay
    assert graph.launches == {"k1": 1}, graph.launches
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(c, out), "a replay differs from the eager call"


def private_pool_bytes() -> int:
    """Bytes the caching allocator holds allocated in CUDA-graph private
    pools (the pools of captured graphs, and whatever a capture left in
    them), after a garbage collection."""
    import gc
    gc.collect()
    return sum(b["size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)
               for b in seg["blocks"] if b["state"] == "active_allocated")


def serve_decode_client(cfg, params, batch, prompt_len, gen, *, seed=0,
                        sample_interval=4, device="cuda", graph=None):
    """``serve()``'s prefill of ``cfg`` on ``params``, then its decode as a
    ``run_many`` client: the engine of ``make_decode_engine`` (on a card a
    ``WindowGraphs``, every window length captured here, before the pass,
    as serve does) with its P-Shell decode shell and drain. Returns
    ``(client, on_drain, tokens)``: ``on_drain(plan, records, toks)`` is
    the client's sink and ``tokens()`` the (batch, gen) greedy tokens
    drained so far, as serve's ``out["tokens"]``. Call it, and run the
    pass, under ``torch.inference_mode()``."""
    from repro_torch.core.graphs import WindowGraphs
    from repro_torch.core.pshell import drain, shell_init, stack_batches
    from repro_torch.core.schedule import Client, iter_windows, plan_windows
    from repro_torch.launch.serve import (_FRONTEND_INPUTS,
                                          decode_shell_config,
                                          make_decode_engine)
    from repro_torch.serve import make_prefill_step
    from repro_torch.utils import dtype_of
    device = torch.device(device)
    model = build_model(cfg)
    bf = make_batch_fn(cfg, batch, prompt_len, seed)
    b = {k: torch.from_numpy(v).to(device, dtype_of(cfg.dtype)
                                   if k in _FRONTEND_INPUTS else None)
         for k, v in bf(0).items() if k != "labels"}
    max_len = prompt_len + (cfg.num_patches if cfg.family == "vlm" else 0) \
        + gen + 8
    cache, logits = make_prefill_step(model, max_len)(params, b)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    engine = make_decode_engine(model, params, graph=graph)
    shell = shell_init(decode_shell_config(sample_interval), device)
    if isinstance(engine, WindowGraphs):
        for g in dict.fromkeys(p.size for p in plan_windows(
                gen - 1, sample_interval)):
            engine.prepare((cache, tok), shell, np.arange(g))
    out = [tok.cpu().numpy()]

    def on_drain(plan, records, toks):
        out.append(toks.numpy()[:, :, 0].T)

    client = Client(engine, iter_windows(range(gen - 1), sample_interval),
                    (cache, tok), shell, drain_fn=drain,
                    stack_fn=stack_batches)
    return client, on_drain, lambda: np.concatenate(out, axis=1).tolist()


def check_grouped_gemm_bitwise(E, M, K, N, dtype, seed=0, path=None):
    """K5 through ``path`` bitwise over launches and a CUDA-graph replay
    (``check_bitwise``)."""
    x, w = _grouped_gemm_inputs(E, M, K, N, dtype, seed)
    check_bitwise(lambda: gg_ops.grouped_gemm(x, w) if path is None
                  else gg_ops._launch(x, w, path), gg_ops.grouped_gemm)


def check_ssm_scan_bitwise(B, S, Din, N, seed=0, group=None):
    """K3 on the inputs of ``check_ssm_scan`` (B_ and C_ strided), with
    ``group`` lanes a channel (default: the wrapper's choice), bitwise
    over launches and a CUDA-graph replay (``check_bitwise``)."""
    args = _ssm_scan_inputs(B, S, Din, N, seed, strided=True)
    check_bitwise(lambda: ssm_ops.ssm_scan(*args) if group is None
                  else ssm_ops._launch(*args, group), ssm_ops.ssm_scan)


def check_moe_ffn(E, C, D, F, dtype, seed=0):
    """The expert FFN through three K5 launches (``moe_ffn``) against its
    plain version, on inputs drawn on the card (the model's weight
    scales): f32 at MOE_FFN_TOL, bf16 at TOL and GG_BF16_NORM_REL.
    Returns (max abs error, normwise relative error)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            dtype)

    args = (rand((E, C, D)), rand((E, D, F), D ** -0.5),
            rand((E, D, F), D ** -0.5), rand((E, F, D), F ** -0.5))
    before = gg_ops.grouped_gemm.launches
    out = gg_ops.moe_ffn(*args)
    assert gg_ops.grouped_gemm.launches == before + 3
    case = f"moe_ffn vs plain, E={E} C={C} D={D} F={F} {dtype}"
    return _compare(out, moe_ffn_ref(*args), dtype, case, GG_BF16_NORM_REL,
                    tol=MOE_FFN_TOL if dtype == torch.float32 else None)


def _router_stats(aux):
    """Every MoE layer's expert load (rows) and dropped fraction, host
    numpy, scanned pattern positions first, then the tail."""
    blocks = [blk["moe"] for part in ("scanned", "tail")
              for blk in aux.get(part, ()) if "moe" in blk]
    if not blocks:
        return None
    load = torch.cat([m["load"].reshape(-1, m["load"].shape[-1])
                      for m in blocks]).cpu().numpy()
    dropped = torch.cat([m["dropped_frac"].reshape(-1)
                         for m in blocks]).cpu().numpy()
    return load, dropped


@contextlib.contextmanager
def _router_margins(margins: list):
    """Records, for each routing while active, the smallest gap between a
    token's k-th and (k+1)-th router probability: how close the routing
    came to a flip."""
    route = moe_mod._route

    def recording(p, cfg, x2):
        out = route(p, cfg, x2)
        k = cfg.num_experts_per_tok
        if k < cfg.num_experts:
            top = torch.topk(out[2], k + 1, dim=-1).values
            margins.append(float((top[:, k - 1] - top[:, k]).min()))
        return out

    moe_mod._route = recording
    try:
        yield
    finally:
        moe_mod._route = route


def check_forward_parity(cfg, B=2, S=24, seed=0):
    """The commit-tapped loss and the Scale-Down replay of every layer of
    ``cfg`` (an f32 config), from the same weights drawn on the host from
    ``seed``, on the card (K1, K3, K4 or K5, and cuBLAS) and on the host
    (plain versions).

    Gated: the loss and each checksum's mean |x| component within
    PARITY_RTOL as the co-emulator's relative error; each checksum's mean
    component within PARITY_RTOL of its layer's mean |x|,
    |d mean| / (mean|x|_host + 1e-6). The mean alone is ill-conditioned
    where it is small against mean |x| (an f32 ulp of mean |x| can be 1e-4
    of it), so it is scaled by the magnitude it is summed from. The old
    per-component relative error is returned ungated, as
    ``componentwise_rel_err``. The nan bits must agree exactly, every
    replay must be bitwise on both, and for a MoE config each layer's
    expert load (the "router" tap) must be equal and so must the entries
    it dropped, ``dropped_frac`` times the B*S*k entries, rounded: the
    fraction is a mean of 0/1 flags, which the card scales by 1/n and the
    host divides by n, so it may differ by an f32 ulp with the same
    entries dropped. A routing flip is reported with the host's smallest
    top-k margin. Returns the errors and each kernel's launches on the
    card."""
    taps = TAPS | {"router"} if cfg.num_experts else TAPS
    model = build_model(cfg, Runtime(taps=taps))
    host = model.init(seed, device="cpu")
    batch = make_batch_fn(cfg, B, S, seed)(0)
    kernels = {"k1": fa_ops.flash_attention, "k3": ssm_ops.ssm_scan,
               "k4": lru_ops.rglru_scan, "k5": gg_ops.grouped_gemm}
    margins: list = []
    runs = []
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.to(dev), host)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = {k: fn.launches for k, fn in kernels.items()}
        record = _router_margins(margins) if dev == "cpu" \
            else contextlib.nullcontext()
        with torch.inference_mode():
            with record:
                loss, (_, aux) = model.loss(params, b)
            # the replay's input is the text's embedding (a VLM's tokens
            # are S less its patches)
            x = embed_apply(params["embed"], b["tokens"])
            St = b["tokens"].shape[1]
            pos = torch.arange(St, dtype=torch.int32,
                               device=dev).expand(B, St)
            bitwise = [verify_extraction(params, cfg, x, pos, model.rt,
                                         i)["bitwise_identical"]
                       for i in range(cfg.num_layers)]
        runs.append({"loss": loss.cpu().numpy(),
                     "cks": layer_checksums(aux).cpu().numpy(),
                     "nan": nan_bits(aux).cpu().numpy(),
                     "router": _router_stats(aux),
                     "bitwise": bitwise,
                     "launches": {k: fn.launches - before[k]
                                  for k, fn in kernels.items()}})
    a, b = runs

    def rel(x, y):
        return float((np.abs(x - y) / (np.abs(y) + 1e-6)).max())

    abs_mean = np.abs(b["cks"][:, 1]) + 1e-6
    mean_err = float((np.abs(a["cks"][:, 0] - b["cks"][:, 0])
                      / abs_mean).max())
    abs_mean_err = rel(a["cks"][:, 1], b["cks"][:, 1])
    out = {"seed": seed, "loss": float(a["loss"]),
           "loss_rel_err": rel(a["loss"], b["loss"]),
           "mean_err": mean_err, "abs_mean_rel_err": abs_mean_err,
           "checksum_err": max(mean_err, abs_mean_err),
           "componentwise_rel_err": rel(a["cks"], b["cks"]),
           "bitwise": [a["bitwise"], b["bitwise"]],
           **{f"{k}_launches": n for k, n in a["launches"].items()}}
    if a["router"] is not None:
        entries = B * S * cfg.num_experts_per_tok
        out["load_equal"] = bool(np.array_equal(a["router"][0],
                                                b["router"][0]))
        out["dropped_entries"] = [np.rint(f * entries).astype(int).tolist()
                                  for f in (a["router"][1], b["router"][1])]
        out["router_equal"] = out["load_equal"] \
            and out["dropped_entries"][0] == out["dropped_entries"][1]
        out["dropped_frac_max_diff"] = float(
            np.abs(a["router"][1] - b["router"][1]).max())
        out["router_min_topk_margin"] = min(margins)
    case = f"forward parity {cfg.name}: {out}"
    assert out["loss_rel_err"] <= PARITY_RTOL, case
    assert out["checksum_err"] <= PARITY_RTOL, case
    assert np.array_equal(a["nan"], b["nan"]), case
    assert all(a["bitwise"]) and all(b["bitwise"]), case
    assert out.get("router_equal", True), f"routing flip: {case}"
    return out


# ----------------------------------------------- CUDA-graph windows, train --
@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` while active (cuBLAS
    needs ``CUBLAS_WORKSPACE_CONFIG``, e.g. ``:4096:8``, set before CUDA
    initialises, or it raises)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def assert_trees_equal(a, b, what):
    """Every leaf of ``a`` equal to ``b``'s to the bit (on the host)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        x = x.cpu() if torch.is_tensor(x) else torch.as_tensor(x)
        y = y.cpu() if torch.is_tensor(y) else torch.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(x, y), (
            f"{what}: leaf {i} differs, max abs "
            f"{float((x.double() - y.double()).abs().max())}")


def assert_records_equal(recs_a, recs_b, what):
    """Drained P-Shell records (``[(i, records)]``) equal: drain cadence,
    FIFO counts, dropped credits and payloads, CSRs, and the "metrics"
    stacks where both carry them."""
    assert [i for i, _ in recs_a] == [i for i, _ in recs_b], what
    for (i, ra), (_, rb) in zip(recs_a, recs_b):
        assert set(ra["fifos"]) == set(rb["fifos"]), (what, i)
        for name, fa in ra["fifos"].items():
            fb = rb["fifos"][name]
            assert fa["count"] == fb["count"], (what, i, name)
            assert fa["dropped"] == fb["dropped"], (what, i, name)
            assert np.array_equal(fa["data"], fb["data"]), (what, i, name)
        assert set(ra["csrs"]) == set(rb["csrs"]), (what, i)
        for name in ra["csrs"]:
            assert np.array_equal(ra["csrs"][name], rb["csrs"][name]), \
                (what, i, name)
        for name in set(ra.get("metrics", {})) & set(rb.get("metrics", {})):
            assert np.array_equal(ra["metrics"][name],
                                  rb["metrics"][name]), (what, i, name)


def assert_serve_equal(a, b, what):
    """Two serve records (``serve(..., return_cache=True)``) equal to the
    bit: tokens, every drained FIFO row, count, dropped credit and
    ``tokens`` CSR, and the final decode cache (KV rings, recurrent
    states, ``pos``)."""
    assert a["tokens"] == b["tokens"], f"{what}: tokens differ"
    assert len(a["drained"]) == len(b["drained"]), what
    for i, (x, y) in enumerate(zip(a["drained"], b["drained"])):
        assert x == y, f"{what}: drained window {i}: {x} != {y}"
    assert a["decode_fifo_rows"] == b["decode_fifo_rows"], what
    assert_trees_equal(a["cache"], b["cache"], f"{what}: final cache")


def check_decode_graph(cfg, B=2, prompt_len=16, gen=8, sample_interval=3,
                       seed=0):
    """serve() of ``cfg`` (weights drawn on the card from ``seed``) with
    CUDA-graph windows against the eager engine (``graph=False``) on the
    same weights, both under NoSyncInWindow: equal to the bit
    (``assert_serve_equal``), every window of the graph run a replay
    (captured before the run), and each run's launch counts as
    ``serve_kernels`` says. Returns both records (without the caches)."""
    from repro_torch.core.graphs import counted_kernels, launch_counts
    params = build_model(cfg).init(seed, device="cuda")
    runs = {}
    steps = gen - 1
    n_windows = -(-steps // sample_interval)
    for graph in (True, False):
        for fn in counted_kernels().values():
            fn.launches = 0
        timer = NoSyncInWindow()
        out = serve(cfg, B, prompt_len, gen, seed=seed,
                    sample_interval=sample_interval, device="cuda",
                    params=params, timer=timer, graph=graph,
                    return_cache=True)
        want = serve_kernels(cfg, steps)[1]
        got = {k: n for k, n in launch_counts().items() if n}
        assert got == {k: n for k, n in want.items() if n}, (graph, got,
                                                             want)
        assert timer.windows == n_windows
        engine = "graph" if graph else "eager"
        assert out["engine"] == engine
        assert out["windows_by_engine"][engine] == n_windows, out
        runs[engine] = out
    assert_serve_equal(runs["graph"], runs["eager"],
                       f"{cfg.name} graph vs eager")
    return {k: {n: v for n, v in r.items() if n != "cache"}
            for k, r in runs.items()}


def check_drain_before_replay(windows=6, interval=4, n=1024):
    """A graphed engine whose every window is slow (a chain of n x n
    products) and ends by pushing its own step indices into the shell's
    FIFO and ys, run by the overlapping WindowScheduler with each replay
    enqueued right after the last: every drained row and ys must be its
    own window's (the pinned copies are queued on the replay's stream,
    before the next replay overwrites the outputs)."""
    from repro_torch.core.graphs import WindowGraphs
    from repro_torch.core.pshell import (FifoSpec, ShellConfig, drain,
                                         fifo_push, shell_init)
    from repro_torch.core.schedule import WindowScheduler
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(n, n, generator=g, device=dev) / n ** 0.5

    def engine(state, shell, idx):
        x = state
        for i in range(idx.shape[0]):
            for _ in range(8):
                x = torch.tanh(x @ w)
            shell = fifo_push(shell, "f", idx[i].float().expand(3))
        state.copy_(x)
        return state, shell, idx.float() * 2
    cfg = ShellConfig(fifos={"f": FifoSpec(depth=interval, shape=(3,))},
                      sample_interval=interval)
    graphs = WindowGraphs(engine, warmup="clone")
    state = torch.randn(n, n, generator=g, device=dev)
    shell = shell_init(cfg, dev)
    graphs.prepare(state, shell, np.arange(interval))
    sched = WindowScheduler(interval=interval, overlap=True, drain_fn=drain)
    seen = []
    sched.run(graphs, sched.windows(range(windows * interval)), state, shell,
              on_drain=lambda plan, rec, ys: seen.append(
                  (plan, rec["fifos"]["f"]["data"][:, 0], ys.numpy())))
    assert graphs.windows == {"graph": windows, "eager": 0}
    for plan, rows, ys in seen:
        want = np.arange(plan.start, plan.boundary, dtype=np.float32)
        assert np.array_equal(rows, want), (plan, rows)
        assert np.array_equal(ys, want * 2), (plan, ys)
    return len(seen)


def train_run(cfg, rt, batches, sample_interval, *, seed=0, device="cuda",
              grouped=True, shell=True, commit_depth=None, opt_cfg=None,
              accum_steps=1, state=None):
    """Train ``cfg`` from ``state`` (default ``init_state(seed)`` on
    ``device``) on ``batches`` through the
    P-Shell: ``PShell.run`` (one dispatch a step) or ``run_grouped`` of
    ``make_group_step`` (one dispatch a window; on a card one CUDA-graph
    replay, after the first window of each length runs eagerly).
    ``shell=False`` runs the group step with ``ingest=None``. Returns the
    final state, the drained records ``[(i, records)]``, the group engine
    (None per step) and its windows, and the wall time (after a sync)."""
    import time

    from repro_torch.core.commit import default_shell_config, make_ingest
    from repro_torch.core.pshell import PShell
    from repro_torch.train import (OptConfig, init_state, make_group_step,
                                   make_train_step)
    opt_cfg = opt_cfg or OptConfig(warmup_steps=10)
    model = build_model(cfg, rt)
    if state is None:
        state = init_state(model, seed, device=device)
    ingest = make_ingest(cfg) if shell else None
    ps = PShell(default_shell_config(cfg, sample_interval, commit_depth),
                ingest)
    recs: list = []
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    if grouped:
        group_step = make_group_step(model, opt_cfg, ingest=ingest,
                                     accum_steps=accum_steps)
        state, _, _ = ps.run_grouped(group_step, state, batches,
                                     on_drain=lambda i, r: recs.append(
                                         (i, r)))
        engine = ps.compile_group(group_step, device=device)
        windows = dict(getattr(engine, "windows", {"graph": 0,
                                                   "eager": len(recs)}))
    else:
        step = make_train_step(model, opt_cfg, accum_steps=accum_steps)
        metrics: list = []

        def wrapped(state, batch, sh, _w=ps.wrap(step)):
            state, m, sh = _w(state, batch, sh)
            metrics.append(m)
            return state, m, sh

        def on_drain(i, r):
            got = [metrics.pop(0) for _ in range(len(metrics))]
            r["metrics"] = {k: torch.stack([m[k] for m in got]).cpu().numpy()
                            for k in got[0]}
            recs.append((i, r))
        state, _, _ = ps.run(wrapped, state, batches, on_drain=on_drain)
        engine, windows = None, {"graph": 0, "eager": 0}
    sync()
    return {"state": state, "records": recs, "windows": windows,
            "engine": engine, "seconds": time.perf_counter() - t0}


# card against host for one train window in f32: each step's loss and
# gradient norm within TRAIN_RTOL (relative); every parameter within
# TRAIN_LR_ATOL times the summed learning rates of the window, since a
# gradient element near zero can change sign between two devices, and an
# early Adam update is about lr * sign(g) (|update| < 1.5 in these steps)
TRAIN_RTOL = 1e-4
TRAIN_LR_ATOL = 3.0


def check_train_parity(cfg, steps=3, B=2, S=16, seed=0):
    """One ``make_group_step`` window of ``steps`` steps of ``cfg`` (an f32
    config) on the "xla" path, from the same state (drawn on the host from
    ``seed``) and batches, on the card (one window: run eagerly, the first
    of its length) and on the host. Gated at TRAIN_RTOL and TRAIN_LR_ATOL;
    returns the errors."""
    from repro_torch.train import OptConfig, init_state
    taps = TAPS | {"router"} if cfg.num_experts else TAPS
    rt = Runtime(attention_impl="xla", taps=taps)
    opt_cfg = OptConfig(warmup_steps=10)
    host = init_state(build_model(cfg, rt), seed, device="cpu")
    card = tree_map(lambda t: t.to("cuda"), host)
    batches = [make_batch_fn(cfg, B, S, seed)(i) for i in range(steps)]
    runs = {dev: train_run(cfg, rt, batches, steps, device=dev,
                           opt_cfg=opt_cfg, state=st)
            for dev, st in (("cuda", card), ("cpu", host))}
    ma = runs["cuda"]["records"][-1][1]["metrics"]
    mb = runs["cpu"]["records"][-1][1]["metrics"]

    def rel(a, b):
        return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-6)))

    lr_sum = float(mb["lr"].sum())
    pa = tree_leaves(runs["cuda"]["state"]["params"])
    pb = tree_leaves(runs["cpu"]["state"]["params"])
    param_err = max(float((a.cpu().double() - b.double()).abs().max())
                    for a, b in zip(pa, pb))
    out = {"loss_rel_err": rel(ma["loss"], mb["loss"]),
           "grad_norm_rel_err": rel(ma["grad_norm"], mb["grad_norm"]),
           "param_max_abs_err": param_err,
           "param_limit": TRAIN_LR_ATOL * lr_sum,
           "losses": ma["loss"].tolist()}
    case = f"train parity {cfg.name}: {out}"
    assert out["loss_rel_err"] <= TRAIN_RTOL, case
    assert out["grad_norm_rel_err"] <= TRAIN_RTOL, case
    assert param_err <= out["param_limit"], case
    assert np.array_equal(ma["lr"], mb["lr"]), case
    return out


# ------------------------------------------------- co-emulation, kernels --
def forward_step(model):
    """A forward-only co-emulation step ``(params, batch) -> (params,
    {"loss"}, aux)`` on ``model.loss``: the state is the params, returned
    as they came. On ``attention_impl="cuda"`` the forward launches the
    kernels, so ``CoEmulator`` verifies them through the API it verifies
    the train step with. The batch's arrays go to the params' device."""
    def step(params, batch):
        device = params["embed"]["tok"].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        with torch.no_grad():
            loss, (_, aux) = model.loss(params, batch)
        return params, {"loss": loss}, aux
    return step


# ---------------------------------------------------------------- ZP-Scope --
def serve_window_digests(tokens, interval: int) -> list:
    """``digest_tree`` of each decode window's ys as the decode engine
    emits them ((g, B, 1) int32), from ``serve()``'s token matrix (B, gen;
    column 0 comes from the prefill)."""
    toks = np.asarray(tokens, np.int32)
    steps = toks.shape[1] - 1
    return [digest_tree(np.ascontiguousarray(
        toks[:, 1 + s:1 + min(s + interval, steps)].T[:, :, None]))
        for s in range(0, steps, interval)]


def train_window_digests(step, state, batches, interval: int) -> dict:
    """The oracle's expected digests for ``CommitStreamVerifier``: window
    index -> ``digest_tree`` of the window's stacked metrics (the fused
    train engine's ys), ``step`` run over ``batches`` from ``state``
    (stepped in place)."""
    out = {}
    for w, start in enumerate(range(0, len(batches), interval)):
        ms = []
        for b in batches[start:start + interval]:
            state, m, _ = step(state, b)
            ms.append(m)
        out[w] = digest_tree({k: torch.stack([m[k] for m in ms])
                              for k in ms[0]})
    return out


def check_scope_digests(report, window_digests) -> int:
    """Every sample of a plane's report against the host twin's window
    digests: the cumulative digest, and each ring slot holding the window
    last written there. Returns the number of samples checked."""
    n = report["spec"]["every_n_windows"]
    cum, seen = 0, 0
    for s in report["history"]:
        while seen < s["windows"]:
            cum = ((cum * _FNV) + window_digests[seen]) & _M32
            seen += 1
        assert s["digest"] == cum, (s["seq"], s["digest"], cum)
        for w in range(max(0, s["windows"] - n), s["windows"]):
            assert s["win_digests"][w % n] == window_digests[w], (
                s["seq"], w, s["win_digests"], window_digests[w])
    assert seen == len(window_digests), (seen, len(window_digests))
    return len(report["history"])
