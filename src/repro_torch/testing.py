"""Checks of the port on the card, shared by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``: the kernels each path launches, a scheduler
timer that forbids host syncs inside a decode window, K1 to K5 held
against their plain versions, and the commit-tapped forward with its
Scale-Down replay on the card against the same on the host."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.commit import layer_checksums, nan_bits
from repro_torch.core.decompose import verify_extraction
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
from repro_torch.models.layers import embed_apply
from repro_torch.utils import tree_map

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
# K4 in f32, h_all and h_last: the tolerance of the reference's
# test_rglru_scan
LRU_TOL = 1e-5
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
    MoE FFN, K5 three times (the gate, up and down products)."""
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
    three times a MoE layer (the mamba and RG-LRU steps are plain)."""
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


def capture_graph(fn):
    """fn() recorded once in a CUDA graph on a side stream; returns the
    graph and fn's result, whose storage each replay writes anew."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return graph, out


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


def check_ssm_scan(B, S, Din, N, seed=0, strided=False):
    """K3 on random inputs drawn on the card from ``seed`` (the reference
    test's distributions: dt = softplus(normal), A = -exp(normal / 2),
    B_, C_ and x normal), against its plain version on the same inputs, y
    and h_last at SSM_TOL. ``strided``: B_ and C_ are views into one
    (B, S, 8 + 2N) tensor, as the model splits them off its projection.
    Raises AssertionError where they disagree; returns the max abs errors
    of y and of h_last."""
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
    x = rand(B, S, Din)
    before = ssm_ops.ssm_scan.launches
    y, h = ssm_ops.ssm_scan(dt, A, B_, C_, x)
    assert ssm_ops.ssm_scan.launches == before + 1
    yr, hr = ssm_scan_ref(dt, A, B_, C_, x)
    case = f"K3 vs plain, B={B} S={S} Din={Din} N={N} strided={strided}"
    for name, a, b in (("y", y, yr), ("h_last", h, hr)):
        assert a.dtype == torch.float32 and a.shape == b.shape, case
        torch.testing.assert_close(a, b, rtol=SSM_TOL, atol=SSM_TOL,
                                   msg=lambda m: f"{case} {name}: {m}")
    return (float((y - yr).abs().max()), float((h - hr).abs().max()))


def check_rglru_scan(B, S, W, seed=0, split=None):
    """K4 on random inputs drawn on the card from ``seed`` (the reference
    test's distributions: a = sigmoid(normal), b and h0 normal), against
    its plain version on the same inputs, h_all and h_last at LRU_TOL.
    ``split`` = s1 also checks the chaining property: the first s1 steps,
    then the rest from their h_last, equal one pass. Raises AssertionError
    where they disagree; returns the max abs errors of h_all and h_last."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    a = torch.sigmoid(rand(B, S, W))
    b = rand(B, S, W)
    h0 = rand(B, W)
    before = lru_ops.rglru_scan.launches
    h, h_last = lru_ops.rglru_scan(a, b, h0)
    assert lru_ops.rglru_scan.launches == before + 1
    hr, hr_last = rglru_scan_ref(a, b, h0)
    case = f"K4 vs plain, B={B} S={S} W={W}"
    pairs = [("h_all", h, hr), ("h_last", h_last, hr_last)]
    if split is not None:
        h1, h1_last = lru_ops.rglru_scan(a[:, :split].contiguous(),
                                         b[:, :split].contiguous(), h0)
        h2, h2_last = lru_ops.rglru_scan(a[:, split:].contiguous(),
                                         b[:, split:].contiguous(), h1_last)
        case += f" split at {split}"
        pairs += [("chained h_all", torch.cat([h1, h2], dim=1), h),
                  ("chained h_last", h2_last, h_last)]
    for name, x, y in pairs:
        assert x.dtype == torch.float32 and x.shape == y.shape, case
        torch.testing.assert_close(x, y, rtol=LRU_TOL, atol=LRU_TOL,
                                   msg=lambda m: f"{case} {name}: {m}")
    return (float((h - hr).abs().max()), float((h_last - hr_last).abs().max()))


def check_grouped_gemm(E, M, K, N, dtype, seed=0):
    """K5 on random inputs drawn on the card from ``seed`` (x normal, w
    normal at the model's K ** -0.5 scale), against its plain version on
    the same inputs. Raises AssertionError where they disagree; returns
    (max abs error, normwise relative error)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(E, M, K, generator=g, device=dev).to(dtype)
    w = (torch.randn(E, K, N, generator=g, device=dev) * K ** -0.5) \
        .to(dtype)
    before = gg_ops.grouped_gemm.launches
    out = gg_ops.grouped_gemm(x, w)
    assert gg_ops.grouped_gemm.launches == before + 1
    case = f"K5 vs plain, E={E} M={M} K={K} N={N} {dtype}"
    return _compare(out, grouped_gemm_ref(x, w), dtype, case,
                    GG_BF16_NORM_REL)


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
            x = embed_apply(params["embed"], b["tokens"])
            pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
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
