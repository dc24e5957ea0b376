"""Host-side pieces of the port's kernels that the CPU can check.

- ``refuse_grad``: a CUDA kernel's result carries no autograd history,
  so each wrapper's CUDA branch refuses grad mode with an input that
  requires grad; the host branch (the plain version) still differentiates.
- K2's split plan (``decode_attention.ops.split_plan``): the chunks cover
  the ring exactly, are multiples of the tile, depend only on host ints,
  fit one thread-block cluster (at most 16 splits) and fill the card as
  far as that allows at the serve shapes.
- A plain-torch model of K2's split-and-combine arithmetic (per split an
  online softmax over 32-slot tiles with the weights rounded to v's dtype,
  then the merge of the live splits in split-index order), held against
  ``decode_attention_ref`` at the tolerances of tests/test_kernels.py
  (f32 2e-5, bf16 2e-2) and K2's bf16 normwise limit (6e-3), so a rounding
  or empty-split error shows here before it costs card time.
- K5's persistent tiling (``grouped_gemm.ops.wgmma_plan``, the tile
  counts and grid the "wgmma" kernel walks): the tiles cover every
  output element once at qwen3's capacities and ragged shapes for
  several SM counts; and the shape dispatch (``choose_path``,
  ``can_take``) by dtype and the TMA alignment rule, at the decode's few
  rows an expert and the forward's hundreds.
- A plain-torch model of K3's lane groups (N / G states a lane, the
  lanes' partial sums of y added in a fixed tree) at both lane groups the
  kernel has (one lane a channel, four states a lane), in f32 and f64, against ``ssm_scan_ref`` and the JAX
  package's scan in interpret mode at SSM_TOL (1e-4); and the host's
  choice of the group (``ssm_scan.ops.lane_group``, ``plan``).
- K4's two paths: the host predicate (``rglru_scan.ops.choose_path``:
  "tma" where TMA maps a and b and the grid is thin, "registers"
  elsewhere), its plan (the blocks cover every (batch row, channel) once,
  host ints only, the ring the constants of ``csrc/rglru_scan.cu``), and
  a plain-torch model of the "tma" kernel's staged walk (the plan's boxes
  and stages, zero-filled past S and W, stores clipped there, h_last at
  step S - 1, the ring's mbarrier phases) held against
  ``rglru_scan_ref`` to the bit and against the JAX package's kernel in
  interpret mode.
"""
import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import refuse_grad  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as gg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref  # noqa: E402
from repro_torch.testing import BF16_NORM_REL, SSM_TOL, TOL  # noqa: E402

NEG_INF = -1e30
# (B*K, W) of the serve shapes: glm4-9b (B 8, K 2, W 2120),
# recurrentgemma-2b (B 8, K 1, W 2048), qwen3-moe-30b-a3b (B 8, K 4, W 2120)
SERVE_SHAPES = [(16, 2120), (8, 2048), (32, 2120)]
H100_SMS = 132                     # streaming multiprocessors of an H100 SXM


# --------------------------------------------------------- refuse_grad ----
def test_refuse_grad_raises_under_grad_mode_naming_the_kernel():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="k9: the CUDA kernel has no "
                                           "backward"):
        refuse_grad("k9", torch.ones(2), x)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "no_input_requires_grad"])
def test_refuse_grad_is_silent_where_no_gradient_is_taken(mode):
    x = torch.ones(3, requires_grad=mode != "no_input_requires_grad")
    if mode == "no_grad":
        with torch.no_grad():
            refuse_grad("k", x)
    elif mode == "inference_mode":
        with torch.inference_mode():
            refuse_grad("k", x)
    else:
        refuse_grad("k", x, None, 3)


def _wrapper_inputs(name, rng):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_()
    if name == "flash_attention":
        return (lambda q, k, v: fa_ops.flash_attention(q, k, v),
                (t(1, 8, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)))
    if name == "decode_attention":
        pos = torch.tensor(5, dtype=torch.int32)
        return (lambda q, k, v: da_ops.decode_attention(q, k, v, pos=pos,
                                                        window=8),
                (t(1, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)))
    if name == "ssm_scan":
        return (lambda dt, A, B_, C_, x: ssm_ops.ssm_scan(dt, A, B_, C_,
                                                           x)[0],
                (t(1, 5, 6), t(6, 4), t(1, 5, 4), t(1, 5, 4), t(1, 5, 6)))
    if name == "rglru_scan":
        return (lambda a, b, h0: lru_ops.rglru_scan(a, b, h0)[0],
                (t(1, 5, 6), t(1, 5, 6), t(1, 6)))
    return (lambda x, w: gg_ops.grouped_gemm(x, w), (t(2, 3, 4), t(2, 4, 5)))


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssm_scan", "rglru_scan", "grouped_gemm"])
def test_host_branch_still_differentiates(name):
    """On host tensors each wrapper runs its plain version, whose result
    has a gradient for every input that requires one."""
    fn, args = _wrapper_inputs(name, np.random.default_rng(0))
    out = fn(*args)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.float().square().sum(), args)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------- split plan ----
def _chunks(W, chunk, n_split):
    return [(s * chunk, min((s + 1) * chunk, W)) for s in range(n_split)]


@pytest.mark.parametrize("bk,W", SERVE_SHAPES + [
    (1, 1), (1, 31), (1, 2120), (1, 65536), (3, 100), (64, 77), (256, 4096),
    (2, 1_000_000)])
def test_split_plan_covers_the_ring_exactly_in_tile_multiples(bk, W):
    chunk, n_split = da_ops.split_plan(bk, W, H100_SMS)
    assert chunk % da_ops.TILE == 0 and chunk >= da_ops.TILE
    assert 1 <= n_split <= da_ops.MAX_SPLIT
    spans = _chunks(W, chunk, n_split)
    assert spans[0][0] == 0 and spans[-1][1] == W
    assert all(a < b for a, b in spans)                 # none empty
    assert all(spans[i][1] == spans[i + 1][0] for i in range(n_split - 1))


def test_split_plan_depends_on_host_ints_only():
    """B*K, W and the card's SM count, nothing else: ``pos`` (a device
    tensor) plays no part, so one cache always launches the same grid and
    a graph can hold it."""
    assert list(inspect.signature(da_ops.split_plan).parameters) == [
        "bk", "W", "sms"]
    assert all(da_ops.split_plan(16, 2120, H100_SMS)
               == da_ops.split_plan(16, 2120, H100_SMS) for _ in range(3))


@pytest.mark.parametrize("sms", [78, 114, 132, 144])
@pytest.mark.parametrize("bk,W", SERVE_SHAPES)
def test_split_plan_follows_the_sm_count(bk, W, sms):
    """The plan aims at the card it is given: between one wave less a
    pair's splits and two waves, as far as a cluster allows."""
    chunk, n_split = da_ops.split_plan(bk, W, sms)
    assert bk * n_split >= min(sms, bk * da_ops.MAX_SPLIT) - bk
    assert bk * n_split <= 2 * sms


@pytest.mark.parametrize("bk,W,blocks", [(16, 2120, 192), (8, 2048, 128),
                                         (32, 2120, 192), (64, 2120, 192),
                                         (1, 65536, 16), (1, 2 ** 20, 16)])
def test_split_plan_fills_the_card_as_far_as_a_cluster_allows(bk, W,
                                                              blocks):
    """About one and a half blocks an SM, every split of a pair in one
    cluster: 192 blocks at glm4-9b's and qwen3's serve shapes (16 x 12,
    32 x 6), 128 at recurrentgemma-2b's (8 x 16, the cluster's limit); a
    single pair takes 16 SMs."""
    chunk, n_split = da_ops.split_plan(bk, W, H100_SMS)
    assert bk * n_split == blocks
    assert n_split <= da_ops.MAX_SPLIT
    assert bk * n_split >= min(H100_SMS, bk * da_ops.MAX_SPLIT) - bk
    assert bk * n_split <= 2 * H100_SMS


def test_split_plan_at_one_pair_and_a_short_ring_takes_every_tile():
    """At B*K = 1 a ring of fewer than MAX_SPLIT tiles takes one tile a
    block."""
    chunk, n_split = da_ops.split_plan(1, 300, H100_SMS)
    assert chunk == da_ops.TILE and n_split == -(-300 // da_ops.TILE)


# -------------------------------------- the split-and-combine arithmetic ----
def split_combine_model(q, k, v, pos, window, softcap=0.0):
    """K2's arithmetic in plain torch: the wrapper's plan, per split an
    online softmax over TILE-slot tiles (scores in f32, the weights
    rounded to v's dtype before PV, PV in f32), then the live splits
    merged in split-index order with the normaliser clamped at 1e-30."""
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    G = H // K
    chunk, n_split = da_ops.split_plan(B * K, W, H100_SMS)
    ring_full = pos + 1 >= window
    end = W if ring_full else min(W, pos + 1)
    qf = q.reshape(B, K, G, hd).float()
    parts = []
    for s in range(n_split):
        lo, hi = s * chunk, min((s + 1) * chunk, end)
        if lo >= hi:
            continue           # no partial: the combine skips the split
        m = torch.full((B, K, G), NEG_INF)
        l = torch.zeros(B, K, G)
        acc = torch.zeros(B, K, G, hd)
        for t0 in range(lo, hi, da_ops.TILE):
            t1 = min(t0 + da_ops.TILE, hi)
            kt = k[:, t0:t1].float()                       # (B, n, K, hd)
            x = torch.einsum("bkgh,btkh->bkgt", qf, kt) * hd ** -0.5
            if softcap > 0:
                x = torch.tanh(x / softcap) * softcap
            slots = torch.arange(t0, t1)
            x = torch.where((slots <= pos) | ring_full, x, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp(x - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgt,btkh->bkgh", p.to(v.dtype).float(),
                              v[:, t0:t1].float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        parts.append((m, l, acc))
    n_live = -(-end // chunk)
    assert len(parts) == n_live
    M = torch.stack([p[0] for p in parts]).amax(0)
    num = torch.zeros(B, K, G, hd)
    den = torch.zeros(B, K, G)
    for m, l, acc in parts:
        w = torch.exp(m - M)
        num = num + w[..., None] * acc
        den = den + w * l
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def _decode_inputs(B, H, K, W, hd, dtype, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(dtype)
    return t(B, H, hd, s=scale), t(B, W, K, hd, s=scale), t(B, W, K, hd)


def _hold(out, ref, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        diff = (out.float() - ref.float()).norm() / ref.float().norm()
        assert float(diff) <= BF16_NORM_REL


# B*K = 4 at W = 300: ten 32-slot splits, the last 12 slots long
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 5, 31, 32, 63, 64, 150, 298, 299, 350,
                                 1000],
                         ids=lambda p: f"pos{p}")
def test_split_combine_model_matches_plain_around_chunk_edges(pos, dtype):
    """pos in the first chunk, on chunk edges (31/32, 63/64), mid-ring,
    the ring just full (299 = W - 1) and wrapped (350, 1000); W = 300 is
    not a multiple of the chunk."""
    B, H, K, W, hd = 2, 6, 2, 300, 32
    assert da_ops.split_plan(B * K, W, H100_SMS) == (32, 10)
    q, k, v = _decode_inputs(B, H, K, W, hd, dtype, seed=pos)
    p = torch.tensor(pos, dtype=torch.int32)
    _hold(split_combine_model(q, k, v, pos, W),
          decode_attention_ref(q, k, v, pos=p, window=W), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["glm4-9b", "recurrentgemma-2b",
                                  "qwen3-moe-30b-a3b", "softcap30",
                                  "one-pair"])
def test_split_combine_model_matches_plain_at_serve_plans(case, dtype):
    """The serve shapes and their plans (chunks of 192, 128 and 384 slots;
    W = 2120 is not a multiple of 192 or 384; the recurrentgemma ring
    wrapped); a softcap of 30 on scores scaled by 3; and B*K = 1, one
    tile a split."""
    B, H, K, W, hd, pos, sc, scale, plan = {
        "glm4-9b": (8, 32, 2, 2120, 128, 2100, 0.0, 1.0, (192, 12)),
        "recurrentgemma-2b": (8, 10, 1, 2048, 256, 2110, 0.0, 1.0, (128, 16)),
        "qwen3-moe-30b-a3b": (8, 32, 4, 2120, 128, 1000, 0.0, 1.0, (384, 6)),
        "softcap30": (2, 16, 2, 700, 64, 400, 30.0, 3.0, (64, 11)),
        "one-pair": (1, 8, 1, 500, 32, 470, 0.0, 1.0, (32, 16))}[case]
    assert da_ops.split_plan(B * K, W, H100_SMS) == plan
    q, k, v = _decode_inputs(B, H, K, W, hd, dtype, seed=7, scale=scale)
    p = torch.tensor(pos, dtype=torch.int32)
    _hold(split_combine_model(q, k, v, pos, W, softcap=sc),
          decode_attention_ref(q, k, v, pos=p, window=W, softcap=sc), dtype)


# ---------------------------------------- K5: the persistent tiling ----
QWEN3_PRODUCTS = [(640, 2048, 768), (640, 768, 2048), (1280, 2048, 768),
                  (1280, 768, 2048), (8, 2048, 768), (8, 768, 2048)]


@pytest.mark.parametrize("sms", [1, 7, 114, 132, 144])
@pytest.mark.parametrize("E,M,N", [(128, M, N) for M, _, N in QWEN3_PRODUCTS]
                         + [(3, 129, 136), (1, 1, 8), (5, 300, 1000),
                            (2, 65, 2048)])
def test_wgmma_plan_tiles_cover_the_output_once(E, M, N, sms):
    """The 128 x 256 tiles of the plan cover each expert's (M, N) with no
    tile wholly past its edge, so every output element lies in exactly
    one (expert, m-tile, n-tile), at qwen3's three capacities (both
    products) and ragged shapes; the grid is one block an SM, at most one
    a tile, so no block is idle."""
    tm, tn, grid = gg_ops.wgmma_plan(E, M, N, sms)
    bm, bn = gg_ops.WG_TILE
    assert (tm - 1) * bm < M <= tm * bm
    assert (tn - 1) * bn < N <= tn * bn
    assert grid == min(sms, E * tm * tn) >= 1


def test_wgmma_plan_depends_on_host_ints_only():
    """Shapes and the SM count, nothing read from the card: the grid is
    fixed for a shape, so a graph can hold the launch. At qwen3's forward
    gate/up (128 experts of 640 x 768): 5 x 3 tiles an expert, 1,920 in
    all, one block on each of an H100's 132 SMs; at the decode's 8 rows
    one m-tile an expert."""
    assert list(inspect.signature(gg_ops.wgmma_plan).parameters) == [
        "E", "M", "N", "sms"]
    assert gg_ops.wgmma_plan(128, 640, 768, H100_SMS) == (5, 3, 132)
    assert gg_ops.wgmma_plan(128, 8, 2048, H100_SMS) == (1, 8, 132)
    assert gg_ops.wgmma_plan(1, 8, 768, H100_SMS) == (1, 3, 3)


# ------------------------------------------------ K5: the shape dispatch ----
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,M,K,N,xp,wp,want", [
    (BF16, 8, 2048, 768, 0, 0, "wgmma"),          # qwen3's decode
    (BF16, 8, 768, 2048, 0, 0, "wgmma"),
    (BF16, 1, 2048, 768, 0, 0, "wgmma"),
    (BF16, 16, 2048, 768, 0, 0, "wgmma"),
    (BF16, 129, 2048, 768, 0, 0, "wgmma"),        # off the 128-row tile
    (BF16, 640, 2048, 768, 0, 0, "wgmma"),        # the forward
    (BF16, 1280, 768, 2048, 0, 0, "wgmma"),       # the prefill
    (BF16, 640, 2047, 768, 0, 0, "mma"),          # K off 8
    (BF16, 8, 2048, 767, 0, 0, "mma"),            # N off 8
    (BF16, 640, 2048, 768, 2, 0, "mma"),          # x's base off 16 bytes
    (BF16, 8, 2048, 768, 0, 8, "mma"),            # w's base off 16 bytes
    (BF16, 640, 2048, 768, 32, 48, "wgmma"),      # 16-byte aligned bases
    (F32, 8, 2048, 768, 0, 0, "fma"),
    (F32, 640, 2048, 768, 0, 0, "fma"),
    (F32, 640, 2047, 767, 4, 4, "fma")])
def test_choose_path_by_dtype_and_alignment(dtype, M, K, N, xp, wp, want):
    assert gg_ops.choose_path(dtype, M, K, N, xp, wp) == want
    assert gg_ops.can_take(want, dtype, M, K, N, xp, wp)


@pytest.mark.parametrize("path,dtype,M,K,N,xp,ok", [
    ("wgmma", BF16, 1, 64, 64, 0, True),          # wgmma takes any M
    ("wgmma", BF16, 8, 64, 64, 0, True),
    ("wgmma", BF16, 65, 64, 64, 0, True),
    ("wgmma", BF16, 640, 60, 64, 0, False),       # K off 8
    ("wgmma", BF16, 8, 64, 64, 2, False),         # misaligned base
    ("wgmma", F32, 8, 64, 64, 0, False),
    ("mma", BF16, 640, 60, 61, 2, True),          # mma takes any bf16
    ("mma", F32, 640, 64, 64, 0, False),
    ("fma", BF16, 640, 64, 64, 0, False),
    ("fma", F32, 7, 3, 5, 4, True),
    ("tf32", F32, 7, 3, 5, 4, False)])
def test_can_take_says_which_paths_take_the_operands(path, dtype, M, K, N,
                                                     xp, ok):
    assert gg_ops.can_take(path, dtype, M, K, N, xp, xp) is ok


def test_choose_path_depends_on_host_ints_only():
    assert list(inspect.signature(gg_ops.choose_path).parameters) == [
        "dtype", "M", "K", "N", "x_ptr", "w_ptr"]


# ------------------------------------- K3: the lane-group decomposition ----
def lane_group_model(dt, A, B_, C_, x, G):
    """K3's arithmetic in plain torch with G lanes a channel: lane s holds
    states L s .. L s + L - 1 (L = N / G); per step every state as the
    plain scan updates it, each lane's partial y summed over its L states
    in n order, then the G partial sums added in a fixed tree (pairs 1
    apart, then 2 apart: (p0 + p1) + (p2 + p3)), which is y_t."""
    Bsz, S, Din = dt.shape
    N = A.shape[1]
    L = N // G
    lanes = torch.arange(G)
    h = torch.zeros(Bsz, Din, N, dtype=dt.dtype)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + (dt[:, t] * x[:, t])[..., None] * B_[:, t, None, :]
        part = (h * C_[:, t, None, :]).reshape(Bsz, Din, G, L)
        acc = part[..., 0]
        for j in range(1, L):
            acc = acc + part[..., j]
        o = 1
        while o < G:
            acc = acc + acc[..., lanes ^ o]     # p_s += p_(s ^ o), every s
            o <<= 1
        ys.append(acc[..., 0])
    return torch.stack(ys, dim=1), h


def _ssm_inputs(B, S, Din, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, Din))))
    A = -np.exp(0.5 * rng.standard_normal((Din, N)))
    return [torch.from_numpy(a.astype(dtype)) for a in (
        dt, A, rng.standard_normal((B, S, N)),
        rng.standard_normal((B, S, N)), rng.standard_normal((B, S, Din)))]


def _with_groups(shapes):
    """Each (B, S, Din, N) once for every lane group the kernel has at N."""
    return [(*shape, G) for shape in shapes
            for G in ssm_ops.lane_groups(shape[3])]


SSM_SHAPES = [(2, 1, 5, 4), (1, 17, 33, 8), (2, 33, 70, 16), (1, 16, 64, 16),
              (2, 40, 9, 4), (1, 50, 130, 8)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B,S,Din,N,G", _with_groups(SSM_SHAPES))
def test_lane_group_model_matches_plain(B, S, Din, N, G, dtype):
    """S = 1, S off the 16-step chunk and on it, N = 4, 8, 16 at each of
    their lane groups (1 lane; 1 or 2; 1 or 4), Din off the 64-, 128-
    and 256-channel blocks; y and h_last within SSM_TOL of
    ``ssm_scan_ref`` in f32 and in f64."""
    args = _ssm_inputs(B, S, Din, N, dtype, seed=S)
    y, h = lane_group_model(*args, G)
    yr, hr = ssm_scan_ref(*args)
    torch.testing.assert_close(y, yr.to(y.dtype), rtol=SSM_TOL,
                               atol=SSM_TOL)
    torch.testing.assert_close(h, hr.to(h.dtype), rtol=SSM_TOL,
                               atol=SSM_TOL)


@pytest.mark.parametrize("B,S,Din,N,G", _with_groups(
    [(2, 1, 16, 4), (1, 17, 32, 8), (2, 33, 48, 16)]))
def test_lane_group_model_matches_the_reference_kernel(B, S, Din, N, G):
    """The model at each lane group against the JAX package's selective
    scan run in interpret mode (as tests/test_torch_ssm.py runs it), f32
    at SSM_TOL."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssm_scan import ops as jssm_ops
    args = _ssm_inputs(B, S, Din, N, np.float32, seed=7)
    y, h = lane_group_model(*args, G)
    jy, jh = jssm_ops.ssm_scan(*(jnp.asarray(a.numpy()) for a in args),
                               block_d=16, chunk=16, interpret=True)
    torch.testing.assert_close(y, torch.from_numpy(np.array(jy)),
                               rtol=SSM_TOL, atol=SSM_TOL)
    torch.testing.assert_close(h, torch.from_numpy(np.array(jh)),
                               rtol=SSM_TOL, atol=SSM_TOL)


@pytest.mark.parametrize("N,groups", [(4, (1,)), (8, (1, 2)),
                                      (16, (1, 4))])
def test_ssm_lane_groups_are_one_lane_or_four_states_a_lane(N, groups):
    assert ssm_ops.lane_groups(N) == groups
    with pytest.raises(ValueError, match="state size"):
        ssm_ops.lane_groups(N + 1)


@pytest.mark.parametrize("B,Din,N,sms,group", [
    (2, 8192, 16, H100_SMS, 4),    # falcon-mamba-7b's forward: 2,048 warps
    (8, 8192, 16, H100_SMS, 1),    # its serve prefill: 2,048 at one lane
    (4, 8192, 16, H100_SMS, 4),
    (2, 8192, 8, H100_SMS, 2),     # four states a lane at N = 8
    (2, 8192, 4, H100_SMS, 1),
    (1, 100, 16, H100_SMS, 4),     # too few channels
    (1, 384, 16, 1, 1),            # 12 warps on the one SM at one lane
    (1, 383, 16, 1, 4),
    (1, 383, 8, 1, 2)])
def test_ssm_lane_group_is_one_lane_where_that_fills_the_card(B, Din, N,
                                                             sms, group):
    """The host takes one lane a channel where B * Din threads put
    WARPS_PER_SM (12) warps on each SM, else four states a lane: four
    lanes a channel at the forward's B = 2, one at the prefill's B = 8."""
    assert ssm_ops.WARPS_PER_SM == 12
    assert ssm_ops.lane_group(B, Din, N, sms) == group
    assert ssm_ops.plan(B, Din, N, sms)["group"] == group


@pytest.mark.parametrize("N,group", [(4, 1), (8, 1), (8, 2), (16, 1),
                                     (16, 4)])
def test_ssm_plan_gives_the_launch_of_each_group(N, group):
    """256 threads a block at every group: 256 / G channels a block, N / G
    states a lane; the warps on the card grow with the group."""
    p = ssm_ops.plan(2, 8192, N, H100_SMS, group)
    assert (p["group"], p["states_per_lane"]) == (group, N // group)
    assert p["threads_per_block"] == 256
    assert p["channels_per_block"] == 256 // group
    assert p["blocks"] == 2 * 8192 * group // 256
    assert p["warps"] == 2 * 8192 * group // 32
    assert ssm_ops.plan(1, 100, N, H100_SMS, group)["blocks"] == \
        -(-100 // (256 // group))     # Din off the block


def test_ssm_plan_refuses_a_group_the_kernel_lacks():
    with pytest.raises(ValueError, match="no lane group of 4 at N=8"):
        ssm_ops.plan(2, 64, 8, H100_SMS, 4)
    assert list(inspect.signature(ssm_ops.lane_group).parameters) == [
        "B", "Din", "N", "sms"]


# ------------------------------------------ K4: the paths and the ring ----
# recurrentgemma-2b's forward and serve prefill, ragged shapes
LRU_SHAPES = [(2, 4096, 2560), (8, 2048, 2560), (2, 4000, 2600),
              (8, 2000, 2600), (3, 9, 33), (2, 65, 40), (1, 1, 5)]


@pytest.mark.parametrize("path", lru_ops.PATHS)
@pytest.mark.parametrize("B,S,W", LRU_SHAPES)
def test_rglru_plan_blocks_cover_every_channel_once(B, S, W, path):
    """Block (x, y) of the grid takes batch row y and channels 32 x to
    32 x + 31 below W: every (row, channel) in exactly one block, no
    block wholly past W."""
    p = lru_ops.plan(B, S, W, H100_SMS, path)
    gx, gy = p["grid"]
    C = p["channels_per_block"]
    assert gy == B and p["blocks"] == gx * gy and (gx - 1) * C < W
    seen = torch.zeros(B, W, dtype=torch.int64)
    for y in range(gy):
        for x in range(gx):
            seen[y, x * C:min((x + 1) * C, W)] += 1
    assert bool((seen == 1).all())


def test_rglru_plan_takes_the_kernels_ring():
    """The plan's ring is the one the kernel is built with (kSteps,
    kStages in csrc/rglru_scan.cu), whatever the shape: the producer
    issues only the stages S has."""
    src = (Path(lru_ops.__file__).parents[2] / "csrc"
           / "rglru_scan.cu").read_text()
    assert f"constexpr int kSteps = {lru_ops.STEPS};" in src
    assert f"constexpr int kStages = {lru_ops.STAGES};" in src
    assert f"constexpr int kC = {lru_ops.CHANNELS};" in src
    for B, S, W in LRU_SHAPES:
        p = lru_ops.plan(B, S, W, H100_SMS, "tma")
        assert (p["steps_per_stage"], p["stages"]) == (32, 5)


@pytest.mark.parametrize("B,S,W,want", [
    (2, 4096, 2560, "tma"),        # the forward: 160 blocks, one wave
    (2, 4000, 2600, "tma"),        # 164 blocks
    (8, 1024, 1056, "tma"),        # 264 blocks: two an SM
    (8, 2048, 2560, "registers"),  # the prefill: 640 blocks
    (8, 2000, 2600, "registers"),  # 656 blocks
    (2, 65, 40, "tma"), (1, 1, 8, "tma"),
    (3, 9, 33, "registers"), (1, 1, 5, "registers")])
def test_rglru_plan_takes_tma_where_the_grid_is_thin(B, S, W, want):
    """"tma" where TMA maps the shape and the grid holds at most two
    blocks an SM; above it the register kernel's loads keep the card
    busy."""
    p = lru_ops.plan(B, S, W, H100_SMS)
    assert p["path"] == want
    assert lru_ops.choose_path(B, W, 0, 0, H100_SMS) == want
    assert (p["blocks"] <= lru_ops.TMA_BLOCKS_PER_SM * H100_SMS
            or want == "registers")


def test_rglru_plan_depends_on_host_ints_only():
    """Shapes and the SM count: the grid and ring are fixed for a shape,
    so a graph can hold the launch."""
    assert list(inspect.signature(lru_ops.plan).parameters)[:4] == [
        "B", "S", "W", "sms"]
    for path in (None, *lru_ops.PATHS):
        assert all(lru_ops.plan(2, 4096, 2560, H100_SMS, path)
                   == lru_ops.plan(2, 4096, 2560, H100_SMS, path)
                   for _ in range(3))
    assert list(inspect.signature(lru_ops.choose_path).parameters) == [
        "B", "W", "a_ptr", "b_ptr", "sms"]


def test_rglru_plan_refuses_what_the_kernel_lacks():
    with pytest.raises(ValueError, match="no path"):
        lru_ops.plan(2, 64, 32, H100_SMS, "chunked")


@pytest.mark.parametrize("W,a_ptr,b_ptr,want", [
    (2560, 0, 0, "tma"), (2600, 256, 512, "tma"), (40, 16, 48, "tma"),
    (5, 0, 0, "registers"), (33, 0, 0, "registers"),
    (2562, 0, 0, "registers"),             # a row of 10,248 bytes
    (2560, 4, 0, "registers"),             # a 4 bytes past 16
    (2560, 0, 4, "registers"), (2560, 8, 8, "registers")])
def test_rglru_choose_path_by_width_and_alignment(W, a_ptr, b_ptr, want):
    """At the forward's two batch rows, the width and the bases alone
    decide."""
    assert lru_ops.choose_path(2, W, a_ptr, b_ptr, H100_SMS) == want
    assert lru_ops.tma_maps(W, a_ptr, b_ptr) is (want == "tma")


def staged_walk_model(a, b, h0, p):
    """The "tma" kernel's walk in plain torch, every block at once: a and
    b cut into the plan's boxes (T steps x 32 channels, zeros past S and
    W, as TMA fills them), each stage walked in time order with a
    product and then a sum, h kept from step S - 1 (the kernel updates h
    only for the stage's first n = min(T, S - t0) steps), each output box
    stored with its rows past S and columns past W clipped. Returns
    h_all, h_last and how often each element of h_all was written."""
    Bsz, S, W = a.shape
    C, T = p["channels_per_block"], p["steps_per_stage"]
    gx, gy = p["grid"]
    n_stages = -(-S // T)
    boxes = []
    for t in (a, b):
        z = torch.zeros(gy, n_stages * T, gx * C, dtype=t.dtype)
        z[:, :S, :W] = t
        boxes.append(z)
    h = torch.zeros(gy, gx * C, dtype=a.dtype)
    h[:, :W] = h0
    h_all = torch.full((Bsz, S, W), float("nan"), dtype=a.dtype)
    written = torch.zeros(Bsz, S, W, dtype=torch.int64)
    for it in range(n_stages):
        t0 = it * T
        n = min(T, S - t0)
        out = torch.empty(gy, T, gx * C, dtype=a.dtype)
        for i in range(T):
            if i < n:
                h = boxes[0][:, t0 + i] * h + boxes[1][:, t0 + i]
            out[:, i] = h
        for x in range(gx):           # one TMA store a block, clipped
            cols = slice(x * C, min((x + 1) * C, W))
            h_all[:, t0:t0 + n, cols] = out[:, :n, cols]
            written[:, t0:t0 + n, cols] += 1
    return h_all, h[:, :W].clone(), written


def _lru_inputs(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    return [torch.from_numpy(x.astype(np.float32)) for x in (
        a, rng.standard_normal((B, S, W)), rng.standard_normal((B, W)))]


@pytest.mark.parametrize("B,S,W", [(2, 4000, 2600), (3, 9, 33),
                                   (2, 65, 40), (2, 32, 40), (1, 1, 8)])
def test_rglru_staged_walk_matches_plain_to_the_bit(B, S, W):
    """The staged walk equals ``rglru_scan_ref`` to the bit: S off the
    stage (or one stage exactly, or a single step), W off the block, every
    element of h_all written once, h_last from step S - 1 (never from a
    zero-filled step past it)."""
    args = _lru_inputs(B, S, W, seed=S)
    p = lru_ops.plan(B, S, W, H100_SMS, "tma")
    h, h_last, written = staged_walk_model(*args, p)
    hr, hr_last = rglru_scan_ref(*args)
    assert bool((written == 1).all())
    assert torch.equal(h, hr) and torch.equal(h_last, hr_last)


def test_rglru_staged_walk_matches_the_reference_kernel():
    """The staged walk against the JAX package's RG-LRU kernel run in
    interpret mode (as tests/test_torch_rglru.py runs it), at the
    reference's f32 tolerance of 1e-5."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.rglru_scan import ops as jlru_ops
    args = _lru_inputs(2, 65, 40, seed=3)
    h, h_last, _ = staged_walk_model(
        *args, lru_ops.plan(2, 65, 40, H100_SMS, "tma"))
    jh, jh_last = jlru_ops.rglru_scan(*(jnp.asarray(x.numpy())
                                        for x in args),
                                      block_w=8, chunk=13, interpret=True)
    for got, want in ((h, jh), (h_last, jh_last)):
        torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                                   rtol=1e-5, atol=1e-5)


def ring_model(n_stages, stages):
    """The "tma" kernel's ring as the producer and the consumer drive its
    mbarriers: stage it goes to slot it % stages; the producer waits on
    the slot's empty barrier for parity (it / stages - 1) & 1 before a
    reuse, the consumer on its full barrier for parity (it / stages) & 1.
    A wait for parity p names one phase unambiguously only where the
    barrier has completed exactly that phase and no later one, which the
    model asserts at every wait. Runs the producer as far ahead as the
    ring lets it; returns the (stage, slot) pairs the consumer reads, in
    order."""
    full = [0] * stages        # completed phases of each barrier
    empty = [0] * stages
    loaded = {}                # slot -> stage its box holds
    read, issued = [], 0
    for it in range(n_stages):
        while issued < n_stages:
            s = issued % stages
            if issued >= stages:
                k = issued // stages - 1
                if empty[s] <= k:                  # release k not yet done
                    break
                assert empty[s] == k + 1
            loaded[s] = issued
            full[s] += 1
            issued += 1
        s = it % stages
        assert full[s] == it // stages + 1
        read.append((loaded[s], s))
        empty[s] += 1                              # the consumer's release
    return read


@pytest.mark.parametrize("n_stages,stages", [
    (1, lru_ops.STAGES), (3, lru_ops.STAGES), (5, lru_ops.STAGES),
    (64, lru_ops.STAGES), (128, lru_ops.STAGES), (127, lru_ops.STAGES)])
def test_rglru_ring_hands_each_stage_to_the_consumer_once_in_order(
        n_stages, stages):
    """Every stage reaches the consumer once, in time order, from its
    slot, and the producer never refills a slot before its reader let it
    go (the model stalls it, and the parities the kernel waits for
    name the phases that have completed)."""
    assert ring_model(n_stages, stages) == [
        (it, it % stages) for it in range(n_stages)]
