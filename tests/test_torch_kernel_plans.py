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
"""
import inspect

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
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.testing import BF16_NORM_REL, TOL  # noqa: E402

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
