"""The port's flash attention (K1) and decode attention (K2) on host
tensors against the JAX package's Pallas kernels (interpret mode) and
their pure-jnp oracles.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
themselves are held against those plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py). Inputs come from numpy with a
seed and go to both sides. Tolerances are those of tests/test_kernels.py:
f32 2e-5, bf16 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as port_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as port_ref)
from repro_torch.kernels.flash_attention import ops as port_fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as port_fa_ref)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KTOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, H, K, W, hd, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, hd)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, W, K, hd)) * scale).astype(np.float32)
    v = rng.standard_normal((B, W, K, hd)).astype(np.float32)
    return q, k, v


# the grid of tests/test_kernels.py::test_decode_attention
@pytest.mark.parametrize("W,pos", [(64, 5), (64, 63), (100, 31), (64, 200)])
@pytest.mark.parametrize("H,K", [(8, 2), (4, 4), (10, 1)])
def test_decode_attention_plain_matches_pallas_and_ref(W, pos, H, K):
    q, k, v = _inputs(3, 2, H, K, W, 32)
    pallas = da_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos=jnp.int32(pos),
        window=W, block_k=32, interpret=True)
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), pos=pos, window=W)
    out = port_ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        pos=torch.tensor(pos, dtype=torch.int32), window=W)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)
    assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_softcap_and_dtypes(softcap, dtype):
    """Softcap (logits scaled up so the cap bites) in f32 and bf16, against
    the Pallas kernel in interpret mode with a ragged last block."""
    W, pos, H, K, hd = 100, 77, 8, 2, 64
    q, k, v = _inputs(5, 2, H, K, W, hd, scale=3.0)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    pallas = da_ops.decode_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
        pos=jnp.int32(pos), window=W, softcap=softcap, block_k=32,
        interpret=True)
    out = port_ops.decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        pos=torch.tensor(pos, dtype=torch.int32), window=W, softcap=softcap)
    assert out.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32),
                    rtol=tol, atol=tol)


def test_plain_version_accepts_python_int_pos():
    q, k, v = _inputs(7, 1, 4, 2, 16, 16)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    a = port_ref(*args, pos=9, window=16)
    b = port_ref(*args, pos=torch.tensor(9, dtype=torch.int32), window=16)
    assert torch.equal(a, b)


def test_wrapper_counts_no_launch_on_host_tensors():
    """The launch count moves only where the CUDA kernel launches."""
    q, k, v = _inputs(8, 1, 4, 2, 16, 16)
    before = port_ops.decode_attention.launches
    port_ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              pos=torch.tensor(3, dtype=torch.int32),
                              window=16)
    assert port_ops.decode_attention.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks that guard a launch, exercised on meta tensors (they run
    before any library is loaded)."""
    meta = dict(device="meta")
    q = torch.empty(2, 8, 128, dtype=torch.bfloat16, **meta)
    k = torch.empty(2, 64, 2, 128, dtype=torch.bfloat16, **meta)
    pos = torch.empty((), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="head_dim"):
        port_ops._check(q[..., :48], k[..., :48], k[..., :48], pos, 64)
    with pytest.raises(ValueError, match="multiple"):
        port_ops._check(torch.empty(2, 34, 128, dtype=torch.bfloat16, **meta),
                        k, k, pos, 64)
    with pytest.raises(TypeError, match="share"):
        port_ops._check(q.float(), k, k, pos, 64)
    with pytest.raises(TypeError, match="int32"):
        port_ops._check(q, k, k, pos.long(), 64)
    with pytest.raises(ValueError, match="contiguous"):
        port_ops._check(q, k.transpose(1, 2).transpose(1, 2)[:, ::2],
                        k[:, ::2], pos, 64)
    port_ops._check(q, k, k, pos, 64)          # what the slice passes


# ------------------------------------------------------------------- K1 ----
def _fa_inputs(seed, B, S, H, K, hd, dtype, scale=1.0):
    """q, k, v from numpy, as (jax, torch) pairs in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal((B, S, n, hd)) * sc).astype(np.float32)
            for n, sc in ((H, scale), (K, scale), (K, 1.0))]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _fa_both(seed, B, S, H, K, hd, dtype, scale=1.0, **kw):
    """The port's K1 wrapper on host tensors against the reference's
    Pallas kernel (interpret mode, 64-row blocks as tests/test_kernels.py
    runs it) and its pure-jnp oracle."""
    jx, tx = _fa_inputs(seed, B, S, H, K, hd, dtype, scale)
    out = port_fa.flash_attention(*tx, **kw)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == (B, S, H, hd)
    pallas = fa_ops.flash_attention(*jx, block_q=64, block_k=64,
                                    interpret=True, **kw)
    ref = flash_attention_ref(*jx, **kw)
    tol = KTOL[dtype]
    for want in (pallas, ref):
        assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                        rtol=tol, atol=tol)


# the grid of tests/test_kernels.py::test_flash_attention_shapes
@pytest.mark.parametrize("B,S,H,K,hd", [(1, 128, 4, 2, 32),
                                        (2, 256, 4, 4, 64),
                                        (1, 96, 2, 1, 16),
                                        (1, 160, 8, 2, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_ref(B, S, H, K, hd,
                                                      dtype):
    _fa_both(10, B, S, H, K, hd, dtype, causal=True)


# tests/test_kernels.py::test_flash_attention_masks, without the windowed
# non-causal case that the reference skips as unused
@pytest.mark.parametrize("window,causal", [(0, True), (64, True),
                                           (33, True), (0, False)])
def test_flash_attention_plain_masks(window, causal):
    _fa_both(11, 1, 192, 4, 2, 32, "float32", window=window, causal=causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_softcap(dtype):
    """Logits scaled up (x3) so the cap of 20 bites."""
    _fa_both(12, 1, 128, 2, 2, 32, dtype, scale=3.0, causal=True,
             softcap=20.0)


def test_flash_attention_wrapper_counts_no_launch_on_host_tensors():
    _, tx = _fa_inputs(13, 1, 16, 4, 2, 16, "float32")
    before = port_fa.flash_attention.launches
    out = port_fa.flash_attention(*tx, window=5)
    assert port_fa.flash_attention.launches == before
    assert torch.equal(out, port_fa_ref(*tx, window=5))


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks that guard a launch, on meta tensors (they run before
    any library is loaded)."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(2, 64, 8, 128, **meta)
    k = torch.empty(2, 64, 2, 128, **meta)
    with pytest.raises(ValueError, match="head_dim"):
        port_fa._check(q[..., :48].contiguous(), k[..., :48].contiguous(),
                       k[..., :48].contiguous(), 0)
    with pytest.raises(ValueError, match="multiple"):
        port_fa._check(torch.empty(2, 64, 7, 128, **meta), k, k, 0)
    with pytest.raises(TypeError, match="share"):
        port_fa._check(q.float(), k, k, 0)
    with pytest.raises(ValueError, match="contiguous"):
        port_fa._check(q.transpose(1, 2), k, k, 0)
    with pytest.raises(ValueError, match="sees no key"):
        port_fa._check(torch.empty(2, 200, 8, 128, **meta), k, k, 100)
    with pytest.raises(ValueError, match="disagree"):
        port_fa._check(q, k[:1], k[:1], 0)
    port_fa._check(q, k, k, 0)                 # what the slice passes
    port_fa._check(q, k, k, 33)
