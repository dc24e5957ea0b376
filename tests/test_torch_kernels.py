"""The port's decode-attention (K2) on host tensors against the JAX
package's Pallas kernel (interpret mode) and its pure-jnp oracle.

On the CPU the port's wrapper runs its plain version; the CUDA kernel
itself is held against that plain version on the card
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
from repro_torch.kernels.decode_attention import ops as port_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as port_ref)


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
