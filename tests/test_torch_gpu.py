"""Card-only tests of the port: the CUDA decode-attention kernel (K2)
against its plain version on the card, and the serve slice on the card
against the same slice on the host. They skip where CUDA is absent. On a
machine with an NVIDIA card:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances are those of tests/test_kernels.py, f32 2e-5 and bf16 2e-2,
and in bf16 also a normwise relative error of 6e-3
(``repro_torch.testing``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.testing import (NoSyncInWindow,  # noqa: E402
                                 check_decode_attention)
from repro_torch.utils import tree_map  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(B, H, K, W, hd, pos, dtype, softcap=0.0):
    before = ops.decode_attention.launches
    check_decode_attention(B, H, K, W, hd, pos, dtype, softcap=softcap)
    assert ops.decode_attention.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,pos", [(64, 5), (64, 63), (100, 31), (64, 200)])
@pytest.mark.parametrize("H,K", [(8, 2), (4, 4), (10, 1)])
def test_kernel_matches_plain_on_the_reference_grid(cuda, W, pos, H, K,
                                                    dtype):
    _check(2, H, K, W, 32, pos, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,pos,softcap", [(2, 2047, 0.0), (2, 2100, 0.0),
                                           (2, 5000, 0.0), (8, 2100, 0.0),
                                           (8, 2100, 30.0)])
def test_kernel_matches_plain_at_the_slice_shapes(cuda, K, pos, softcap,
                                                  dtype):
    """glm4-9b (K=2) and granite-8b (K=8) decode: B=8, H=32, hd=128,
    W=2120, with the ring filling, and full."""
    _check(8, 32, K, 2120, 128, pos, dtype, softcap=softcap)


@pytest.mark.parametrize("hd,H,K", [(16, 4, 1), (64, 16, 1), (128, 16, 16)])
def test_kernel_head_dims_and_groups(cuda, hd, H, K):
    _check(3, H, K, 77, hd, 40, torch.float32)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 4, 48, device=cuda)
    k = torch.zeros(1, 8, 1, 48, device=cuda)
    pos = torch.zeros((), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q, k, k, pos=pos, window=8)
    with pytest.raises(ValueError, match="cuda"):
        ops.decode_attention(q.to("meta"), k.to("meta"), k.to("meta"),
                             pos=pos.to("meta"), window=8)


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-8b"])
def test_serve_on_card_matches_host(cuda, arch):
    """f32 smoke config on the card (kernel) and on the host (plain), from
    the same weights: identical greedy tokens, no sync inside a window."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    host = build_model(cfg).init(0, device="cpu")
    before = ops.decode_attention.launches
    on_card = serve(cfg, 2, 16, 8, sample_interval=3, device=cuda,
                    params=tree_map(lambda t: t.to(cuda), host),
                    timer=NoSyncInWindow())
    assert ops.decode_attention.launches - before == cfg.num_layers * 7
    on_host = serve(cfg, 2, 16, 8, sample_interval=3, device="cpu",
                    params=host)
    assert on_card["tokens"] == on_host["tokens"]
    assert on_card["decode_fifo_rows"] == on_host["decode_fifo_rows"] == 7
