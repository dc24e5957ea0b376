"""Card-only tests of the port: the CUDA flash-attention (K1),
decode-attention (K2), selective-scan (K3), RG-LRU scan (K4) and grouped
expert GEMM (K5) kernels against their plain versions on the card, and
the serve slice and the commit-tapped forward with its Scale-Down replay
on the card against the same on the host, the co-emulator's
group-locked windows, the ZP-Scope plane inside the decode window graphs,
remat inside the train window graphs, K1's vmap rule (and K2-K5's refusal
under vmap), a lane-batched smoke farm against its solo run, the bytes
CUDA-graph private pools hold across serves, and the async farm's
threads: two threads on two streams launching K1 and K2 (exact counts,
bitwise), a window graph captured on a thread beside eager launches,
first-use kernel builds from two threads, the async smoke farm
against lockstep, ten consecutive async farm passes leaving no bytes
after the first, and ZP-Ledger recovering a campaign of card outputs.
They skip where CUDA is absent.
On a machine with an NVIDIA card:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The CUDA-graph windows (decode and train) are held bitwise against the
eager engines, and the train window's "xla" path against the same code
on host tensors (``testing.check_train_parity``'s stated limits).
cuBLAS takes a fixed workspace (``CUBLAS_WORKSPACE_CONFIG``, set below
before CUDA initialises), so a capture on a side stream picks the same
algorithms as the eager run, and deterministic mode allows it.

Kernel tolerances are those of tests/test_kernels.py, f32 2e-5 and bf16
2e-2 for K1, K2 and K5, and in bf16 also a normwise relative error (6e-3
for K1 and K2, 2e-3 for K5); K3 at 1e-4 and K4 at 1e-5 in f32
(test_ssm_scan's and test_rglru_scan's), every output alike; the composed
expert FFN at 1e-4 in f32 (test_moe_ffn_composed's); the forward holds
the loss and checksums within 1e-5 (``repro_torch.testing``).
"""
import dataclasses
import os
import threading

import numpy as np
import pytest

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as gg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.testing import (NoSyncInWindow,  # noqa: E402
                                 TAPS, assert_records_equal,
                                 assert_serve_equal,
                                 assert_trees_equal,
                                 check_decode_attention,
                                 check_decode_graph,
                                 check_drain_before_replay,
                                 check_train_parity, deterministic,
                                 train_run,
                                 check_decode_determinism,
                                 check_flash_attention,
                                 check_flash_attention_bitwise,
                                 check_flash_attention_vmap,
                                 private_pool_bytes,
                                 check_forward_parity, check_grouped_gemm,
                                 check_grouped_gemm_bitwise,
                                 check_moe_ffn, check_rglru_scan,
                                 check_rglru_scan_bitwise,
                                 check_ssm_scan, check_ssm_scan_bitwise,
                                 layer_kernels, rglru_scan_inputs,
                                 serve_kernels, tally)
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.gpu
ARCHS = ["glm4-9b", "granite-8b", "falcon-mamba-7b", "recurrentgemma-2b",
         "qwen3-moe-30b-a3b", "mixtral-8x7b", "internlm2-20b",
         "command-r-35b", "internvl2-1b"]
# the enc-dec serves, but has no decoder-only stack to replay (Scale-Down
# refuses it), so it is not in the forward parity
SERVE_ARCHS = ARCHS + ["whisper-small"]
KERNELS = {"k1": fa_ops.flash_attention, "k2": ops.decode_attention,
           "k3": ssm_ops.ssm_scan, "k4": lru_ops.rglru_scan,
           "k5": gg_ops.grouped_gemm}


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


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_on_card_matches_host(cuda, arch):
    """f32 smoke config on the card (kernels) and on the host (plain), from
    the same weights: identical greedy tokens, no sync inside a window.
    K2 runs once per attention layer per decode step; K3 and K4 once per
    mamba or RG-LRU layer in the prefill; K5 three times per MoE layer in
    the prefill and in each decode step; K1 never (the prefill's
    attention is plain, as in the reference)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    host = build_model(cfg).init(0, device="cpu")
    before = {k: fn.launches for k, fn in KERNELS.items()}
    on_card = serve(cfg, 2, 16, 8, sample_interval=3, device=cuda,
                    params=tree_map(lambda t: t.to(cuda), host),
                    timer=NoSyncInWindow())
    _, want = serve_kernels(cfg, 7)
    assert {k: fn.launches - before[k] for k, fn in KERNELS.items()} \
        == {k: want.get(k, 0) for k in KERNELS}
    on_host = serve(cfg, 2, 16, 8, sample_interval=3, device="cpu",
                    params=host)
    assert on_card["tokens"] == on_host["tokens"]
    assert on_card["decode_fifo_rows"] == on_host["decode_fifo_rows"] == 7


# ------------------------------------------------------------------- K1 ----
def _check_fa(*args, **kw):
    before = fa_ops.flash_attention.launches
    check_flash_attention(*args, **kw)
    assert fa_ops.flash_attention.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd", [(1, 128, 4, 2, 32),
                                        (2, 256, 4, 4, 64),
                                        (1, 96, 2, 1, 16),
                                        (1, 160, 8, 2, 32)])
def test_flash_kernel_matches_plain_on_the_reference_grid(cuda, B, S, H, K,
                                                          hd, dtype):
    _check_fa(B, S, H, K, hd, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,causal,softcap", [
    (0, True, 0.0), (64, True, 0.0), (33, True, 0.0), (0, False, 0.0),
    (0, True, 20.0), (33, False, 0.0)])
def test_flash_kernel_masks_and_softcap(cuda, window, causal, softcap,
                                        dtype):
    _check_fa(1, 192, 4, 2, 32, dtype, window=window, causal=causal,
              softcap=softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,K,window,softcap", [(4096, 2, 0, 0.0),
                                                (4096, 8, 0, 0.0),
                                                (4000, 8, 33, 30.0),
                                                (4096, 4, 0, 0.0)])
def test_flash_kernel_matches_plain_at_the_slice_shapes(cuda, S, K, window,
                                                        softcap, dtype):
    """glm4-9b (K=2), granite-8b (K=8) and qwen3-moe-30b-a3b (K=4)
    forward: B=2, H=32, hd=128, causal; and a ragged S=4000 with a window
    and a softcap."""
    _check_fa(2, S, 32, K, 128, dtype, window=window, softcap=softcap)


@pytest.mark.parametrize("hd,H,K,T", [(16, 16, 1, 77), (64, 16, 1, 77),
                                      (128, 16, 16, 130), (32, 6, 3, 300),
                                      (8, 8, 2, 77), (8, 16, 1, 200)])
def test_flash_kernel_head_dims_groups_and_lengths(cuda, hd, H, K, T):
    """G from 1 to 16, and S != T in both directions."""
    _check_fa(2, 77, H, K, hd, torch.float32, T=T)
    _check_fa(2, 77, H, K, hd, torch.bfloat16, T=T, causal=False)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 4, 48, device=cuda)
    k = torch.zeros(1, 8, 1, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="cuda"):
        fa_ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_card_matches_host(cuda, arch):
    """f32 smoke config from seed 0: the loss and checksums on the card
    (K1, K3, K4 or K5) and on the host (plain) within 1e-5; every layer's
    replay bitwise on both; a MoE config's routing equal."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    out = check_forward_parity(cfg)
    # one launch per layer of its kind in the loss, and in each
    # verify_extraction (its in-situ capture of every layer) one per layer
    # of its kind, plus the replay: per kind, count * (L + 2) in all
    want = tally(layer_kernels(cfg), cfg.num_layers + 2)
    assert {k: out[f"{k}_launches"] for k in ("k1", "k3", "k4", "k5")} \
        == {k: want.get(k, 0) for k in ("k1", "k3", "k4", "k5")}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_parity_holds_over_seeds_0_to_9(cuda, arch):
    """The card-vs-host forward parity of every f32 smoke config at each
    of seeds 0-9: each checksum's mean is gated relative to its layer's
    mean |x|, so a small mean is no longer a reason to pick a seed."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    failed = {}
    for seed in range(10):
        try:
            check_forward_parity(cfg, seed=seed)
        except AssertionError as e:
            failed[seed] = str(e)
    assert not failed, failed


# ------------------------------------------- K2 split, K1 on wgmma ----
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 2, 2120, 128), (8, 10, 1, 2048, 256),
                                   (8, 32, 4, 2120, 128)],
                         ids=["glm4-9b", "recurrentgemma-2b",
                              "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("edge", ["first", "chunk_end", "next_chunk",
                                  "second_end", "full", "wrapped"])
def test_decode_split_at_chunk_edges_of_the_serve_shapes(cuda, shape, edge,
                                                         dtype):
    """The serve shapes with ``pos`` in the first chunk, on the last slot
    of a chunk, on the first slot of the next, at the end of the second,
    with the ring just full and wrapped: the live splits change exactly
    there."""
    B, H, K, W, hd = shape
    chunk, _ = ops.split_plan(B * K, W, ops.sm_count(cuda))
    pos = {"first": 3, "chunk_end": chunk - 1, "next_chunk": chunk,
           "second_end": 2 * chunk - 1, "full": W - 1,
           "wrapped": W + 70}[edge]
    _check(B, H, K, W, hd, pos, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 8, 10, 16])
def test_decode_split_at_every_group_and_head_dim(cuda, G, hd, dtype):
    """G query heads per kv head (1, 8, 10, 16) at every head_dim, two
    kv heads, a 1000-slot ring at pos 517 and wrapped at 1400."""
    for pos in (517, 1400):
        _check(2, 2 * G, 2, 1000, hd, pos, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 12, 12, 2120, 64), (8, 14, 2, 2376, 64)],
                         ids=["whisper-small", "internvl2-1b"])
@pytest.mark.parametrize("edge", ["first", "chunk_end", "next_chunk", "full",
                                  "wrapped"])
def test_decode_at_head_dim_64_and_groups_1_and_7(cuda, shape, edge, dtype):
    """whisper-small's decode (G = 1, MHA) and internvl2-1b's (G = 7) at
    head_dim 64 and their serve rings, pos on the split edges."""
    B, H, K, W, hd = shape
    chunk, _ = ops.split_plan(B * K, W, ops.sm_count(cuda))
    pos = {"first": 3, "chunk_end": chunk - 1, "next_chunk": chunk,
           "full": W - 1, "wrapped": W + 70}[edge]
    _check(B, H, K, W, hd, pos, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,K", [(4096, 12, 12), (4096, 14, 2),
                                   (4000, 14, 2)],
                         ids=["whisper-small", "internvl2-1b", "ragged"])
def test_flash_at_head_dim_64_and_groups_1_and_7(cuda, S, H, K, dtype):
    """K1's mma.sync instance at the head_dim-64 forward shapes (B=2):
    whisper-small's decoder (G = 1), internvl2-1b's (G = 7), ragged."""
    _check_fa(2, S, H, K, 64, dtype)


@pytest.mark.parametrize("shape", [(2, 4096, 12, 12, 64), (2, 4096, 14, 2, 64),
                                   (8, 12, 12, 2120, 64),
                                   (8, 14, 2, 2376, 64)],
                         ids=["k1-whisper", "k1-internvl2", "k2-whisper",
                              "k2-internvl2"])
def test_head_dim_64_kernels_are_bitwise_over_launches_and_a_replay(cuda,
                                                                    shape):
    """K1 and K2 at the head_dim-64 model shapes give the same bits from
    launch to launch and in a CUDA-graph replay."""
    if shape[1] == 4096:
        check_flash_attention_bitwise(*shape, seed=3)
    else:
        B, H, K, W, hd = shape
        check_decode_determinism(B, H, K, W, hd, (W - 300, W + 5), seed=3)


@pytest.mark.parametrize("pos", [700, 2100])
def test_decode_split_is_bitwise_over_launches_and_a_graph_replay(cuda, pos):
    """The combine merges the splits in a fixed order: two launches agree
    to the bit, and so does a CUDA-graph replay of the same launch, also
    after ``pos`` moves on the card (one launch a call: the launch count
    moves by one per eager call)."""
    check_decode_determinism(8, 32, 2, 2120, 128, (pos, pos + 1), seed=pos)


@pytest.mark.parametrize("hd,H,K", [(128, 8, 8), (128, 16, 4), (128, 32, 4),
                                    (256, 10, 1), (128, 20, 2), (256, 8, 2)],
                         ids=["hd128-G1", "hd128-G4", "hd128-G8",
                              "hd256-G10", "hd128-G10", "hd256-G4"])
@pytest.mark.parametrize("S,T,causal,window,softcap", [
    (333, 333, True, 0, 0.0), (333, 333, True, 33, 0.0),
    (300, 461, False, 0, 0.0), (2100, 2100, True, 2048, 0.0),
    (200, 200, True, 0, 30.0), (4000, 4000, True, 33, 30.0)],
    ids=["ragged-causal", "window33", "S<T", "window2048", "softcap30",
         "long-window33-softcap30"])
def test_flash_wgmma_matches_plain(cuda, hd, H, K, S, T, causal, window,
                                   softcap):
    """K1's bf16 wgmma path (head_dim 128 and 256) against its plain
    version: S and T not multiples of the 128-row q tile or the key tile,
    windows of 33 and 2048, a softcap of 30, G = 1, 4, 8 and 10."""
    _check_fa(2, S, H, K, hd, torch.bfloat16, T=T, causal=causal,
              window=window, softcap=softcap)


@pytest.mark.parametrize("hd,H,K,window", [(128, 32, 2, 0),
                                           (256, 10, 1, 2048)])
def test_flash_wgmma_is_bitwise_over_launches(cuda, hd, H, K, window):
    """Scale-Down's bitwise replay needs K1 to give the same bits from
    launch to launch."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn(2, 1000, H, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(2, 1000, K, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(2, 1000, K, hd, generator=g, device="cuda").bfloat16()
    a = fa_ops.flash_attention(q, k, v, window=window)
    assert torch.equal(a, fa_ops.flash_attention(q, k, v, window=window))


def _grad_inputs(name):
    def t(*shape):
        return torch.randn(*shape, device="cuda").requires_grad_()
    if name == "k1":
        return lambda: fa_ops.flash_attention(t(1, 8, 4, 64), t(1, 8, 2, 64),
                                              t(1, 8, 2, 64))
    if name == "k2":
        pos = torch.tensor(3, dtype=torch.int32, device="cuda")
        return lambda: ops.decode_attention(t(1, 4, 64), t(1, 8, 2, 64),
                                            t(1, 8, 2, 64), pos=pos, window=8)
    if name == "k3":
        return lambda: ssm_ops.ssm_scan(t(1, 5, 8), t(8, 4), t(1, 5, 4),
                                        t(1, 5, 4), t(1, 5, 8))
    if name == "k4":
        return lambda: lru_ops.rglru_scan(t(1, 5, 8), t(1, 5, 8), t(1, 8))
    return lambda: gg_ops.grouped_gemm(t(2, 8, 8), t(2, 8, 8))


@pytest.mark.parametrize("name", ["k1", "k2", "k3", "k4", "k5"])
def test_wrappers_refuse_grad_on_the_card(cuda, name):
    """A kernel's result carries no autograd history, so each wrapper's
    CUDA branch raises under grad mode with an input that requires grad,
    and launches nothing; under inference mode it runs."""
    call = _grad_inputs(name)
    before = KERNELS[name].launches
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert KERNELS[name].launches == before
    with torch.inference_mode():
        call()
    assert KERNELS[name].launches == before + 1


# ------------------------------------------------------------------- K3 ----
@pytest.mark.parametrize("B,S,Din,N", [(2, 64, 32, 8), (1, 100, 48, 4)])
def test_ssm_kernel_matches_plain_on_the_reference_grid(cuda, B, S, Din, N):
    check_ssm_scan(B, S, Din, N)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("B,S,Din,N", [(2, 4000, 8192, 16),
                                       (3, 9, 130, 16), (1, 1, 5, 8),
                                       (2, 33, 200, 4)])
def test_ssm_kernel_ragged_and_strided(cuda, B, S, Din, N, strided):
    """S not a multiple of the kernel's time chunk, Din not a multiple of
    its channel block, and B_/C_ as strided views."""
    check_ssm_scan(B, S, Din, N, strided=strided)


@pytest.mark.parametrize("B,S", [(2, 4096), (8, 2048)],
                         ids=["forward", "prefill"])
def test_ssm_kernel_at_the_slice_shapes(cuda, B, S):
    """falcon-mamba-7b's forward (B=2, S=4096) and serve prefill (B=8,
    S=2048): Din=8192, N=16, B_ and C_ strided as the model passes them."""
    check_ssm_scan(B, S, 8192, 16, strided=True)


def test_ssm_kernel_is_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = torch.rand(2, 300, 256, generator=g, device=cuda)
    A = -torch.rand(256, 16, generator=g, device=cuda)
    B_, C_, x = (torch.randn(2, 300, n, generator=g, device=cuda)
                 for n in (16, 16, 256))
    y0, h0 = ssm_ops.ssm_scan(dt, A, B_, C_, x)
    y1, h1 = ssm_ops.ssm_scan(dt, A, B_, C_, x)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)


def test_ssm_kernel_refuses_what_it_does_not_take(cuda):
    z = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="state size"):
        ssm_ops.ssm_scan(z, torch.zeros(8, 5, device=cuda),
                         torch.zeros(1, 4, 5, device=cuda),
                         torch.zeros(1, 4, 5, device=cuda), z)
    with pytest.raises(ValueError, match="want B_"):
        ssm_ops.ssm_scan(z, torch.zeros(8, 4, device=cuda),
                         torch.zeros(1, 3, 4, device=cuda),
                         torch.zeros(1, 4, 4, device=cuda), z)


# ---------------------------------------------------------- K1, K2 at 256 --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(4096, 2048), (4000, 100), (77, 0)])
def test_flash_kernel_at_head_dim_256(cuda, S, window, dtype):
    """recurrentgemma-2b's local attention: B=2, H=10, K=1, hd=256,
    causal with its 2048-key window at the forward shape; a ragged S with
    a narrow window; and a short one without."""
    _check_fa(2, S, 10, 1, 256, dtype, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [1000, 2047, 2048, 2110])
def test_decode_kernel_at_head_dim_256_around_the_ring_wrap(cuda, pos,
                                                            dtype):
    """recurrentgemma-2b's serve decode: B=8, H=10, K=1, hd=256, a
    2048-slot ring, filling (1000), just full (2047) and overwritten
    (2048 and 2110, the serve run's first and last steps)."""
    _check(8, 10, 1, 2048, 256, pos, dtype)


# ------------------------------------------------------------------- K4 ----
def _paths(shapes):
    """Each shape through the wrapper's path (None) and each path forced
    that takes it ("tma" only where W is a multiple of 4)."""
    return [(*shape, path) for shape in shapes
            for path in (None, *lru_ops.PATHS)
            if path != "tma" or shape[2] % 4 == 0]


@pytest.mark.parametrize("B,S,W,path", _paths([(2, 64, 32), (1, 96, 64)]))
def test_rglru_kernel_matches_plain_on_the_reference_grid(cuda, B, S, W,
                                                          path):
    check_rglru_scan(B, S, W, path=path)


@pytest.mark.parametrize("B,S,W,split,path", [
    (*shape, path) for shape in [(1, 40, 16, 17), (2, 300, 96, 64),
                                 (2, 4096, 2560, 1000)]
    for path in (None, *lru_ops.PATHS)])
def test_rglru_kernel_chaining_property(cuda, B, S, W, split, path):
    """Two launches, the second from the first's h_last, equal one."""
    check_rglru_scan(B, S, W, split=split, path=path)


@pytest.mark.parametrize("B,S,W,path", _paths([
    (2, 4000, 2600), (8, 2000, 2600), (3, 9, 33), (1, 1, 5), (2, 65, 40),
    (1, 1, 8)]))
def test_rglru_kernel_ragged(cuda, B, S, W, path):
    """S not a multiple of a stage's 32 steps on "tma" or of the 64 steps
    in flight on "registers", W not a multiple of the 32 channels a block;
    W = 33 and 5 take "registers", and so does (8, 2000, 2600) through the
    wrapper (656 blocks, above two an SM), the others "tma"."""
    check_rglru_scan(B, S, W, path=path)


@pytest.mark.parametrize("path", [None, *lru_ops.PATHS])
@pytest.mark.parametrize("B,S", [(2, 4096), (8, 2048)],
                         ids=["forward", "prefill"])
def test_rglru_kernel_at_the_slice_shapes(cuda, B, S, path):
    """recurrentgemma-2b's forward (B=2, S=4096: "tma") and serve prefill
    (B=8, S=2048: "registers" through the wrapper), W=2560."""
    check_rglru_scan(B, S, 2560, path=path)


def test_rglru_kernel_is_deterministic_and_rounds_as_the_plain_version(
        cuda):
    """Each step is a rounded product and then a rounded sum, as the plain
    version computes it: the kernel agrees with it to the bit, and with
    itself from run to run."""
    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.rand(2, 300, 256, generator=g, device=cuda)
    b = torch.randn(2, 300, 256, generator=g, device=cuda)
    h0 = torch.randn(2, 256, generator=g, device=cuda)
    h, last = lru_ops.rglru_scan(a, b, h0)
    h1, last1 = lru_ops.rglru_scan(a, b, h0)
    hr, last_r = rglru_scan_ref(a, b, h0)
    assert torch.equal(h, h1) and torch.equal(last, last1)
    assert torch.equal(h, hr) and torch.equal(last, last_r)


@pytest.mark.parametrize("B,S,W,path", _paths([
    (2, 4096, 2560), (8, 2048, 2560), (2, 65, 40)]))
def test_rglru_kernel_is_bitwise_over_launches_and_a_graph_replay(
        cuda, B, S, W, path):
    """One launch a call, equal to the bit from launch to launch and in a
    CUDA-graph replay (the TMA maps passed by value, the outputs the only
    allocations)."""
    check_rglru_scan_bitwise(B, S, W, path=path)


@pytest.mark.parametrize("W", [2560, 5])
def test_rglru_kernel_off_16_bytes_takes_the_register_path(cuda, W):
    """a and b 4 bytes past a 16-byte boundary: the wrapper takes
    "registers", still equal to the plain version to the bit; "tma"
    forced raises."""
    a, _, h0 = rglru_scan_inputs(2, 100, W, 0, offset=True)
    assert lru_ops.choose_path(2, W, a.data_ptr(), a.data_ptr(),
                               lru_ops.sm_count(cuda)) == "registers"
    check_rglru_scan(2, 100, W, offset=True)
    with pytest.raises(ValueError, match="cannot map"):
        lru_ops._launch(a, a, h0, "tma")


def test_rglru_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="want h0"):
        lru_ops.rglru_scan(a, a, torch.zeros(1, 4, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        lru_ops.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2),
                           a, torch.zeros(1, 8, device=cuda))
    a = torch.zeros(1, 4, 33, device=cuda)
    with pytest.raises(ValueError, match="cannot map"):
        lru_ops._launch(a, a, torch.zeros(1, 33, device=cuda), "tma")


# ------------------------------------------------------------------- K5 ----
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N", [(4, 128, 64, 128), (3, 50, 33, 17),
                                     (1, 8, 8, 8), (8, 256, 128, 64)])
def test_grouped_gemm_kernel_matches_plain_on_the_reference_grid(
        cuda, E, M, K, N, dtype):
    check_grouped_gemm(E, M, K, N, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N", [(5, 77, 136, 200), (2, 129, 40, 136),
                                     (3, 1, 7, 9), (2, 300, 1000, 3)])
def test_grouped_gemm_kernel_ragged(cuda, E, M, K, N, dtype):
    """M, N and K off the tiles, with the 16-byte copies (K and N
    multiples of 8) and without them."""
    check_grouped_gemm(E, M, K, N, dtype)


@pytest.mark.parametrize("C", [640, 1280, 8],
                         ids=["forward", "prefill", "decode"])
@pytest.mark.parametrize("prod", ["gate_up", "down"])
def test_grouped_gemm_kernel_at_the_slice_shapes(cuda, C, prod):
    """qwen3-moe-30b-a3b's expert products, 128 experts: gate/up
    (C, 2048) @ (2048, 768) and down (C, 768) @ (768, 2048), at the
    capacities of its forward, serve prefill and decode, bf16."""
    D, F = 2048, 768
    K, N = (D, F) if prod == "gate_up" else (F, D)
    check_grouped_gemm(128, C, K, N, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_through_three_launches_matches_plain(cuda, dtype):
    check_moe_ffn(4, 64, 32, 48, dtype)
    check_moe_ffn(8, 24, 64, 96, dtype)


def test_grouped_gemm_kernel_is_deterministic(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(16, 200, 512, generator=g, device=cuda).to(dtype)
        w = torch.randn(16, 512, 384, generator=g, device=cuda).to(dtype)
        assert torch.equal(gg_ops.grouped_gemm(x, w),
                           gg_ops.grouped_gemm(x, w))


def test_grouped_gemm_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="want x"):
        gg_ops.grouped_gemm(x, torch.zeros(2, 4, 8, device=cuda))
    with pytest.raises(TypeError, match="share"):
        gg_ops.grouped_gemm(x, torch.zeros(2, 8, 4, device=cuda,
                                           dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        gg_ops.grouped_gemm(x, torch.zeros(2, 4, 8, device=cuda)
                            .transpose(1, 2))


# ------------------------------------------------------- K5's paths ----
PATH_ROWS = [1, 7, 8, 9, 63, 64, 65, 127, 129, 640, 1280]


@pytest.mark.parametrize("M", PATH_ROWS)
@pytest.mark.parametrize("path", ["wgmma", "mma"])
def test_grouped_gemm_each_path_matches_plain(cuda, path, M):
    """Each bf16 kernel against the plain version at M rows an expert on
    either side of the wgmma kernel's 128-row tiles and the mma kernel's
    16-row m-tiles, from the decode's few rows to the prefill's 1280; K
    and N off the 64-deep slices and the 128/256-column tiles (K 200, N
    136, both multiples of 8)."""
    check_grouped_gemm(3, M, 200, 136, torch.bfloat16, path=path)


@pytest.mark.parametrize("prod", ["gate_up", "down"])
@pytest.mark.parametrize("path,M", [("wgmma", 8), ("wgmma", 640),
                                    ("wgmma", 1280), ("mma", 8),
                                    ("mma", 640)])
def test_grouped_gemm_each_path_at_qwen3_widths(cuda, path, M, prod):
    """Every path at qwen3-moe-30b-a3b's expert widths (128 experts), at
    the decode's 8 rows, the forward's 640 and the prefill's 1280."""
    K, N = (2048, 768) if prod == "gate_up" else (768, 2048)
    check_grouped_gemm(128, M, K, N, torch.bfloat16, path=path)


@pytest.mark.parametrize("E,M,K,N,offset", [
    (3, 640, 2047, 768, False), (3, 8, 2048, 767, False),
    (2, 100, 36, 44, False), (3, 8, 2048, 768, True),
    (3, 640, 256, 512, True)])
def test_grouped_gemm_falls_to_the_mma_kernel_where_tma_cannot_map(
        cuda, E, M, K, N, offset):
    """K or N not a multiple of 8, or x's base off a 16-byte boundary:
    the wrapper picks the mma.sync kernel, which holds against the plain
    version; the TMA path refuses such operands."""
    x = torch.zeros(E * M * K + int(offset), device=cuda,
                    dtype=torch.bfloat16)[int(offset):].view(E, M, K)
    w = torch.zeros(E, K, N, device=cuda, dtype=torch.bfloat16)
    assert gg_ops.choose_path(x.dtype, M, K, N, x.data_ptr(),
                              w.data_ptr()) == "mma"
    with pytest.raises(ValueError, match="cannot take"):
        gg_ops._launch(x, w, "wgmma")
    check_grouped_gemm(E, M, K, N, torch.bfloat16, offset=offset)


@pytest.mark.parametrize("path,M", [("wgmma", 640), ("wgmma", 65),
                                    ("wgmma", 8), ("mma", 100),
                                    ("fma", 50)])
def test_grouped_gemm_is_bitwise_over_launches_and_a_graph_replay(
        cuda, path, M):
    """One launch a call, equal to the bit from launch to launch and in a
    CUDA-graph replay of the same call (no host sync, the output the only
    allocation, the TMA maps passed by value)."""
    dtype = torch.float32 if path == "fma" else torch.bfloat16
    check_grouped_gemm_bitwise(16, M, 512, 768, dtype, path=path)


@pytest.mark.parametrize("B,S,Din,N", [(2, 1, 64, 16), (1, 17, 130, 4),
                                       (2, 33, 96, 8), (1, 4096, 8192, 16)])
def test_ssm_kernel_is_bitwise_over_launches_and_a_graph_replay(cuda, B, S,
                                                                Din, N):
    """K3's lane groups add their partial sums of y in a fixed tree: equal
    to the bit from launch to launch and in a CUDA-graph replay, at every
    state size."""
    check_ssm_scan_bitwise(B, S, Din, N)


@pytest.mark.parametrize("N,G", [(8, 1), (8, 2), (16, 1), (16, 4)])
def test_ssm_kernel_each_group_is_bitwise_over_launches_and_a_graph_replay(
        cuda, N, G):
    """Each lane group, forced, bitwise over launches and a graph replay,
    at a shape with a ragged chunk."""
    check_ssm_scan_bitwise(2, 33, 300, N, group=G)


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 31, 33])
def test_ssm_kernel_lane_groups_at_chunk_edges(cuda, S, N):
    """The wrapper's lane group at N = 4, 8, 16 (at B = 2, Din = 100: 1,
    2 and 4 lanes), S of one step and on either side of the 16-step
    chunk, Din off the channel block, B_/C_ strided."""
    check_ssm_scan(2, S, 100, N, strided=True)


@pytest.mark.parametrize("N,G", [(4, 1), (8, 1), (8, 2), (16, 1),
                                 (16, 4)])
@pytest.mark.parametrize("S", [1, 16, 33])
def test_ssm_kernel_each_lane_group_matches_plain(cuda, S, N, G):
    """Every lane group the kernel has, forced, against the plain version
    at SSM_TOL: one step and either side of the chunk, Din off the 256-,
    128- and 64-channel blocks, B_/C_ strided."""
    check_ssm_scan(2, S, 300, N, strided=True, group=G)


# ------------------------------------------------- CUDA-graph windows ----
FAMILIES = ["glm4-9b", "falcon-mamba-7b", "recurrentgemma-2b",
            "qwen3-moe-30b-a3b", "whisper-small", "internvl2-1b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_window_graph_is_bitwise_against_the_eager_engine(cuda,
                                                                 arch):
    """serve() with every window one CUDA-graph replay (a full window and a
    tail) equals the eager engine to the bit: tokens, FIFO rows, CSRs and
    the final cache; the launch counts hold as replays."""
    out = check_decode_graph(get_smoke_config(arch), B=2, prompt_len=16,
                             gen=9, sample_interval=3)
    assert out["graph"]["windows_by_engine"] == {"graph": 3, "eager": 0}


def test_pinned_drain_is_ordered_before_the_next_replay(cuda):
    assert check_drain_before_replay() == 6


def test_window_graph_counts_each_replay(cuda):
    """A capture counts nothing (nor its warm-up on clones); each replay
    adds the launches the window executes."""
    from repro_torch.core.graphs import WindowGraphs
    from repro_torch.core.pshell import ShellConfig, shell_init
    q = torch.randn(2, 4, 32, device="cuda")
    k = torch.randn(2, 64, 2, 32, device="cuda")
    pos = torch.tensor(40, dtype=torch.int32, device="cuda")

    def engine(state, shell, xs):
        out = state
        for _ in range(xs.shape[0]):
            out = ops.decode_attention(out, k, k, pos=pos, window=64)
        state.copy_(out)
        return state, shell, xs
    graphs = WindowGraphs(engine)
    shell = shell_init(ShellConfig(), "cuda")
    before = ops.decode_attention.launches
    graphs.prepare(q, shell, np.arange(5))
    assert ops.decode_attention.launches == before
    assert graphs.warmup_launches == {"k2": 1}
    for i in range(3):
        graphs(q, shell, np.arange(5))
        assert ops.decode_attention.launches == before + 5 * (i + 1)
    assert graphs.windows == {"graph": 3, "eager": 0}


@pytest.mark.parametrize("arch", FAMILIES)
def test_fused_train_window_replays_bitwise_against_per_step(cuda, arch):
    """PShell.run_grouped of make_group_step (a window run eagerly first,
    then one CUDA-graph replay a window) equals PShell.run step by step to
    the bit under deterministic mode: the whole train state, every step's
    metrics, every drained record (commit rows, counts, dropped credits,
    CSRs), with an undersized commit FIFO so credits are dropped; and the
    params equal with the shell off."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rt = Runtime(attention_impl="xla", taps=TAPS | {"router"})
    batches = [make_batch_fn(cfg, 2, 16, 0)(i) for i in range(7)]
    depth = 2 * cfg.num_layers - 1
    with deterministic():
        a = train_run(cfg, rt, batches, 2, grouped=False,
                      commit_depth=depth)
        b = train_run(cfg, rt, batches, 2, commit_depth=depth)
        c = train_run(cfg, rt, batches, 2, shell=False)
    assert b["windows"] == {"graph": 2, "eager": 2}
    assert_trees_equal(a["state"], b["state"], f"{arch} train state")
    assert_records_equal(a["records"], b["records"], f"{arch} records")
    assert_trees_equal(a["state"]["params"], c["state"]["params"],
                       f"{arch} shell off")
    dropped = [r["fifos"]["commits"]["dropped"] for _, r in b["records"]]
    assert dropped == [1, 2, 3, 3], dropped


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_window_on_the_card_matches_the_host(cuda, arch):
    check_train_parity(dataclasses.replace(get_smoke_config(arch),
                                           dtype="float32"))


def test_make_train_step_on_a_cuda_model_raises_on_the_card(cuda):
    """The kernels have no backward: a "cuda" model cannot train on the
    card (the wrappers refuse under grad mode)."""
    from repro_torch.train import init_state, make_train_step
    cfg = get_smoke_config("glm4-9b")
    model = build_model(cfg)
    state = init_state(model, 0, device="cuda")
    step = make_train_step(model)
    with pytest.raises(RuntimeError, match="no backward"):
        step(state, make_batch_fn(cfg, 2, 16, 0)(0))


# ------------------------------------------------------------ co-emulation --
def _coemu_setup(arch, dtype=None, seed=1, impl="xla"):
    from repro_torch.train import init_state, make_train_step
    cfg = get_smoke_config(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg, Runtime(attention_impl=impl,
                                     taps=frozenset({"commits"})))
    batches = [make_batch_fn(cfg, 2, 16, 0)(i) for i in range(8)]
    return (cfg, model, make_train_step(model),
            init_state(model, seed, device="cuda"), batches)


def _static_ptrs(graphs):
    return {t.data_ptr() for c in graphs.graphs.values()
            for t in tree_leaves(c.state_in)}


@pytest.mark.parametrize("fault_layer", [0, 1])
def test_group_locked_coemu_on_the_card_localizes_a_fault(cuda,
                                                          fault_layer):
    """CoEmulator(step, step): one step function on both sides, yet each
    side replays graphs of its own whose static state is that side's
    working copy (one shared graph would copy each side's state into the
    other's buffers from the second window on)."""
    from repro_torch.core import CoEmulator
    from repro_torch.core.coemu import inject_fault
    from repro_torch.core.graphs import WindowGraphs
    cfg, _, step, state, batches = _coemu_setup("glm4-9b")
    bad = {**state, "params": inject_fault(state["params"], cfg,
                                           fault_layer)}
    emu = CoEmulator(step, step)
    with deterministic():
        rep = emu.verify(bad, state, batches, group_size=4)
    assert rep.diverged and rep.steps == 8
    assert (rep.first.step, rep.first.layer) == (0, fault_layer)
    dut, orc = emu._engines["dut"], emu._engines["orc"]
    assert isinstance(dut, WindowGraphs) and isinstance(orc, WindowGraphs)
    assert dut is not orc
    assert dut.windows == orc.windows == {"graph": 1, "eager": 1}
    assert _static_ptrs(dut) == {t.data_ptr()
                                 for t in tree_leaves(emu._work["dut"])}
    assert _static_ptrs(orc) == {t.data_ptr()
                                 for t in tree_leaves(emu._work["orc"])}
    assert not _static_ptrs(dut) & _static_ptrs(orc)


def test_a_second_verify_allocates_no_second_working_copy(cuda):
    from repro_torch.core import CoEmulator
    _, _, step, state, batches = _coemu_setup("granite-8b")
    emu = CoEmulator(step, step, rtol=1e-6)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    with deterministic():
        first = emu.verify(state, state, batches, group_size=4)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        work = dict(emu._work)
        second = emu.verify(state, state, batches, group_size=4)
        torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - allocated < state_bytes // 2
    assert emu._work["dut"] is work["dut"] and emu._work["orc"] is work["orc"]
    assert emu._engines["dut"].windows == {"graph": 3, "eager": 1}
    assert first == second and first.max_rel_err == 0.0


def test_grouped_report_equals_step_locked_on_the_card(cuda):
    """A bf16 DUT against an f32 oracle drawn from the same seed: the
    group-locked reports (graph replays, a tail of 2, overlapped and
    serial) equal the step-locked report field by field, and each side's
    final working state equals the step-locked run's to the bit."""
    from repro_torch.core import CoEmulator
    _, _, step16, s16, batches = _coemu_setup("granite-8b")
    _, _, step32, s32, _ = _coemu_setup("granite-8b", "float32")
    with deterministic():
        es = CoEmulator(step16, step32, rtol=0.3)
        rep_s = es.verify(s16, s32, batches)
        eg = CoEmulator(step16, step32, rtol=0.3)
        rep_g = eg.verify(s16, s32, batches, group_size=3)
        for side in ("dut", "orc"):
            assert_trees_equal(eg._work[side], es._work[side], side)
        rep_ser = eg.verify(s16, s32, batches, group_size=3, overlap=False)
    assert rep_g == rep_s == rep_ser
    assert rep_s.steps == 8 and 0 < rep_s.max_rel_err < float("inf")
    assert eg._engines["dut"].windows == {"graph": 1 + 3, "eager": 2}


def test_kernel_forward_step_verifies_on_the_card(cuda):
    """The forward-only step on the kernels ("cuda": K1) against the same
    step on the plain path in f32, and a fault at layer 1 against the
    clean kernel step: named at (0, 1); K1 launched once a layer a step on
    each kernel side, replays counted."""
    from repro_torch.core import CoEmulator
    from repro_torch.core.coemu import inject_fault
    from repro_torch.testing import forward_step
    cfg, kmodel, _, _, batches = _coemu_setup("glm4-9b", "float32",
                                              impl="cuda")
    kstep = forward_step(kmodel)
    xstep = forward_step(build_model(cfg, Runtime(
        attention_impl="xla", taps=frozenset({"commits"}))))
    params = build_model(cfg).init(1, device="cuda")
    L = cfg.num_layers
    for group in (1, 4):
        KERNELS["k1"].launches = 0
        rep = CoEmulator(kstep, xstep, rtol=1e-3).verify(
            params, params, batches, group_size=group)
        assert not rep.diverged, rep.summary()
        assert KERNELS["k1"].launches == L * 8
        KERNELS["k1"].launches = 0
        rep = CoEmulator(kstep, kstep).verify(
            inject_fault(params, cfg, 1), params, batches, group_size=group)
        assert (rep.first.step, rep.first.layer) == (0, 1)
        assert KERNELS["k1"].launches == 2 * L * 8


# ------------------------------------------------ ZP-Scope and remat -----
@pytest.mark.parametrize("fuse", [False, True])
def test_scope_rides_the_decode_window_graphs_bitwise(cuda, fuse):
    """serve() with the plane on (its update captured into each window's
    graph with ``fuse``, else run after the replay) equals the plane-off
    run to the bit, every window one replay under sync-debug "error", the
    same K2 launches; each sample's digests equal the host twin of the
    drained tokens."""
    from repro_torch.core.scope import ScopeSpec
    from repro_torch.testing import check_scope_digests, serve_window_digests
    cfg = get_smoke_config("glm4-9b")
    params = build_model(cfg).init(0, device="cuda")
    runs = {}
    for name, spec in (("off", None),
                       ("on", ScopeSpec(every_n_windows=2, fuse=fuse))):
        timer = NoSyncInWindow()
        before = ops.decode_attention.launches
        out = serve(cfg, 2, 16, 11, sample_interval=3, device="cuda",
                    params=params, timer=timer, return_cache=True,
                    scope=spec)
        out["k2"] = ops.decode_attention.launches - before
        assert timer.windows == 4
        assert out["windows_by_engine"] == {"graph": 4, "eager": 0}
        runs[name] = out
    assert_serve_equal(runs["on"], runs["off"], f"scope fuse={fuse}")
    assert runs["on"]["k2"] == runs["off"]["k2"] == cfg.num_layers * 10
    rep = runs["on"]["scope"]
    assert rep["windows"] == 4 and rep["steps"] == 10
    assert check_scope_digests(
        rep, serve_window_digests(runs["on"]["tokens"], 3)) == 2


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_is_bitwise_in_the_train_window_graphs(cuda, arch):
    """run_grouped of each family's smoke config under remat none, dots
    and full (the first window eager, the second a graph replay with the
    recompute inside its backward): states and drained records equal to
    the bit."""
    cfg = get_smoke_config(arch)
    fn = make_batch_fn(cfg, 2, 16, 0)
    batches = [fn(i) for i in range(6)]
    runs = {}
    with deterministic():
        for remat in ("none", "dots", "full"):
            rt = Runtime(attention_impl="xla", taps=TAPS, remat=remat)
            runs[remat] = train_run(cfg, rt, batches, 3)
            assert runs[remat]["windows"] == {"graph": 1, "eager": 1}
    for remat in ("dots", "full"):
        assert_trees_equal(runs["none"]["state"], runs[remat]["state"],
                           f"{arch} state, remat {remat}")
        assert_records_equal(runs["none"]["records"],
                             runs[remat]["records"],
                             f"{arch} records, remat {remat}")


# --------------------------------------------- lanes, the farm, the pools --
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_attention_vmap_rule_is_one_launch_bitwise_per_lane(
        cuda, hd, window):
    """K1's vmap rule: 3 lanes of B=2 fold into one launch over 6 batch
    rows, each lane's output equal to the bit to its solo launch, causal
    and windowed; a CUDA graph of the vmapped call counts one launch a
    replay."""
    check_flash_attention_vmap(3, 2, 160, 4, 2, hd, window=window)


def test_flash_attention_call_leaves_no_reference_cycle(cuda):
    """A K1 call outside vmap frees its inputs by reference counting
    alone: a direct call of a custom op keeps its arguments in a
    reference cycle until the garbage collector runs, so only vmapped
    calls go through ``repro_torch::flash_attention``."""
    import gc
    import weakref
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, 64, 4, 64, generator=g, device="cuda").bfloat16()
    kv = torch.randn(2, 64, 2, 64, generator=g, device="cuda").bfloat16()
    ref = weakref.ref(q)
    gc.collect()
    gc.disable()
    try:
        with torch.inference_mode():
            fa_ops.flash_attention(q, kv, kv)
        del q
        assert ref() is None
    finally:
        gc.enable()


def _vmapped_calls():
    """One call of each kernel without a vmap rule, at a small shape on
    the card, taking lane-batched (L=2) inputs."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    pos = torch.tensor(5, dtype=torch.int32, device=dev)
    A, B_, C_ = -torch.ones(32, 16, device=dev), r(2, 8, 16), r(2, 8, 16)
    h0 = torch.zeros(2, 32, device=dev)
    return {
        "decode_attention": (lambda q, k, v: ops.decode_attention(
            q, k, v, pos=pos, window=64),
            (r(2, 2, 4, 32), r(2, 2, 64, 2, 32), r(2, 2, 64, 2, 32))),
        "ssm_scan": (lambda dt, x: ssm_ops.ssm_scan(dt, A, B_, C_, x),
                     (r(2, 2, 8, 32).abs(), r(2, 2, 8, 32))),
        "rglru_scan": (lambda a, b: lru_ops.rglru_scan(a, b, h0),
                       (r(2, 2, 8, 32).sigmoid(), r(2, 2, 8, 32))),
        "grouped_gemm": (lambda x, w: gg_ops.grouped_gemm(x, w),
                         (r(2, 2, 8, 64, dtype=torch.bfloat16),
                          r(2, 2, 64, 64, dtype=torch.bfloat16))),
    }


@pytest.mark.parametrize("name", ["decode_attention", "ssm_scan",
                                  "rglru_scan", "grouped_gemm"])
def test_kernels_without_a_vmap_rule_raise_under_vmap(cuda, name):
    """K2-K5 have no vmap rule yet: under torch.func.vmap on CUDA tensors
    each raises NotImplementedError naming the slice that adds it, and
    launches nothing (nothing runs the lanes one after another)."""
    fn, args = _vmapped_calls()[name]
    counter = KERNELS[{"decode_attention": "k2", "ssm_scan": "k3",
                       "rglru_scan": "k4", "grouped_gemm": "k5"}[name]]
    before = counter.launches
    with torch.inference_mode(), pytest.raises(NotImplementedError,
                                                match="vmap rule"):
        torch.func.vmap(fn)(*args)
    assert counter.launches == before


FARM_RTOL = 1e-3


def test_lane_batched_smoke_farm_equals_its_solo_run(cuda):
    """verify_subsystems on glm4-9b's smoke config (bf16) on the card,
    solo and lane-batched (one fused run of both layers, K1 through its
    vmap rule), verified at FARM_RTOL (chip_smoke.py's phase-50 rtol,
    50x tighter than verify_subsystems' default): no divergence, and each
    layer's delivered checksums within FARM_RTOL of its solo run's (a
    fan-out that handed one lane another's checksums moves a
    residual-dominated checksum by less than the default); K1 one launch
    a step with lanes, one a step a layer solo; a fault at layer 1 named
    (0, 1) in both modes."""
    from repro_torch.core.coemu import (inject_fault,
                                        submit_subsystem_jobs)
    from repro_torch.farm import FarmManager

    cfg = get_smoke_config("glm4-9b")
    params = build_model(cfg).init(0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn(2, 32, cfg.d_model, generator=g,
                      device="cuda").bfloat16() for _ in range(4)]
    pos = torch.arange(32, dtype=torch.int32,
                       device="cuda")[None].expand(2, 32).contiguous()
    out = {}
    for lanes in (False, True):
        for dut in (None, inject_fault(params, cfg, 1)):
            mgr = FarmManager(slots=2, lanes=2 if lanes else 1,
                              evict_stragglers=False)
            with torch.inference_mode():
                fin = submit_subsystem_jobs(mgr, params, cfg, Runtime(), xs,
                                            pos, [0, 1], rtol=FARM_RTOL,
                                            dut_params=dut, lanes=lanes)
                before = fa_ops.flash_attention.launches
                rep = mgr.run()
                k1 = fa_ops.flash_attention.launches - before
            assert k1 == (4 if lanes else 8), (lanes, k1)
            assert rep["telemetry"]["lanes_per_dispatch_max"] == \
                (2 if lanes else 1)
            reps = fin()
            if dut is None:
                assert not any(r.diverged for r in reps.values())
                out[lanes] = {n: torch.cat([y for _, _, y in o])
                              for n, o in mgr.outputs.items()}
            else:
                assert not reps["layer0"].diverged
                assert (reps["layer1"].first.step,
                        reps["layer1"].first.layer) == (0, 1)
    for n, solo in out[False].items():
        err = ((out[True][n].double() - solo.double()).abs()
               / solo.double().abs()).max()
        assert err <= FARM_RTOL, (n, float(err))


def test_graph_private_pools_do_not_grow_across_serves(cuda):
    """Six graphed smoke serves in one process: every capture runs on the
    card's one capture stream, so cuBLAS keeps one workspace there and
    the bytes allocated in CUDA-graph private pools after each serve stop
    growing after the second (one new stream a capture left one more
    workspace in a pool each time)."""
    cfg = get_smoke_config("glm4-9b")
    params = build_model(cfg).init(0, device="cuda")
    pools = []
    for _ in range(6):
        out = serve(cfg, 2, 16, 8, sample_interval=3, device="cuda",
                    params=params)
        assert out["engine"] == "graph"
        del out
        pools.append(private_pool_bytes())
    assert max(pools[1:]) <= pools[1], pools


# ------------------------------------------- slot threads and their streams --
def _run_threads(targets, timeout=600.0):
    """Run each zero-arg callable on its own thread, all started
    together; re-raise the first exception any of them raised."""
    errors = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
        return run

    threads = [threading.Thread(target=wrap(fn), name=f"t{i}")
               for i, fn in enumerate(targets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "a thread did not finish in time"
    if errors:
        raise errors[0]


def _k1_k2_inputs():
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    fa_in = (rnd(2, 256, 8, 64), rnd(2, 256, 2, 64), rnd(2, 256, 2, 64))
    da_in = (rnd(4, 8, 64), rnd(4, 512, 2, 64), rnd(4, 512, 2, 64),
             torch.tensor(300, dtype=torch.int32, device="cuda"))
    return fa_in, da_in


def test_two_threads_on_two_streams_count_k1_and_k2_exactly(cuda):
    """Two threads, each on a stream of its own, launch K1 and K2 at once,
    50 calls each: every launch counted (the count is taken under a lock),
    and every result equal to the bit to the single-thread run's."""
    from repro_torch.core.graphs import launch_counts

    (q, k, v), (q2, k2, v2, p) = _k1_k2_inputs()

    def call_k1():
        return fa_ops.flash_attention(q, k, v, causal=True)

    def call_k2():
        return ops.decode_attention(q2, k2, v2, pos=p, window=512)

    want = {"k1": call_k1(), "k2": call_k2()}
    torch.cuda.synchronize()
    main = torch.cuda.current_stream()
    barrier = threading.Barrier(2)
    outs = {}

    def worker(key, call):
        def run():
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                stream.wait_stream(main)
                barrier.wait()
                outs[key] = [call() for _ in range(50)]
                stream.synchronize()
        return run

    before = launch_counts()
    _run_threads([worker("k1", call_k1), worker("k2", call_k2)])
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == \
        {"k1": 50, "k2": 50, "k3": 0, "k4": 0, "k5": 0}
    for key, got in outs.items():
        assert all(torch.equal(x, want[key]) for x in got), key


def test_window_graph_captured_on_a_thread_beside_eager_launches(cuda):
    """A WindowGraphs whose eager warm-up window ran on the main thread
    (as the farm's prewarm runs it) is captured, and replayed, on a fresh
    slot thread's stream — whose first cuBLAS product is inside that
    capture — while another thread launches K2 eagerly on its own: the
    capture succeeds (thread-local capture mode, the thread's cuBLAS
    handle made before it), its windows equal the eager engine's to the
    bit, and the counts are exact — the capture takes back only its own
    thread's launches, never the other thread's."""
    from repro_torch.core.graphs import WindowGraphs, launch_counts
    from repro_torch.farm import DeviceSlot, slot_stream

    (q, k, v), (q2, k2, v2, p) = _k1_k2_inputs()
    xs = torch.stack([q * (i + 1) for i in range(3)])
    w = torch.randn(64, 64, device="cuda").bfloat16()

    def engine(state, shell, xs):
        ys = [fa_ops.flash_attention(xs[i], state["k"], state["v"],
                                     causal=True).float().sum()
              + (xs[i][0, 0] @ state["w"]).float().sum()
              for i in range(xs.shape[0])]
        return state, shell, torch.stack(ys)

    state = {"k": k, "v": v, "w": w}
    want = engine(state, {}, xs)[2]
    graphs = WindowGraphs(engine, warmup="eager")
    assert torch.equal(graphs(state, {}, xs)[2], want)    # eager, here
    torch.cuda.synchronize()
    main = torch.cuda.current_stream()
    slot = DeviceSlot("cuda:0#thread-capture", torch.device("cuda"), 0)
    done = threading.Event()
    got, eager = {}, {"n": 0}

    def capture():
        try:
            with torch.cuda.stream(slot_stream(slot)):
                slot_stream(slot).wait_stream(main)
                got["ys"] = [graphs(state, {}, xs)[2].clone()
                             for _ in range(3)]
                slot_stream(slot).synchronize()
        finally:
            done.set()

    def launch():
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            stream.wait_stream(main)
            while not done.is_set() or eager["n"] < 20:
                ops.decode_attention(q2, k2, v2, pos=p, window=512)
                eager["n"] += 1
            stream.synchronize()

    before = launch_counts()
    _run_threads([capture, launch])
    after = launch_counts()
    assert graphs.windows == {"graph": 3, "eager": 1}
    assert after["k1"] - before["k1"] == 3 * xs.shape[0]
    assert after["k2"] - before["k2"] == eager["n"]
    assert all(torch.equal(y, want) for y in got["ys"])


def test_first_use_build_from_two_threads_builds_once(cuda, tmp_path,
                                                      monkeypatch):
    """Two threads load a kernel that is not built yet at the same moment:
    one nvcc build runs, both get the same library, and no temporary file
    is left behind."""
    from repro_torch.kernels import _build

    name = "rglru_scan"
    monkeypatch.setattr(_build, "_BUILD", tmp_path)
    monkeypatch.delitem(_build._loaded, name, raising=False)
    calls = []
    real_build = _build.build

    def counting_build(*names):
        calls.append(names)
        return real_build(*names)

    monkeypatch.setattr(_build, "build", counting_build)
    barrier = threading.Barrier(2)
    libs = []

    def load():
        barrier.wait()
        libs.append(_build.load(name))

    _run_threads([load, load], timeout=900.0)
    assert calls == [(name,)]
    assert len(libs) == 2 and libs[0] is libs[1]
    assert [f.suffix for f in tmp_path.iterdir()] == [".so"]


def test_async_smoke_farm_equals_lockstep_bitwise(cuda):
    """The farm CLI's mixed workload (granite-8b smoke: a train board, a
    graphed decode board, two verify boards) on the card, async (one
    thread and one stream a slot) and lockstep, under deterministic
    mode: the losses, tokens and verify reports equal to the bit."""
    from repro_torch.launch.farm import run_farm

    out = {}
    with deterministic():
        for mode in ("lockstep", "async"):
            out[mode] = run_farm("granite-8b", 8, 4, mode=mode,
                                 device="cuda")
            assert out[mode]["ok"], (out[mode]["jobs"],
                                     out[mode]["telemetry"]["retries"])
    for key in ("train", "decode", "verify"):
        assert out["async"][key] == out["lockstep"][key], key


def test_async_farm_passes_leave_no_bytes_after_the_first(cuda):
    """Ten consecutive async farm passes of glm4-9b's smoke boards (bf16)
    on 8 seats in one process: the seats' threads and streams live for
    the process, so from the second pass on each pass leaves exactly the
    bytes it found (no cuBLAS workspace for a new handle and stream pair)
    and delivers the first pass's checksums."""
    from repro_torch.core.coemu import verify_subsystems
    from repro_torch.farm import FarmManager

    cfg = dataclasses.replace(get_smoke_config("glm4-9b"), dtype="bfloat16")
    params = build_model(cfg).init(0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(2, 16, cfg.d_model, generator=g, device="cuda")
          .to(torch.bfloat16) for _ in range(4)]
    pos = torch.arange(16, dtype=torch.int32, device="cuda")[None] \
        .expand(2, 16).contiguous()
    left, first = [], None
    for _ in range(10):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        mgr = FarmManager(slots=8, mode="async", evict_stragglers=False)
        reps = verify_subsystems(params, cfg, Runtime(), xs, pos,
                                 list(range(cfg.num_layers)), farm=mgr)
        cks = {n: torch.cat([y for _, _, y in o])
               for n, o in mgr.outputs.items()}
        assert not any(r.diverged for r in reps.values())
        del mgr, reps
        torch.cuda.synchronize()
        left.append(torch.cuda.memory_allocated() - before)
        if first is None:
            first = cks
        assert all(torch.equal(cks[n], first[n]) for n in first)
    assert left[1:] == [0] * 9, left


def test_ledger_journals_a_farm_of_card_outputs(cuda, tmp_path):
    """ZP-Ledger on the card: a durable campaign of toy boards whose
    window outputs are CUDA tensors' host copies, cut at its third
    window and recovered from the journal, delivers every window once
    across both lifetimes, equal to an unjournaled run on the card."""
    from repro_torch.farm import FarmLedger, FarmManager
    from repro_torch.launch.farm import _read_window_files, ledger_board_spec

    def campaign(d, ledger):
        mgr = FarmManager(slots=2, mode="async", evict_stragglers=False,
                          poll_s=0.01, ledger=ledger)
        for i in range(2):
            mgr.submit_spec(ledger_board_spec(f"board{i}", float(i + 1), 8,
                                              str(d)))
        return mgr

    off = campaign(tmp_path / "off", None)
    off.run()
    led = FarmLedger(str(tmp_path / "on"))
    mgr = campaign(tmp_path / "on", led)
    for job in mgr.jobs:
        def cut(plan, records, ys, _m=mgr):
            assert ys.device.type == "cpu"      # the window's host copy
            if plan.index >= 3:
                _m.request_shutdown()
        job.verify = cut
    assert mgr.run(strict=False)["interrupted"]
    led.close()
    rec = FarmManager.recover(FarmLedger(str(tmp_path / "on")), slots=2,
                              mode="async", evict_stragglers=False,
                              poll_s=0.01)
    rep = rec.run()
    rec.ledger.close()
    assert any(r["window"] > 0 for r in rep["telemetry"]["recoveries"])
    st = FarmLedger(str(tmp_path / "on")).replay()
    assert {n: (j.status, j.delivered) for n, j in st.jobs.items()} == \
        {"board0": ("done", 8), "board1": ("done", 8)}
    assert _read_window_files(str(tmp_path / "on" / "outputs")) == \
        _read_window_files(str(tmp_path / "off" / "outputs"))


# ------------------------------------------------------------- ZP-Cert --
def _traced_calls(dev):
    """Each wrapper on fake tensors of real CUDA inputs (the certifier's
    trace): (kernel key, call, expected output shapes)."""
    bf = torch.bfloat16

    def t(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev).to(dtype)
    return {
        "k1": (lambda m: fa_ops.flash_attention(
            *(m.from_tensor(x) for x in (t(2, 64, 4, 128, dtype=bf),
                                         t(2, 64, 2, 128, dtype=bf),
                                         t(2, 64, 2, 128, dtype=bf)))),
               [(2, 64, 4, 128)]),
        "k2": (lambda m: ops.decode_attention(
            m.from_tensor(t(2, 32, 128, dtype=bf)),
            m.from_tensor(t(2, 96, 2, 128, dtype=bf)),
            m.from_tensor(t(2, 96, 2, 128, dtype=bf)),
            pos=m.from_tensor(torch.tensor(40, dtype=torch.int32,
                                           device=dev)), window=96),
               [(2, 32, 128)]),
        "k3": (lambda m: ssm_ops.ssm_scan(
            *(m.from_tensor(x) for x in (t(2, 16, 64), t(64, 16),
                                         t(2, 16, 16), t(2, 16, 16),
                                         t(2, 16, 64)))),
               [(2, 16, 64), (2, 64, 16)]),
        "k4": (lambda m: lru_ops.rglru_scan(
            *(m.from_tensor(x) for x in (t(2, 16, 64), t(2, 16, 64),
                                         t(2, 64)))),
               [(2, 16, 64), (2, 64)]),
        "k5": (lambda m: gg_ops.grouped_gemm(
            m.from_tensor(t(4, 8, 64, dtype=bf)),
            m.from_tensor(t(4, 64, 32, dtype=bf))), [(4, 8, 32)]),
    }


@pytest.mark.parametrize("key", ["k1", "k2", "k3", "k4", "k5"])
def test_kernel_traced_branch_launches_nothing(cuda, key):
    """A wrapper handed fakes of real CUDA tensors returns fakes of the
    kernel's shape on the card, launches, builds and allocates nothing,
    and notes the call in the trace tally."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.analysis import no_dispatch_guard
    from repro_torch.kernels import traced_counts

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    call, shapes = _traced_calls(cuda)[key]
    torch.cuda.synchronize()
    before = {k: fn.launches for k, fn in KERNELS.items()}
    traced_counts(reset=True)
    with no_dispatch_guard(), mode:
        out = call(mode)
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(isinstance(o, FakeTensor) and o.device.type == "cuda"
               for o in outs)
    assert traced_counts(reset=True) == {KERNELS[key].__name__: 1}
    assert {k: fn.launches for k, fn in KERNELS.items()} == before


def test_certify_card_boards_trace_only(cuda):
    """The smoke decode board (graphed) and a subsystem board on the card
    certify clean under the no-dispatch guard, listing their K2 and K1
    calls, with the card's allocated bytes and peak unchanged."""
    from repro_torch.analysis import certify_job, job_trees, \
        no_dispatch_guard, warm_fake_device
    from repro_torch.core.coemu import submit_subsystem_jobs
    from repro_torch.farm import FarmManager
    from repro_torch.launch.farm import submit_decode_job

    cfg = get_smoke_config("glm4-9b")
    params = build_model(cfg).init(0, device=cuda)
    mgr = FarmManager(slots=1, device=cuda)
    submit_decode_job(mgr, cfg, gen=9, interval=4, batch=2, prompt_len=8,
                      seed=0, device=cuda, params=params)
    g = torch.Generator(device=cuda).manual_seed(0)
    xs = [torch.randn(2, 16, cfg.d_model, generator=g,
                      device=cuda).bfloat16() for _ in range(2)]
    pos = torch.arange(16, dtype=torch.int32, device=cuda)[None] \
        .expand(2, 16).contiguous()
    with torch.inference_mode():
        submit_subsystem_jobs(mgr, params, cfg, Runtime(), xs, pos, [0],
                              group_size=2)
    trees = [(j, job_trees(j)) for j in mgr.jobs]
    warm_fake_device(cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    with no_dispatch_guard():
        reports = {j.name: certify_job(j, trees=t) for j, t in trees}
    assert (torch.cuda.memory_allocated(),
            torch.cuda.max_memory_allocated()) == mem
    assert all(r.ok for r in reports.values()), \
        {n: r.summary() for n, r in reports.items()}
    assert reports["decode"].kernels == {
        "decode_attention": cfg.num_layers * 4}
    assert reports["layer0"].kernels == {"flash_attention": 2}


# ------------------------------------------------- measured-window roofline --
@pytest.mark.parametrize("graph", [True, False])
def test_roofline_times_each_window_on_the_card(cuda, graph):
    """serve's capture times every decode window with CUDA events around
    its enqueue, graphed (one replay a window) and eager: each window's
    device time above 0 and their sum within the decode's wall; the cost
    is one step counted on fake tensors, scaled to the 7 steps."""
    from repro_torch.roofline import WindowCapture
    from repro_torch.roofline import capture as capture_mod

    made = []
    real = WindowCapture.__init__

    def keep(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self)

    cfg = get_smoke_config("glm4-9b")
    WindowCapture.__init__ = keep
    try:
        out = serve(cfg, batch=2, prompt_len=8, gen=8, sample_interval=3,
                    device=cuda, graph=graph)
    finally:
        WindowCapture.__init__ = real
    assert out["engine"] == ("graph" if graph else "eager")
    (cap,) = made
    assert [r["size"] for r in cap.rows] == [3, 3, 1]
    assert all(r["device_s"] > 0 for r in cap.rows)
    roof = out["roofline"]
    assert roof["windows"] == 3 and roof["steps"] == 7
    assert 0 < roof["device_s"] <= out["decode_s"]
    assert roof["device_s_per_step"] == pytest.approx(roof["device_s"] / 7)
    assert roof["hlo_flops"] > 0 and roof["peak_hbm_fraction"] > 0
    assert capture_mod.HW_H100.name == "h100_sxm5_80gb"


def test_roofline_cost_pass_launches_nothing_on_the_card(cuda):
    """The cost pass over the graphed decode engine on card tensors: no
    launch, build, replay or capture, the card's allocated bytes and
    peak unchanged, the cache untouched; K2's cost is in the count (one
    call a layer of the step) and the step's FLOPs are at least its
    products'."""
    from repro_torch.analysis import no_dispatch_guard, warm_fake_device
    from repro_torch.core.graphs import WindowGraphs
    from repro_torch.core.pshell import shell_init
    from repro_torch.launch.serve import (decode_shell_config,
                                          make_decode_engine)
    from repro_torch.roofline.cost import count_cost
    from repro_torch.serve import make_prefill_step

    cfg = get_smoke_config("glm4-9b")
    model = build_model(cfg)
    with torch.inference_mode():
        params = model.init(0, device=cuda)
        b = {k: torch.from_numpy(v).to(cuda) for k, v in
             make_batch_fn(cfg, 2, 8, 0)(0).items() if k != "labels"}
        cache, logits = make_prefill_step(model, 24)(params, b)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        engine = make_decode_engine(model, params)
        assert isinstance(engine, WindowGraphs)
        sh = shell_init(decode_shell_config(4), cuda)
        before = [t.clone() for t in tree_leaves((cache, tok, sh))
                  if torch.is_tensor(t)]
        warm_fake_device(cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem = (torch.cuda.memory_allocated(),
               torch.cuda.max_memory_allocated())
        with no_dispatch_guard():
            one = count_cost(engine, (cache, tok), sh, np.arange(1))
        assert (torch.cuda.memory_allocated(),
                torch.cuda.max_memory_allocated()) == mem
        assert engine.windows == {"graph": 0, "eager": 0}
        after = [t for t in tree_leaves((cache, tok, sh))
                 if torch.is_tensor(t)]
        assert all(torch.equal(a, b_) for a, b_ in zip(before, after))
    from repro_torch.testing import decode_step_flops
    assert one["flops"] == pytest.approx(decode_step_flops(cfg, 2, 24),
                                         rel=0.02)
    assert one["bytes"] > 0 and one["exps"] == 0
