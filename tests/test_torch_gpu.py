"""Card-only tests of the port: the CUDA flash-attention (K1),
decode-attention (K2), selective-scan (K3), RG-LRU scan (K4) and grouped
expert GEMM (K5) kernels against their plain versions on the card, and
the serve slice and the commit-tapped forward with its Scale-Down replay
on the card against the same on the host. They skip where CUDA is absent.
On a machine with an NVIDIA card:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Kernel tolerances are those of tests/test_kernels.py, f32 2e-5 and bf16
2e-2 for K1, K2 and K5, and in bf16 also a normwise relative error (6e-3
for K1 and K2, 2e-3 for K5); K3 at 1e-4 and K4 at 1e-5 in f32
(test_ssm_scan's and test_rglru_scan's), every output alike; the composed
expert FFN at 1e-4 in f32 (test_moe_ffn_composed's); the forward holds
the loss and checksums within 1e-5 (``repro_torch.testing``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as gg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.testing import (NoSyncInWindow,  # noqa: E402
                                 check_decode_attention,
                                 check_decode_determinism,
                                 check_flash_attention,
                                 check_forward_parity, check_grouped_gemm,
                                 check_moe_ffn, check_rglru_scan,
                                 check_ssm_scan, layer_kernels,
                                 serve_kernels, tally)
from repro_torch.utils import tree_map  # noqa: E402

pytestmark = pytest.mark.gpu
ARCHS = ["glm4-9b", "granite-8b", "falcon-mamba-7b", "recurrentgemma-2b",
         "qwen3-moe-30b-a3b", "mixtral-8x7b"]
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


@pytest.mark.parametrize("arch", ARCHS)
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
                                      (128, 16, 16, 130), (32, 6, 3, 300)])
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
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 8, 10, 16])
def test_decode_split_at_every_group_and_head_dim(cuda, G, hd, dtype):
    """G query heads per kv head (1, 8, 10, 16) at every head_dim, two
    kv heads, a 1000-slot ring at pos 517 and wrapped at 1400."""
    for pos in (517, 1400):
        _check(2, 2 * G, 2, 1000, hd, pos, dtype)


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
@pytest.mark.parametrize("B,S,W", [(2, 64, 32), (1, 96, 64)])
def test_rglru_kernel_matches_plain_on_the_reference_grid(cuda, B, S, W):
    check_rglru_scan(B, S, W)


@pytest.mark.parametrize("B,S,W,split", [(1, 40, 16, 17), (2, 300, 96, 64),
                                         (2, 4096, 2560, 1000)])
def test_rglru_kernel_chaining_property(cuda, B, S, W, split):
    """Two launches, the second from the first's h_last, equal one."""
    check_rglru_scan(B, S, W, split=split)


@pytest.mark.parametrize("B,S,W", [(2, 4000, 2600), (3, 9, 33), (1, 1, 5),
                                   (2, 65, 40)])
def test_rglru_kernel_ragged(cuda, B, S, W):
    """S not a multiple of the kernel's 64 steps in flight, W not a
    multiple of its 32 channels a block."""
    check_rglru_scan(B, S, W)


@pytest.mark.parametrize("B,S", [(2, 4096), (8, 2048)],
                         ids=["forward", "prefill"])
def test_rglru_kernel_at_the_slice_shapes(cuda, B, S):
    """recurrentgemma-2b's forward (B=2, S=4096) and serve prefill (B=8,
    S=2048), W=2560."""
    check_rglru_scan(B, S, 2560)


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


def test_rglru_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="want h0"):
        lru_ops.rglru_scan(a, a, torch.zeros(1, 4, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        lru_ops.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2),
                           a, torch.zeros(1, 8, device=cuda))


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
