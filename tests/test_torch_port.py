"""Boundaries of the port: it imports neither jax nor the JAX package, its
entry points refuse to run without a card unless asked for the CPU, its
configs and prompts equal the reference's, and its CLI reaches the full
config."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(Path(repro_torch.__file__).parent.rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_import_guard_covers_every_module_of_the_port():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("kernels/flash_attention/ops.py",
                "kernels/flash_attention/ref.py", "models/runtime.py",
                "core/commit.py", "core/coverage.py", "core/decompose.py",
                "kernels/decode_attention/ops.py", "testing.py",
                "kernels/ssm_scan/ops.py", "kernels/ssm_scan/ref.py",
                "models/ssm.py", "configs/falcon_mamba_7b.py",
                "kernels/rglru_scan/ops.py", "kernels/rglru_scan/ref.py",
                "models/recurrent.py", "configs/recurrentgemma_2b.py",
                "kernels/grouped_gemm/ops.py", "kernels/grouped_gemm/ref.py",
                "models/moe.py", "configs/qwen3_moe_30b_a3b.py",
                "configs/mixtral_8x7b.py", "models/encdec.py",
                "configs/internlm2_20b.py", "configs/command_r_35b.py",
                "configs/whisper_small.py", "configs/internvl2_1b.py",
                "farm/manager.py", "farm/placement.py", "farm/telemetry.py",
                "analysis/annotations.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("glm4-9b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(cfg, 1, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError):
        build_model(cfg).init(0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_forward_raises_without_a_card_unless_given_host_tensors(
        monkeypatch):
    """Model.logits / Model.loss run where the tensors are: host tensors on
    the host; numpy batches go to the card, so without one they raise."""
    from repro_torch.models import Runtime, build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("glm4-9b")
    model = build_model(cfg, Runtime(taps=frozenset({"commits"})))
    params = model.init(0, device="cpu")
    batch = make_batch_fn(cfg, 1, 8)(0)
    for fn in (model.logits, model.loss):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(params, batch)
    host = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        logits, aux = model.logits(params, host)
        loss, (metrics, _) = model.loss(params, host)
    assert logits.shape == (1, 8, cfg.vocab_size) and logits.device.type \
        == "cpu"
    assert aux["scanned"][0]["checksum"].shape == (cfg.num_layers, 2)
    assert torch.isfinite(loss) and set(metrics) == {"loss", "ce",
                                                     "moe_aux"}
    with pytest.raises(ValueError, match="params on"):
        model.logits(params, {k: v.to("meta") for k, v in host.items()})


def test_registry_ports_two_archs_and_names_the_rest():
    """All ten archs of the reference, in its order; the full configs'
    shapes and parameter counts; an unknown name raises."""
    assert tconfigs.ARCH_IDS == (
        "qwen3-moe-30b-a3b", "mixtral-8x7b", "internlm2-20b", "glm4-9b",
        "command-r-35b", "granite-8b", "whisper-small", "recurrentgemma-2b",
        "internvl2-1b", "falcon-mamba-7b")
    full = tconfigs.get_config("glm4-9b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.vocab_size) == (40, 4096, 32, 2, 128, 151552)
    ssm = tconfigs.get_config("falcon-mamba-7b")
    assert (ssm.family, ssm.num_layers, ssm.d_model, ssm.d_inner,
            ssm.ssm_state, ssm.dt_rank, ssm.conv_width, ssm.vocab_size,
            ssm.dtype, ssm.tie_embeddings, ssm.layer_pattern) == (
        "ssm", 64, 4096, 8192, 16, 256, 4, 65024, "bfloat16", False,
        (("mamba", None),))
    assert ssm.param_count() == 7_271_616_512
    hyb = tconfigs.get_config("recurrentgemma-2b")
    assert (hyb.family, hyb.num_layers, hyb.d_model, hyb.lru_width,
            hyb.num_heads, hyb.num_kv_heads, hyb.head_dim, hyb.d_ff,
            hyb.vocab_size, hyb.window, hyb.dtype, hyb.tie_embeddings,
            hyb.layer_pattern) == (
        "hybrid", 26, 2560, 2560, 10, 1, 256, 7680, 256000, 2048,
        "bfloat16", True,
        (("rglru", "mlp"), ("rglru", "mlp"), ("local", "mlp")))
    assert hyb.param_count() == 2_894_528_000
    moe = tconfigs.get_config("qwen3-moe-30b-a3b")
    assert (moe.family, moe.num_layers, moe.d_model, moe.num_heads,
            moe.num_kv_heads, moe.head_dim, moe.use_qk_norm, moe.num_experts,
            moe.num_experts_per_tok, moe.moe_d_ff, moe.vocab_size,
            moe.tie_embeddings, moe.layer_pattern) == (
        "moe", 48, 2048, 32, 4, 128, True, 128, 8, 768, 151936, False,
        (("attn", "moe"),))
    assert moe.param_count() == 30_532_110_336
    mix = tconfigs.get_config("mixtral-8x7b")
    assert (mix.num_layers, mix.num_experts, mix.num_experts_per_tok,
            mix.moe_d_ff, mix.window, mix.layer_pattern) == (
        32, 8, 2, 14336, 4096, (("swa", "moe"),))
    assert mix.param_count() == 46_702_792_704
    lm2 = tconfigs.get_config("internlm2-20b")
    assert (lm2.family, lm2.num_layers, lm2.d_model, lm2.num_heads,
            lm2.num_kv_heads, lm2.head_dim, lm2.d_ff, lm2.vocab_size,
            lm2.tie_embeddings) == (
        "dense", 48, 6144, 48, 8, 128, 16384, 92544, False)
    assert lm2.param_count() == 19_861_149_696
    cmr = tconfigs.get_config("command-r-35b")
    assert (cmr.family, cmr.num_layers, cmr.d_model, cmr.num_heads,
            cmr.num_kv_heads, cmr.head_dim, cmr.d_ff, cmr.vocab_size,
            cmr.tie_embeddings, cmr.rope_theta) == (
        "dense", 40, 8192, 64, 8, 128, 22528, 256000, True, 8e6)
    assert cmr.param_count() == 30_283_538_432
    wsp = tconfigs.get_config("whisper-small")
    assert (wsp.family, wsp.num_layers, wsp.encoder_layers,
            wsp.encoder_seq, wsp.d_model, wsp.num_heads, wsp.num_kv_heads,
            wsp.head_dim, wsp.d_ff, wsp.vocab_size, wsp.use_rope,
            wsp.learned_pos, wsp.use_bias, wsp.tie_embeddings) == (
        "encdec", 12, 12, 1500, 768, 12, 12, 64, 3072, 51865, False, True,
        True, True)
    assert wsp.param_count() == 319_848_960
    vl = tconfigs.get_config("internvl2-1b")
    assert (vl.family, vl.num_layers, vl.d_model, vl.num_heads,
            vl.num_kv_heads, vl.head_dim, vl.d_ff, vl.vocab_size,
            vl.num_patches, vl.patch_embed_dim) == (
        "vlm", 24, 896, 14, 2, 64, 4864, 151655, 256, 1024)
    assert vl.param_count() == 630_553_728
    for arch in tconfigs.ARCH_IDS:
        assert tconfigs.get_smoke_config(arch).family \
            == tconfigs.get_config(arch).family
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_smoke_config("gpt-2")
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_config("whisper-large")


@pytest.mark.parametrize("arch", list(tconfigs.ARCH_IDS))
def test_configs_and_prompts_equal_the_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import get_config, get_smoke_config
    from repro.data.pipeline import make_batch_fn as jax_batch_fn
    for mine, ref in ((tconfigs.get_config(arch), get_config(arch)),
                      (tconfigs.get_smoke_config(arch),
                       get_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
    cfg = tconfigs.get_config(arch)
    # a VLM's sequence holds its patch prefix
    seq = 64 + (cfg.num_patches if cfg.family == "vlm" else 0)
    for step in (0, 3):
        a = make_batch_fn(cfg, 4, seq, seed=7)(step)
        b = jax_batch_fn(get_config(arch), 4, seq, seed=7)(step)
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k])


def test_cli_reaches_the_full_config(monkeypatch, capsys):
    seen = {}

    def fake_serve(cfg, *a, **kw):
        seen["cfg"] = cfg
        return {"ok": True}

    monkeypatch.setattr(tserve, "serve", fake_serve)
    tserve.main(["--no-smoke", "--device", "cpu"])
    assert seen["cfg"].name == "glm4-9b" and seen["cfg"].num_layers == 40
    tserve.main(["--arch", "granite-8b", "--device", "cpu"])
    assert seen["cfg"].name == "granite-smoke"
    tserve.main(["--arch", "falcon-mamba-7b", "--no-smoke", "--device",
                 "cpu"])
    assert seen["cfg"].name == "falcon-mamba-7b" \
        and seen["cfg"].num_layers == 64
    tserve.main(["--arch", "recurrentgemma-2b", "--no-smoke", "--device",
                 "cpu"])
    assert seen["cfg"].name == "recurrentgemma-2b" \
        and seen["cfg"].num_layers == 26
    tserve.main(["--arch", "qwen3-moe-30b-a3b", "--no-smoke", "--device",
                 "cpu"])
    assert seen["cfg"].name == "qwen3-moe-30b-a3b" \
        and seen["cfg"].num_layers == 48
    tserve.main(["--arch", "mixtral-8x7b", "--device", "cpu"])
    assert seen["cfg"].name == "mixtral-smoke"
    for arch, layers in (("internlm2-20b", 48), ("command-r-35b", 40),
                         ("whisper-small", 12), ("internvl2-1b", 24)):
        tserve.main(["--arch", arch, "--no-smoke", "--device", "cpu"])
        assert seen["cfg"].name == arch \
            and seen["cfg"].num_layers == layers
        tserve.main(["--arch", arch, "--device", "cpu"])
        assert seen["cfg"] == tconfigs.get_smoke_config(arch)
    assert '"ok": true' in capsys.readouterr().out
    from repro_torch.launch import train as ttrain
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "gpt-2"])


def test_unported_families_raise_naming_the_later_slice():
    """Every family of the registry builds, the enc-dec and VLM trees
    included; an unknown family or block spec still raises."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as ttfm
    cfg = tconfigs.get_smoke_config("glm4-9b")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="diffusion"))
    for spec in (("attn", "ffn2"), ("cross", "mlp")):
        with pytest.raises(ValueError, match="unknown"):
            ttfm.init_block(None, cfg, spec, "meta")
    wsp = tconfigs.get_smoke_config("whisper-small")
    tree = build_model(wsp).init(device="meta")
    assert set(tree) == {"embed", "enc_pos", "encoder", "enc_norm",
                         "decoder", "final_norm"}
    assert set(tree["decoder"]) == {"norm1", "self", "norm_x", "cross",
                                    "norm2", "mlp"}
    assert tree["decoder"]["cross"]["q"]["w"].shape == (
        wsp.num_layers, wsp.d_model, wsp.num_heads * wsp.head_dim)
    assert tree["encoder"]["attn"]["k"]["b"].shape == (
        wsp.encoder_layers, wsp.num_kv_heads * wsp.head_dim)
    assert tree["embed"]["pos"].shape == (wsp.max_position, wsp.d_model)
    vlm = tconfigs.get_smoke_config("internvl2-1b")
    tree = build_model(vlm).init(device="meta")
    assert tree["patch_proj"]["w"].shape == (vlm.patch_embed_dim,
                                             vlm.d_model)
    qk = dataclasses.replace(wsp, use_qk_norm=True)
    from repro_torch.models import attention as tattn
    assert "q_norm" in tattn.init_attention(None, qk, "meta")
    assert "q_norm" not in tattn.init_attention(None, qk, "meta",
                                                cross=True)
    moe = tconfigs.get_smoke_config("qwen3-moe-30b-a3b")
    build_model(moe)
    block = ttfm.init_block(None, moe, ("attn", "moe"), "meta")
    assert set(block) == {"norm1", "attn", "norm2", "moe"}
    assert block["moe"]["router"]["w"].dtype == torch.float32
    ssm = tconfigs.get_smoke_config("falcon-mamba-7b")
    build_model(ssm)
    block = ttfm.init_block(None, ssm, ("mamba", None), "meta")
    assert set(block) == {"norm1", "mamba"}
    hyb = tconfigs.get_smoke_config("recurrentgemma-2b")
    build_model(hyb)
    block = ttfm.init_block(None, hyb, ("rglru", "mlp"), "meta")
    assert set(block) == {"norm1", "rglru", "norm2", "mlp"}
    assert block["rglru"]["Lambda"].dtype == torch.float32
