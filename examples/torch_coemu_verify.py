"""Co-emulation case study on the PyTorch/CUDA port: verify an optimised
DUT (the bf16 train step with remat "dots") against the f32 golden model
through the commit stream, then inject a fault and watch the verifier
localise it to the exact layer.

  PYTHONPATH=src python examples/torch_coemu_verify.py [--steps 4]
  PYTHONPATH=src python examples/torch_coemu_verify.py --device cpu \\
      --steps 2
"""
import argparse
import dataclasses

from repro_torch.configs import get_smoke_config
from repro_torch.core import CoEmulator
from repro_torch.core.coemu import inject_fault
from repro_torch.data import make_batch_fn
from repro_torch.models import Runtime, build_model
from repro_torch.train import init_state, make_train_step
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4,
                    help="verification step budget (the CPU smoke uses 2)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("glm4-9b")
    taps = frozenset({"commits"})
    dut_model = build_model(cfg, Runtime(attention_impl="xla", taps=taps,
                                         remat="dots"))
    orc_model = build_model(dataclasses.replace(cfg, dtype="float32"),
                            Runtime(attention_impl="xla", taps=taps))
    dut = make_train_step(dut_model)
    orc = make_train_step(orc_model)
    s_dut = init_state(dut_model, 0, device=device)
    s_orc = init_state(orc_model, 0, device=device)
    batchf = make_batch_fn(cfg, 2, 32)
    batches = [batchf(i) for i in range(args.steps)]

    emu = CoEmulator(dut, orc, rtol=0.3)
    print("clean run:", emu.verify(s_dut, s_orc, batches).summary())
    if len(batches) > 1:
        rep = emu.verify(s_dut, s_orc, batches,
                         group_size=max(2, len(batches) // 2))
        print("group-locked (scheduler-overlapped):", rep.summary())
    print("determinism:",
          CoEmulator.determinism(dut, s_dut, batches[0]))

    # fault localization: verify the faulted DUT against the CLEAN DUT so
    # the commit stream carries pure fault signal (the bf16-vs-f32 oracle
    # gap sits near rtol and would blur the margin)
    emu_fault = CoEmulator(dut, dut, rtol=5e-2)
    for layer in (0, 1):
        s_bad = {**s_dut, "params": inject_fault(s_dut["params"], cfg, layer)}
        rep = emu_fault.verify(s_bad, s_dut, batches[:1])
        print(f"fault@layer{layer}:", rep.summary())
        assert rep.diverged and rep.first.layer == layer


if __name__ == "__main__":
    main()
