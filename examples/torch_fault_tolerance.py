"""ZP-Farm fault-tolerance demo on the PyTorch/CUDA port: a training job
is killed mid-run (simulated preemption), a fresh loop resumes from the
last atomic checkpoint, and the deterministic data pipeline replays the
stream so the loss trajectory continues exactly.

  PYTHONPATH=src python examples/torch_fault_tolerance.py
  PYTHONPATH=src python examples/torch_fault_tolerance.py --device cpu
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core import Watchdog
from repro_torch.models import Runtime, build_model
from repro_torch.train import LoopConfig, train_loop


class Preemption(Exception):
    pass


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config("granite-8b")

    def model():
        return build_model(cfg, Runtime(attention_impl="xla",
                                        taps=frozenset({"commits"})))

    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d_ref:
        lc = dict(batch=2, seq=32, checkpoint_every=5, sample_interval=5,
                  checkpoint_dir=d)

        # reference: uninterrupted 15-step run (its own checkpoint dir)
        ref = train_loop(model(), LoopConfig(
            steps=15, **{**lc, "checkpoint_dir": d_ref}), resume=False,
            device=args.device)

        # victim: same run, "preempted" after step 8 (the watchdog would
        # flag the dead worker and the scheduler restart the job)
        class StopAt8:
            n = 0
        try:
            def bomb(step, records):
                StopAt8.n = step
                if step >= 8:
                    raise Preemption()
            train_loop(model(), LoopConfig(steps=15, **lc),
                       on_drain=bomb, resume=False, device=args.device)
        except Preemption:
            print(f"preempted at step {StopAt8.n} "
                  f"(last checkpoint: step 5)")

        wd = Watchdog(timeout_s=0.0)
        wd.heartbeat("victim")
        assert wd.should_restart()        # the farm notices

        # restart: a fresh loop restores the step-5 checkpoint, replays
        # 5..14
        resumed = train_loop(model(), LoopConfig(steps=15, **lc),
                             resume=True, device=args.device)
        tail = ref["losses"][5:]
        np.testing.assert_allclose(resumed["losses"], tail,
                                   rtol=1e-5, atol=1e-5)
        print(f"resumed {len(resumed['losses'])} steps; trajectory matches "
              f"the uninterrupted run exactly "
              f"(final loss {resumed['losses'][-1]:.4f} == "
              f"{tail[-1]:.4f})")


if __name__ == "__main__":
    main()
