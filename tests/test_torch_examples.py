"""The port's entry points on the CPU: the train CLI
(``repro_torch.launch.train``) and the five ``examples/torch_*.py``, each
at its smallest budget with ``--device cpu``, as CI runs the reference's
examples. Each example runs in a subprocess that must exit 0; without
``--device cpu`` and without a card the entry points raise rather than
fall back to the host.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as train_cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "torch_quickstart.py": ["--steps", "4"],
    "torch_coemu_verify.py": ["--steps", "2"],
    "torch_train_e2e.py": ["--steps", "2"],
    "torch_fault_tolerance.py": [],
    "torch_scale_down_extraction.py": [],
}
# what each example prints when it has run to its end
LAST_WORDS = {
    "torch_quickstart.py": "generated:",
    "torch_coemu_verify.py": "fault@layer1: FAIL: first divergence at "
                             "step 0 layer 1",
    "torch_train_e2e.py": '"coverage"',
    "torch_fault_tolerance.py": "trajectory matches the uninterrupted run",
    "torch_scale_down_extraction.py": "scan-vs-composed rel diff: 0.00e+00",
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_host(name, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "TMPDIR": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *EXAMPLES[name]], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert LAST_WORDS[name] in proc.stdout, proc.stdout[-4000:]


def test_train_cli_prints_its_keys(capsys):
    train_cli.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                    "--seq", "16", "--sample-interval", "2", "--scope", "1"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"arch", "loss_first", "loss_last", "coverage",
                        "profile_s", "roofline", "scope"}
    assert out["roofline"]["windows"] == 2 and out["roofline"]["steps"] == 4
    assert out["roofline"]["scope"]["steps"] == 4
    assert out["arch"] == "granite-smoke"
    assert out["scope"]["steps"] == 4 and out["scope"]["windows"] == 2
    assert "scope_gates" in out["coverage"]["per_map"]


def test_train_cli_refuses_save_measured_and_a_missing_card(
        monkeypatch, tmp_path, capsys):
    """``--save-measured`` (refused until the roofline slice) writes the
    run's measured-window record; without a card the CLI still raises."""
    monkeypatch.chdir(tmp_path)
    train_cli.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                    "--seq", "16", "--save-measured"])
    out = json.loads(capsys.readouterr().out)
    saved = json.loads((tmp_path / "experiments" / "measured"
                        / "granite-smoke_train.json").read_text())
    assert saved["arch"] == "granite-smoke" and saved["source"] == "train"
    assert saved["steps"] == out["roofline"]["steps"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--steps", "1"])
