"""The port's examples (``examples/torch_*.py``) at their smallest preset
on the CPU: each exits 0 and prints what it reports; ``torch_train_e2e.py``
over 2 gloo ranks. ~25 s."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

RUNS = {
    "torch_quickstart.py": (["--preset", "tiny"], "generated token ids:"),
    "torch_serve_batched.py": (["--preset", "tiny"], "req[1]:"),
    "torch_train_e2e.py": (["--preset", "1m", "--steps", "4", "--ranks", "2"], "done: 4 steps"),
    "torch_transfer_optimizer.py": (["--preset", "tiny", "--engine"], "integrity: OK"),
}


def test_every_port_example_is_run_here():
    assert sorted(p.name for p in (ROOT / "examples").glob("torch_*.py")) == sorted(RUNS)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_at_its_smallest_preset_on_the_cpu(name, tmp_path):
    args, marker = RUNS[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name), *args, "--device", "cpu"],
                         cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert marker in out.stdout, out.stdout


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_asks_for_the_card_by_default(name, tmp_path):
    """Without ``--device`` an example runs on the card: with no card
    visible it fails with the port's error instead of falling back."""
    args, _ = RUNS[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name), *args],
                         cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr, out.stderr
