"""Boundary of the PyTorch port: it imports neither JAX nor the JAX
package, it shares no class with it, and its entry points run on the card
unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_GUARDED_IMPORT = r"""
import importlib, pkgutil, sys

sys.modules["jax"] = None

class RefuseReference:
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, RefuseReference())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [
    m for m, mod in sys.modules.items()
    if mod is not None and (m == "repro" or m.startswith("repro.") or m.startswith("jax"))
]
assert not bad, bad
print(len(names))
"""


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _GUARDED_IMPORT], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the port imported


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_driver_shares_no_class_with_the_reference():
    from repro_torch.eval.fabric.driver import TorchFabricSimulation

    assert TorchFabricSimulation.__mro__ == (TorchFabricSimulation, object)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.eval.fabric.driver import TorchFabricSimulation
    from repro_torch.eval.fabric.plan import build_plan
    from repro_torch.eval.runner import run_matrix
    from repro_torch.eval.scenarios import smoke_matrix

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scs = smoke_matrix()[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_matrix(scs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchFabricSimulation(build_plan(scs))
    res = run_matrix(scs, device="cpu")
    assert len(res) == 2 and all(r.total_time > 0 for r in res)


def test_difftest_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The difftest's CLI and its sweep legs raise without a card; the
    event leg runs on the host and needs none."""
    from repro_torch.eval import difftest
    from repro_torch.eval.runner import run_matrix, run_scenario
    from repro_torch.eval.scenarios import smoke_matrix

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scs = smoke_matrix()[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        difftest.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        difftest.main(["--smoke", "--device", "cuda", "--route", "all"])
    for leg in difftest.SWEEP_LEGS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            difftest.run_leg(scs, leg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(scs[0], backend="batch")
    assert len(run_matrix(scs, backend="event")) == 2
    assert difftest.main(["--smoke", "--device", "cpu", "--sample", "3"]) == 0


def test_model_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduce_for_smoke
    from repro_torch.models.model import build_model
    from repro_torch.train.serve_step import generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_config("rwkv6-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    out = generate(model, torch.zeros((2, 3), dtype=torch.int64), 4)
    assert out.shape == (2, 4) and out.device.type == "cpu"
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_hybrid_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models.config import reduce_for_smoke
    from repro_torch.models.model import HybridLM, build_model
    from repro_torch.train.serve_step import generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_config("recurrentgemma-9b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("recurrentgemma-9b")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert isinstance(model, HybridLM)
    out = generate(model, torch.zeros((2, 3), dtype=torch.int64), 4)
    assert out.shape == (2, 4) and out.device.type == "cpu"


def test_dense_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The dense ``build_model`` raises without a card unless given the CPU;
    the flash wrapper takes its plain version only for CPU tensors and
    raises for any other device but CUDA."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.config import reduce_for_smoke
    from repro_torch.models.model import LM, build_model
    from repro_torch.train.serve_step import generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_config("gemma3-1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("gemma3-1b")
    model = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert isinstance(model, LM)
    before = fa.flash_attention.launches
    out = generate(model, torch.zeros((2, 3), dtype=torch.int64), 4)
    assert out.shape == (2, 4) and out.device.type == "cpu"
    assert fa.flash_attention.launches == before
    q = torch.zeros((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)
