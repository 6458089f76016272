"""Boundary of the PyTorch port: it imports neither JAX nor the JAX
package, it shares no class with it, and its entry points run on the card
unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
print(" ".join(names))
"""

#: modules the shared-fabric slice added; the guarded import must reach each
SHARED_FABRIC_MODULES = (
    "repro_torch.eval.fabric.shared",
    "repro_torch.eval.fabric.coupled_event",
    "repro_torch.eval.tune.contention",
)
#: modules the chunk-executor slice added
EXECUTOR_MODULES = (
    "repro_torch.eval.fabric.stats",
    "repro_torch.eval.fabric.executor",
)
#: modules of the training path on one device
TRAINING_MODULES = (
    "repro_torch.data.synthetic",
    "repro_torch.optim.adamw",
    "repro_torch.kernels.backward",
    "repro_torch.train.train_step",
)
#: modules of checkpointing and the training loop: the transfer engine,
#: the checkpoint, the data pipeline, fault tolerance and the loop
CHECKPOINT_MODULES = (
    "repro_torch.core.engine",
    "repro_torch.checkpoint.ckpt",
    "repro_torch.data.pipeline",
    "repro_torch.distributed.fault",
    "repro_torch.train.loop",
)
#: modules of the gradient sync between ranks
DISTRIBUTED_MODULES = (
    "repro_torch.distributed.compression",
    "repro_torch.distributed.grad_sync",
    "repro_torch.distributed.pods",
)


def _port_sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _GUARDED_IMPORT], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20  # every module of the port imported
    assert set(SHARED_FABRIC_MODULES) <= names
    assert set(EXECUTOR_MODULES) <= names
    assert set(TRAINING_MODULES) <= names
    assert set(CHECKPOINT_MODULES) <= names
    assert set(DISTRIBUTED_MODULES) <= names


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


def test_tune_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The searchers, ``run_built`` / ``run_simulations`` on the batched
    backend and the ``--tune`` CLI raise without a card; ``device="cpu"``
    runs them on the plain versions, and the event backend needs none."""
    from repro_torch.eval import runner, tune
    from repro_torch.eval.scenarios import build_simulation, smoke_matrix

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scs = smoke_matrix()[:1]
    for search in (tune.oracle_search, tune.successive_halving, tune.hill_climb):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            search(scs, n_candidates=4)
        assert search(scs, n_candidates=4, device="cpu").evals > 0
        assert search(scs, n_candidates=4, backend="event").evals > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_built([lambda: build_simulation(scs[0])], [scs[0].name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_simulations([build_simulation(scs[0])])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(["--tune", "oracle", "--matrix", "smoke", "--candidates", "4"])
    assert len(runner.run_simulations([build_simulation(scs[0])], device="cpu")) == 1


def test_shared_fabric_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The tenant difftest and the contention report raise without a
    card; the coupled event leg runs on the host and needs none."""
    from repro_torch.eval import difftest
    from repro_torch.eval.runner import run_matrix
    from repro_torch.eval.scenarios import tenant_matrix
    from repro_torch.eval.tune import contention_report

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scs = tenant_matrix(n_groups=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        difftest.main(["--matrix", "tenant-smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_matrix(scs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        contention_report(scs, n_candidates=2)
    assert len(run_matrix(scs, backend="event")) == len(scs)


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


def test_train_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Training runs on the model's device: a model built without a device
    asks for the card and raises without one; a CPU model trains on the
    CPU, its batches moved there, and launches no kernel."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.config import reduce_for_smoke
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import StepConfig, init_train_state, make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduce_for_smoke(get_config("gemma3-1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model)
    before = fa.flash_attention.launches
    batch = next(SyntheticLM(cfg, DataConfig(global_batch=2, seq_len=8)).batches())
    state, metrics = make_train_step(model, StepConfig())(state, batch)
    assert all(m.device.type == "cpu" for m in metrics.values())
    assert all(p.device.type == "cpu" for p in state["params"].values())
    assert fa.flash_attention.launches == before


def test_pods_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """A rank asks for the card and raises without one; the backend rule:
    NCCL only when every rank has a card of its own, gloo on the CPU or
    when ranks share a card."""
    from repro_torch.distributed import pods

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pods.init_pods(0, 2, init_method="file:///nonexistent/store")
    assert pods.pod_device(1, 2, "cpu") == torch.device("cpu")
    assert pods.pick_backend(torch.device("cpu"), 0, 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pods.pick_backend(torch.device("cuda", 0), 1, 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pods.pick_backend(torch.device("cuda", 1), 1, 2) == "nccl"
    assert pods.pick_backend(torch.device("cuda", 0), 1, 2) == "gloo"  # shares card 0
    assert pods.group_size(None) == 1
    rows = pods.local_rows({"tokens": np.arange(12).reshape(4, 3)}, 1, 2)
    np.testing.assert_array_equal(rows["tokens"], np.arange(6, 12).reshape(2, 3))
    with pytest.raises(ValueError, match="do not split"):
        pods.local_rows({"tokens": np.zeros((3, 2))}, 0, 2)
