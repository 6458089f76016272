"""The port's fault-tolerant training loop (``repro_torch.train.loop``) and
its fault-tolerance helpers (``repro_torch.distributed.fault``) on the
CPU: the reference's loop tests (``tests/test_train_and_ckpt.py``: the
loss falls, a crash at step 25 and a resume end bit for bit where a
straight 30-step run ends, the supervisor restarts until success), the
port's loop against the reference's loop from the same init tree, and the
fault helpers against the reference's on the cases of
``tests/test_distributed.py``. ~25 s."""
from __future__ import annotations

import os

import jax
import numpy as np
import pytest

from repro.checkpoint import ckpt as ref_ckpt
from repro.distributed import fault as ref_fault
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.train.loop import LoopConfig as RefLoopConfig
from repro.train.loop import train as ref_train
from repro.train.train_step import StepConfig as RefStepConfig
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.distributed import fault
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import loop
from repro_torch.train.loop import LoopConfig, train, train_with_restarts
from repro_torch.train.train_step import StepConfig, state_tree, train_state
from test_torch_ckpt import assert_trees_equal
from test_torch_train_step import OPT, STEP_LOSS_ATOL, setup


def _setup(arch="llama3.2-3b", batch=4, seq=32):
    """The reference loop test's model, data and optimizer
    (``tests/test_train_and_ckpt._setup``)."""
    cfg = reduce_for_smoke(get_config(arch))
    data = SyntheticLM(cfg, DataConfig(global_batch=batch, seq_len=seq))
    scfg = StepConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                                            weight_decay=0.0))
    return cfg, data, scfg


def _model(cfg):
    return build_model(cfg, device="cpu")


def test_loss_decreases():
    cfg, data, scfg = _setup()
    res = train(_model(cfg), scfg, data.batches(), LoopConfig(total_steps=40, log_every=5))
    hist = res["history"]
    assert [h["step"] for h in hist] == list(range(5, 41, 5))
    first = np.mean([h["loss"] for h in hist[:2]])
    last = np.mean([h["loss"] for h in hist[-2:]])
    assert last < first * 0.9, f"loss did not decrease: {first} -> {last}"
    assert int(res["state"]["step"]) == 40
    assert res["stragglers"].hosts["host0"].n == 40


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_crash_resume_bit_exact(tmp_path, async_ckpt):
    """Train 30 steps straight against crash-at-25-and-resume (checkpoints
    every 10 steps, the batches through a prefetcher): every leaf of the
    final state (parameters, both moments, count, step) and the losses of
    the resumed steps bit for bit; the committed steps on disk those the
    reference's loop writes."""
    cfg, data, scfg = _setup()
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    lc = dict(total_steps=30, ckpt_every=10, async_ckpt=async_ckpt, log_every=1)

    straight_model = _model(cfg)
    straight = train(straight_model, scfg, Prefetcher(data.batches()),
                     LoopConfig(ckpt_dir=d1, **lc))
    with pytest.raises(RuntimeError, match="injected crash at step 25"):
        train(_model(cfg), scfg, Prefetcher(data.batches()), LoopConfig(ckpt_dir=d2, **lc),
              crash_at=25)
    assert sorted(os.listdir(d2)) == ["step_00000010", "step_00000020"]
    resumed_model = _model(cfg)
    reports = []
    resumed = train(resumed_model, scfg, Prefetcher(data.batches()),
                    LoopConfig(ckpt_dir=d2, **lc), on_checkpoint=reports.append)
    # step 30 is saved twice, as the reference's loop does when total_steps
    # is a multiple of ckpt_every: the periodic save, then the final one
    assert [(r.kind, r.step) for r in reports] == [("restore", 20), ("save", 30), ("save", 30)]
    assert [h["step"] for h in resumed["history"]] == list(range(21, 31))
    for a, b in zip(straight["history"][20:], resumed["history"]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"], a["step"]
    assert_trees_equal(state_tree(resumed_model, resumed["state"]),
                       state_tree(straight_model, straight["state"]))
    # the reference's loop: ckpt_every 10 of 30 steps, keep 3, and the final save
    for d in (d1, d2):
        assert sorted(ckpt._committed_steps(d)) == [10, 20, 30]


def test_supervisor_restarts_until_success(tmp_path):
    cfg, data, scfg = _setup()
    d = str(tmp_path / "sup")
    attempts = {"n": 0}

    def run_once(batches):
        attempts["n"] += 1
        crash = 12 if attempts["n"] == 1 else None
        return train(_model(cfg), scfg, batches,
                     LoopConfig(total_steps=20, ckpt_every=5, ckpt_dir=d, async_ckpt=False,
                                log_every=20),
                     crash_at=crash)

    res = train_with_restarts(lambda: data.batches(), run_once,
                              fault.RestartPolicy(max_failures=3))
    assert attempts["n"] == 2
    assert int(res["state"]["step"]) == 20
    assert sorted(ckpt._committed_steps(d)) == [10, 15, 20]


def test_supervisor_gives_up_after_its_budget():
    sleeps = []

    def run_once(batches):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="always"):
        train_with_restarts(lambda: iter(()), run_once,
                            fault.RestartPolicy(max_failures=2), sleep=sleeps.append)
    assert sleeps == [0.01, 0.01]


def test_loop_matches_the_reference_loop(tmp_path, monkeypatch):
    """The port's loop and the reference's from the reference's init tree
    (carried in through ``params_from_jax``) on the same batches, with the
    optimizer and limits of ``test_torch_train_step.py``: each step's loss
    within its atol, the same history steps, the same committed steps and
    equal ``index.json`` files; the reference restores the port's last
    checkpoint."""
    case = setup("llama3.2-3b")

    def init_from_reference(model, generator=None):
        return train_state(params_from_jax(model, case["tree"]))

    monkeypatch.setattr(loop, "init_train_state", init_from_reference)
    lc = dict(total_steps=3, ckpt_every=2, async_ckpt=True, log_every=1)
    rd, pd = tmp_path / "ref", tmp_path / "port"
    theirs = ref_train(case["ref_model"], RefStepConfig(optimizer=RefAdamWConfig(**OPT)),
                       iter(case["ref_batches"]), RefLoopConfig(ckpt_dir=str(rd), **lc))
    ours = train(build_model(case["port"].cfg, device="cpu"),
                 StepConfig(optimizer=AdamWConfig(**OPT)), iter(case["batches"]),
                 LoopConfig(ckpt_dir=str(pd), **lc))
    assert [h["step"] for h in ours["history"]] == [h["step"] for h in theirs["history"]]
    for a, b in zip(ours["history"], theirs["history"]):
        assert abs(a["loss"] - b["loss"]) <= STEP_LOSS_ATOL, a["step"]
    assert sorted(os.listdir(pd)) == sorted(os.listdir(rd)) == ["step_00000002",
                                                                 "step_00000003"]
    for step in ("step_00000002", "step_00000003"):
        assert (pd / step / "index.json").read_bytes() == (rd / step / "index.json").read_bytes()
    loaded, step = ref_ckpt.restore(str(pd))
    assert step == 3 and int(loaded["step"]) == int(theirs["state"]["step"]) == 3
    want = jax.tree.map(np.asarray, theirs["state"])
    assert jax.tree.structure(loaded) == jax.tree.structure(want)


# ---------------------------------------------------------------------------
# fault tolerance: the port's helpers against the reference's
# ---------------------------------------------------------------------------


def _detector_run(mod, times, tau=1.5, patience=3):
    det = mod.StragglerDetector(tau=tau, patience=patience)
    flags = []
    for window in times:
        for host, t in window.items():
            det.record(host, t)
        flags.append(det.update_flags())
    return flags, {h: (s.ewma, s.n, s.flags) for h, s in det.hosts.items()}, det.median()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_detector_matches_the_reference(seed):
    rng = np.random.RandomState(seed)
    times = [{f"h{h}": float(rng.uniform(0.9, 1.1)) for h in range(4)} for _ in range(8)]
    for w in times[2:]:
        w["h4"] = float(rng.uniform(2.0, 4.0))  # a straggler from the third window
    ours, theirs = _detector_run(fault, times), _detector_run(ref_fault, times)
    assert ours == theirs
    assert "h4" in ours[0][-1] and all(h == "h4" for h in ours[0][-1])


def test_straggler_needs_patience():
    for mod in (fault, ref_fault):
        det = mod.StragglerDetector(tau=1.5, patience=3)
        for h in range(4):
            det.record(f"h{h}", 1.0)
        det.record("h4", 5.0)
        assert det.update_flags() == []  # only one window


@pytest.mark.parametrize("alloc,straggler", [
    ({"pod0": 4, "pod1": 4}, "pod0"),
    ({"pod0": 1, "pod1": 4}, "pod0"),
    ({"pod0": 3, "pod1": 5, "pod2": 2}, "pod2"),
    ({"pod0": 3}, "pod0"),
    ({"pod0": 3, "pod1": 3}, "pod9"),
])
def test_channel_reallocation_matches_the_reference(alloc, straggler):
    out = fault.reallocate_channels_for_straggler(alloc, straggler)
    assert out == ref_fault.reallocate_channels_for_straggler(alloc, straggler)
    assert sum(out.values()) == sum(alloc.values())


def test_restart_policy_matches_the_reference():
    for kw in (dict(max_failures=3, backoff_base=1.0, backoff_cap=10.0), {}):
        ours, theirs = fault.RestartPolicy(**kw), ref_fault.RestartPolicy(**kw)
        got = [ours.next_delay() for _ in range(12)]
        assert got == [theirs.next_delay() for _ in range(12)]
        ours.reset()
        assert ours.failures == 0 and ours.next_delay() == got[0]
    assert got[:3] == [5.0, 10.0, 20.0] and got[10] is None


@pytest.mark.parametrize("args", [
    (2, 256, 1, 0), (2, 256, 0, 16), (1, 256, 0, 0), (4, 64, 1, 8), (2, 16, 2, 0),
    (2, 48, 0, 0), (1, 8, 0, 0),
])
def test_elastic_mesh_plans_match_the_reference(args):
    ours = fault.elastic_mesh_plans(*args)
    theirs = ref_fault.elastic_mesh_plans(*args)
    assert [(p.shape, p.axes, p.chips, p.note) for p in ours] == [
        (p.shape, p.axes, p.chips, p.note) for p in theirs]
