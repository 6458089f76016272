"""Fault-tolerant training loop: checkpoint/restart, heartbeats, metrics.

The reference's single-host control plane (``train/loop.py``) on one
device: periodic (async) checkpoints with atomic commit, resume from the
newest complete checkpoint after a crash, straggler detection fed by step
times, and bounded restarts with backoff. A resumed run ends bit for bit
where a straight run ends: the checkpoint holds the parameters, both AdamW
moments, the update count and the step, and the batches of the steps
already taken are skipped.

The port's train state holds the model's own parameters, which AdamW
writes in place (:mod:`repro_torch.train.train_step`), so a checkpoint is
the state's :func:`~repro_torch.train.train_step.state_tree` and a restore
writes back into the model and the optimizer state
(:func:`~repro_torch.train.train_step.put_state_tree`).

Over a group of ranks (``train(..., group=...)``) every rank takes the
same update, so the state is the same on every rank after each step: rank
0 alone writes checkpoints, and the ranks meet at a barrier after each
save call (a synchronous save's commit, an asynchronous save's snapshot)
and after the final commit. At a start rank 0 reads the newest committed
step and sends it to the others, so every rank restores the same step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.distributed.fault import RestartPolicy, StragglerDetector
from repro_torch.distributed.pods import group_size
from repro_torch.models.model import BaseLM
from repro_torch.train.train_step import (StepConfig, init_train_state, make_train_step,
                                          put_state_tree, state_tree)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    async_ckpt: bool = True
    log_every: int = 10
    host: str = "host0"


def train(
    model: BaseLM,
    step_cfg: StepConfig,
    batches: Iterator[Dict],
    loop: LoopConfig,
    seed: int = 0,
    crash_at: Optional[int] = None,  # test hook: raise at this step
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
    on_checkpoint: Optional[ckpt.Observer] = None,
    group: Optional[dist.ProcessGroup] = None,
) -> Dict[str, Any]:
    """Run (or resume) training on the model's device; returns ``{"state",
    "history", "stragglers"}``. The state starts from ``seed`` (a
    ``torch.Generator`` on the model's device), or from the newest
    committed checkpoint in ``loop.ckpt_dir``. ``on_checkpoint`` is called
    with each save's and the restore's :class:`~repro_torch.checkpoint.
    ckpt.CheckpointReport` (an asynchronous save's on its saver thread).
    ``group``: train over its ranks (see the module's docstring); every
    rank is given the same ``batches``, the global batch."""
    step_fn = make_train_step(model, step_cfg, group=group)
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(seed))
    ranks = group_size(group)
    writer = ranks == 1 or dist.get_rank(group) == 0

    def meet():
        if ranks > 1:
            dist.barrier(group=group)

    start_step = 0
    if loop.ckpt_dir:
        latest = ckpt.latest_step(loop.ckpt_dir) if writer else None
        if ranks > 1:
            sent = [latest]
            dist.broadcast_object_list(sent, src=dist.get_global_rank(group, 0), group=group)
            latest = sent[0]
        if latest is not None:
            loaded, start_step = ckpt.restore(loop.ckpt_dir, latest, on_report=on_checkpoint)
            put_state_tree(model, state, loaded)
            del loaded

    saver = (
        ckpt.AsyncCheckpointer(loop.ckpt_dir, on_report=on_checkpoint)
        if (loop.ckpt_dir and loop.async_ckpt and writer)
        else None
    )
    detector = StragglerDetector()
    history: List[Dict] = []

    it = iter(batches)
    # skip consumed batches deterministically on resume
    for _ in range(start_step):
        next(it)

    for step in range(start_step, loop.total_steps):
        batch = next(it)
        t0 = time.monotonic()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.monotonic() - t0
        detector.record(loop.host, dt)

        if crash_at is not None and step + 1 == crash_at:
            if saver:
                saver.wait()
            raise RuntimeError(f"injected crash at step {step + 1}")

        if loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
            if saver:
                saver.save(state_tree(model, state), step + 1)
            elif writer:
                ckpt.save(state_tree(model, state), loop.ckpt_dir, step + 1,
                          on_report=on_checkpoint)
            meet()

        if (step + 1) % loop.log_every == 0 or step + 1 == loop.total_steps:
            entry = {"step": step + 1, "time_s": dt, **metrics}
            history.append(entry)
            if on_metrics:
                on_metrics(step + 1, entry)

    if saver:
        saver.wait()
    if loop.ckpt_dir:
        if writer:
            ckpt.save(state_tree(model, state), loop.ckpt_dir, loop.total_steps,
                      on_report=on_checkpoint)
        meet()
    return {"state": state, "history": history, "stragglers": detector}


def train_with_restarts(
    make_batches: Callable[[], Iterator[Dict]],
    run_once: Callable[[Iterator[Dict]], Dict],
    policy: Optional[RestartPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Dict:
    """Supervisor: restart `run_once` from checkpoints until success or the
    restart budget is exhausted (backoff between attempts)."""
    policy = policy or RestartPolicy()
    while True:
        try:
            result = run_once(make_batches())
            policy.reset()
            return result
        except RuntimeError:
            delay = policy.next_delay()
            if delay is None:
                raise
            sleep(min(delay, 0.01))  # tests shrink real waiting
