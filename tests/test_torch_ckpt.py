"""The port's checkpointing (``repro_torch.checkpoint.ckpt``) and the train
state in the reference's layout (``train_step.state_tree`` /
``put_state_tree``) on the CPU: a train state's round trip bit for bit
(parameters, both AdamW moments, ``count`` and ``step``), the GC, the
asynchronous saver and its snapshot, a save killed mid-write; and the
interchange with the reference's ``checkpoint/ckpt.py`` for each model
family: the same state saved by either package gives equal ``index.json``
and byte-identical ``.npy`` files, and each package restores the other's
checkpoint. ~20 s."""
from __future__ import annotations

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
from repro.models.model import build_model as ref_build_model
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model, tree_leaves
from repro_torch.train.train_step import (init_train_state, put_state_tree, state_tree,
                                          train_state)

#: the families of the training tests; recurrentgemma with one layer past
#: its last whole period, so that the reference's tree has a ``tail`` list
FAMILIES = ["gemma3-1b", "deepseek-moe-16b", "paligemma-3b", "whisper-base", "rwkv6-3b",
            "recurrentgemma-9b+tail"]


def _leaves(tree) -> dict:
    """{path: numpy array} of a tree of tensors, stacked lists and arrays."""
    def leaf(n):
        return not isinstance(n, (dict, list)) or (
            isinstance(n, list) and bool(n) and isinstance(n[0], torch.Tensor))

    def host(x):
        if isinstance(x, list):
            return np.stack([t.detach().numpy() for t in x])
        return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return {path: host(x) for path, x in tree_leaves(tree, leaf).items()}


def assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))


def _random_moments(state, seed):
    """Random m, v, count and step in the state (a state past its first
    steps), so that a round trip that dropped them would show."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for part in ("m", "v"):
            for t in state["opt"][part].values():
                t.copy_(torch.randn(t.shape, generator=gen).abs())
        state["opt"]["count"].fill_(11)
        state["step"].fill_(13)
    return state


def _port_state(arch="llama3.2-3b", seed=0):
    model = build_model(reduce_for_smoke(get_config(arch)), device="cpu")
    state = _random_moments(init_train_state(model, torch.Generator().manual_seed(seed)), seed)
    return model, state


def test_train_state_round_trip_bit_for_bit(tmp_path):
    model, state = _port_state()
    path = ckpt.save(state_tree(model, state), str(tmp_path), 7)
    assert os.path.exists(os.path.join(path, "index.json"))
    loaded, step = ckpt.restore(str(tmp_path))
    assert step == 7
    assert_trees_equal(loaded, state_tree(model, state))
    other, fresh = _port_state(seed=1)
    assert not torch.equal(other.embed["tok"], model.embed["tok"])
    put_state_tree(other, fresh, loaded)
    assert_trees_equal(state_tree(other, fresh), state_tree(model, state))
    assert int(fresh["step"]) == 13 and int(fresh["opt"]["count"]) == 11
    assert fresh["step"].dtype == fresh["opt"]["count"].dtype == torch.int32
    # the state's tensors are the model's own, written in place
    assert all(p is fresh["params"][n] for n, p in other.named_parameters())


def test_put_state_tree_checks_names_and_shapes(tmp_path):
    model, state = _port_state()
    tree = ckpt.snapshot(state_tree(model, state))
    tree["opt"]["m"]["layers"]["wq"] = tree["opt"]["m"]["layers"]["wq"][:, :1]
    with pytest.raises(ValueError, match="shapes differ"):
        put_state_tree(model, state, tree)
    tree = ckpt.snapshot(state_tree(model, state))
    del tree["params"]["embed"]["tok"]
    with pytest.raises(ValueError, match="names differ"):
        put_state_tree(model, state, tree)


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4), np.asarray(7, np.int32),
    np.zeros((0, 3)), np.array([True, False, True]), np.arange(6, dtype=np.int64),
    np.arange(20, dtype=np.float16).reshape(4, 5).T,  # F-ordered: written C-ordered
    torch.arange(10, dtype=torch.float32).reshape(2, 5).t(),
], ids=lambda v: f"{type(v).__name__}-{tuple(v.shape)}")
@pytest.mark.parametrize("block", [1, 7, 100, 1 << 20])
def test_npy_file_reads_the_bytes_np_save_writes(value, block):
    """A leaf's file read in any slices, as the engine reads it, is what
    ``np.save`` writes for the leaf made C-ordered."""
    import io

    (_, arr), = ckpt._flatten({"x": value})
    want = io.BytesIO()
    np.save(want, np.asarray(value, order="C"), allow_pickle=False)
    f = ckpt._NpyFile(arr)
    got = b"".join(bytes(f[a: min(a + block, len(f))]) for a in range(0, len(f), block))
    assert len(f) == len(want.getvalue()) and got == want.getvalue()


def test_checkpoint_gc_keeps_latest(tmp_path):
    model, state = _port_state()
    tree = state_tree(model, state)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tree, str(tmp_path), s, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert sorted(ckpt._committed_steps(str(tmp_path))) == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_async_checkpointer(tmp_path):
    model, state = _port_state()
    reports = []
    saver = ckpt.AsyncCheckpointer(str(tmp_path), on_report=reports.append)
    saver.save(state_tree(model, state), 3)
    saver.wait()
    loaded, step = ckpt.restore(str(tmp_path))
    assert step == 3
    assert_trees_equal(loaded, state_tree(model, state))
    (r,) = reports
    assert (r.kind, r.step, r.files) == ("save", 3, len(_leaves(loaded)))
    assert r.engine.files_done == r.files and r.engine.total_bytes == r.bytes
    assert r.snapshot_s > 0 and r.serialize_s > 0


def test_async_snapshot_is_isolated_from_later_updates(tmp_path, monkeypatch):
    """``AsyncCheckpointer.save`` copies the state before it returns: the
    parameters changed in place right after (as the next AdamW step does)
    do not reach the files, though the saver thread writes after the
    change."""
    model, state = _port_state()
    want = {path: x.copy() for path, x in _leaves(state_tree(model, state)).items()}
    changed = threading.Event()
    real_save = ckpt.save

    def save_after_the_change(*args, **kw):
        assert changed.wait(timeout=30)
        return real_save(*args, **kw)

    monkeypatch.setattr(ckpt, "save", save_after_the_change)
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(state_tree(model, state), 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for m in state["opt"]["m"].values():
            m.mul_(2.0)
        state["step"].add_(1)
    changed.set()
    saver.wait()
    loaded, _ = ckpt.restore(str(tmp_path))
    got = _leaves(loaded)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))


def test_killed_save_leaves_only_tmp(tmp_path, monkeypatch):
    """A save that dies mid-write (its third block) leaves ``step_N.tmp``
    without an index; ``latest_step`` and ``restore`` take the last
    committed step."""
    model, state = _port_state()
    tree = state_tree(model, state)
    ckpt.save(tree, str(tmp_path), 1)
    real_task = ckpt.bytes_task
    writes = []

    def dying_task(spec, data, dst):
        task = real_task(spec, data, dst)
        write = task.write

        def write_then_die(offset, chunk):
            writes.append(offset)
            if len(writes) > 2:
                raise OSError("killed mid-write")
            write(offset, chunk)

        return dataclasses.replace(task, write=write_then_die)

    monkeypatch.setattr(ckpt, "bytes_task", dying_task)
    with pytest.raises(OSError, match="killed mid-write"):
        ckpt.save(tree, str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000002.tmp"]
    assert not os.path.exists(tmp_path / "step_00000002.tmp" / "index.json")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.restore(str(tmp_path))[1] == 1


# ---------------------------------------------------------------------------
# interchange with the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """The reference's smoke model's init tree with random moments, its
    count and step (numpy: the reference's state tree), and the port's
    model and state holding the same values."""
    arch, _, extra = request.param.partition("+")
    ref_cfg = ref_reduce_for_smoke(ref_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    if extra == "tail":
        ref_cfg = dataclasses.replace(ref_cfg, num_layers=ref_cfg.num_layers + 1)
        cfg = dataclasses.replace(cfg, num_layers=ref_cfg.num_layers)
    params = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    moment = lambda p: rng.standard_normal(p.shape).astype(np.float32)  # noqa: E731
    ref_state = {"params": params,
                 "opt": {"m": jax.tree.map(moment, params),
                         "v": jax.tree.map(lambda p: np.abs(moment(p)), params),
                         "count": np.asarray(5, np.int32)},
                 "step": np.asarray(5, np.int32)}
    if extra == "tail":
        assert len(params["tail"]) == 1
    model = params_from_jax(build_model(cfg, device="cpu"), params)
    state = put_state_tree(model, train_state(model), ref_state)
    return ref_state, model, state


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


def test_port_and_reference_checkpoints_are_byte_identical(family, tmp_path):
    ref_state, model, state = family
    ref_ckpt.save(ref_state, str(tmp_path / "ref"), 5)
    ckpt.save(state_tree(model, state), str(tmp_path / "port"), 5)
    theirs = _files(tmp_path / "ref" / "step_00000005")
    ours = _files(tmp_path / "port" / "step_00000005")
    assert list(ours) == list(theirs)
    assert ours["index.json"] == theirs["index.json"]
    for name in theirs:
        assert ours[name] == theirs[name], name


def test_reference_restores_the_port_checkpoint(family, tmp_path):
    ref_state, model, state = family
    ckpt.save(state_tree(model, state), str(tmp_path), 5)
    loaded, step = ref_ckpt.restore(str(tmp_path))
    assert step == 5
    assert_trees_equal(loaded, ref_state)


def test_port_restores_the_reference_checkpoint(family, tmp_path):
    ref_state, model, _ = family
    ref_ckpt.save(ref_state, str(tmp_path), 5)
    loaded, step = ckpt.restore(str(tmp_path))
    assert step == 5
    assert_trees_equal(loaded, ref_state)
    fresh = build_model(model.cfg, device="cpu")
    state = put_state_tree(fresh, init_train_state(fresh, torch.Generator().manual_seed(3)),
                           loaded)
    assert_trees_equal(state_tree(fresh, state), ref_state)
