"""The port's multi-rank train step and loop (``repro_torch.train.
train_step.make_train_step(..., group=...)``, ``train.loop.train(...,
group=...)``) on 2 gloo ranks on the CPU against the reference's 2-pod
step.

The reference's multi-pod step runs in a subprocess on 2 fake CPU devices
(``--xla_force_host_platform_device_count=2``), its mesh (2, 1, 1) over
("pod", "data", "model") built here with Auto axes (with jax 0.9.0's
default Explicit axes its sharding constraints refuse the manual pod
axis), compiled strict as ``test_torch_train_step.py`` compiles it. Both
sides start from the reference's init tree (``params_from_jax``) on the
smoke-size gemma3-1b and take three steps on the same 4 x 32 batches (2
rows a rank) with the reference's default optimizer.

Limits, the one-device step's of ``test_torch_train_step.py``, for
``naive``, ``promc`` without compression and ``promc`` with it: after one
step the AdamW first moments (the synced, clipped gradient times 0.1)
within the gradient's 2^-5 normwise of the reference's; each step's loss
within 2e-2; over the three steps each parameter's change within 2^-4
normwise. The change is held over three steps, as that test holds it:
Adam's first step moves an element by about lr whichever its gradient's
size, so one step's change parts from the reference's by 14.5% normwise on
one device too (the layer norms' scales of this model), where three steps
part by 4.3%. The reference's own limits on the port, after one step and
after three: ``sc`` / ``mc`` / ``promc`` parameters exactly ``naive``'s,
the compressed ones (bf16, int8) within 5e-3 max abs; both ranks bit for
bit. At this size every leaf is Small, so the reference's tables compress
nothing; two more variants take bf16 or int8 on every class, and their
syncs must send only that codec, their first moments within 2^-7 (bf16)
and 0.1 (int8) normwise of naive's. A 2-rank ``train`` with a crash and a resume (``train_with_restarts``)
ends bit for bit where a straight 2-rank run ends. ~45 s.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core.types import ChunkType
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.distributed import grad_sync
from repro_torch.models.config import reduce_for_smoke
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train, train_with_restarts
from repro_torch.train.train_step import StepConfig, make_train_step, state_tree, train_state
from test_torch_train_step import (CHANGE_NORMWISE, GRAD_NORMWISE, OPT, STEP_LOSS_ATOL, STEPS,
                                   normwise, port_leaves, ref_leaves)
from torch_ranks import run_ranks

ROOT = Path(__file__).resolve().parents[1]
ARCH, B, S = "gemma3-1b", 4, 32
#: the reference's limit on a compressed sync against naive's parameters
COMPRESSED_MAX_ABS = 5e-3
#: the port's variants: StepConfig's sync options
VARIANTS = {
    "naive": dict(sync_algorithm="naive"),
    "sc": dict(sync_algorithm="sc", compress=False),
    "mc": dict(sync_algorithm="mc", compress=False),
    "promc": dict(sync_algorithm="promc", compress=False),
    "promc_comp": dict(sync_algorithm="promc", compress=True),
    "promc_int8": dict(sync_algorithm="promc", compress=True, compress_codec="int8"),
    "promc_bf16_all": dict(sync_algorithm="promc", compress=True),
    "promc_int8_all": dict(sync_algorithm="promc", compress=True),
}
#: variants whose plan takes one codec on every chunk class: at this size
#: every leaf is Small, which the reference's tables keep fp32, so only
#: these run the step's compressed sync
FORCED = {"promc_bf16_all": "bf16", "promc_int8_all": "int8"}
#: a forced codec's limit on the first moments' distance from naive's
#: (normwise over every leaf), the synced gradient's times 0.1: bf16 rounds
#: each rank's gradient (here 0.0016), int8 quantizes an item to 127 levels
#: of one scale (here 0.031; with rank 0's scale for both ranks 0.17)
FORCED_NORMWISE = {"bf16": 2.0 ** -7, "int8": 0.1}
COMPRESSED = ("promc_comp", "promc_int8", *FORCED)
#: the reference's variants run in the subprocess
REF_VARIANTS = ("naive", "promc", "promc_comp")

_REF_STEP = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.data.synthetic import DataConfig, SyntheticLM
    from repro.launch.mesh import set_mesh
    from repro.models.config import reduce_for_smoke
    from repro.models.model import build_model
    from repro.optim.adamw import AdamWConfig
    from repro.train.train_step import StepConfig, init_train_state, make_train_step

    arch, b, s, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    cfg = reduce_for_smoke(get_config(arch))
    model = build_model(cfg)
    batches = [{k: jnp.asarray(v) for k, v in x.items()} for x in
               SyntheticLM(cfg, DataConfig(global_batch=b, seq_len=s)).batches(int(sys.argv[5]))]
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    variants = {
        "naive": dict(sync_algorithm="naive"),
        "promc": dict(sync_algorithm="promc", compress=False),
        "promc_comp": dict(sync_algorithm="promc", compress=True),
    }
    res = {}
    with set_mesh(mesh):
        for name, kw in variants.items():
            step = jax.jit(make_train_step(model, StepConfig(optimizer=AdamWConfig(), **kw),
                                           mesh=mesh, multi_pod=True),
                           compiler_options={"xla_allow_excess_precision": False})
            state, runs = init_train_state(model, jax.random.PRNGKey(0)), []
            for batch in batches:
                state, metrics = step(state, batch)
                runs.append({k: float(v) for k, v in metrics.items()})
                if len(runs) == 1:
                    first = (jax.tree.map(np.asarray, state["params"]),
                             jax.tree.map(np.asarray, state["opt"]["m"]))
            res[name] = (first, jax.tree.map(np.asarray, state["params"]), runs)
    with open(out, "wb") as f:
        pickle.dump(res, f)
""")


def _init_tree():
    from repro.configs import get_config as ref_get_config
    from repro.models.config import reduce_for_smoke as ref_reduce_for_smoke
    from repro.models.model import build_model as ref_build_model

    ref_model = ref_build_model(ref_reduce_for_smoke(ref_get_config(ARCH)))
    return jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))


def step_worker(pods, tree_path):
    """STEPS steps of each variant from the init tree on this rank: after
    the first the parameters and first moments (reference layout), after
    the last the parameters; each step's metrics, the step count, the last
    sync's collectives and its wire bytes by codec. A FORCED variant's
    step takes its codec on every class (``compress_table`` patched)."""
    with open(tree_path, "rb") as f:
        tree = pickle.load(f)
    cfg = reduce_for_smoke(get_config(ARCH))
    batches = list(SyntheticLM(cfg, DataConfig(global_batch=B, seq_len=S)).batches(STEPS))
    out = {}
    for name, kw in VARIANTS.items():
        model = params_from_jax(build_model(cfg, device="cpu"), tree)
        step = make_train_step(model, StepConfig(optimizer=AdamWConfig(**OPT), **kw),
                               group=pods.group)
        state, runs = train_state(model), []
        table = {t: FORCED.get(name) for t in ChunkType}
        with (mock.patch.object(grad_sync, "compress_table", lambda *_: table)
              if name in FORCED else contextlib.nullcontext()):
            for batch in batches:
                state, metrics = step(state, batch)
                runs.append({k: float(v) for k, v in metrics.items()})
                if len(runs) == 1:
                    first = (port_leaves(model), port_leaves(model, state["opt"]["m"]))
        out[name] = (first, port_leaves(model), runs, int(state["step"]),
                     step.last_sync.collectives, step.last_sync.wire_bytes)
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multipod")
    ref_out = tmp / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_STEP, ARCH, str(B), str(S), str(ref_out),
                             str(STEPS)],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    tree = _init_tree()
    with open(tmp / "tree.pkl", "wb") as f:
        pickle.dump(tree, f)
    port = run_ranks(step_worker, 2, tmp / "ranks", str(tmp / "tree.pkl"))
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    with open(ref_out, "rb") as f:
        ref = pickle.load(f)
    return {"tree": tree, "ref": ref, "port": port}


@pytest.mark.parametrize("name", REF_VARIANTS)
def test_two_rank_step_matches_the_reference_two_pod_step(steps, name):
    before = ref_leaves(steps["tree"])
    (_, want_m), want_params, want_runs = steps["ref"][name]
    (_, got_m), got, runs, step, *_ = steps["port"][0][name]
    assert step == STEPS == len(runs) == len(want_runs)
    for i, (m, w) in enumerate(zip(runs, want_runs)):
        assert m.keys() == w.keys()
        assert abs(m["loss"] - w["loss"]) <= STEP_LOSS_ATOL, i
        assert abs(m["lr"] - w["lr"]) <= 1e-6 * w["lr"], i
    want_m, got_m = ref_leaves(want_m), got_m
    assert got_m.keys() == want_m.keys()
    worst = {p: normwise(got_m[p], want_m[p]) for p in want_m}
    bad = {p: e for p, e in worst.items() if not e <= GRAD_NORMWISE}
    assert not bad, f"first moments after one step past 2^-5 normwise: {bad}"
    want = ref_leaves(want_params)
    assert got.keys() == want.keys()
    worst = {p: normwise(got[p] - before[p], want[p] - before[p]) for p in want}
    bad = {p: e for p, e in worst.items() if not e <= CHANGE_NORMWISE}
    assert not bad, f"parameter changes past 2^-4 normwise: {bad}"


def test_reference_limits_hold_on_its_own_two_pod_step(steps):
    """The reference's test_multipod_sync_matches_naive_8dev limits, on its
    2-pod run here, after one step and after three."""
    for at in (lambda r: r[0][0], lambda r: r[1]):
        ref = {n: ref_leaves(at(r)) for n, r in steps["ref"].items()}
        for p in ref["naive"]:
            np.testing.assert_array_equal(ref["promc"][p], ref["naive"][p], err_msg=p)
            assert np.abs(ref["promc_comp"][p] - ref["naive"][p]).max() < COMPRESSED_MAX_ABS


@pytest.mark.parametrize("name", [n for n in VARIANTS if n != "naive"])
def test_scheduled_sync_keeps_the_reference_limits(steps, name):
    naive = steps["port"][0]["naive"]
    got = steps["port"][0][name]
    assert got[4] > 0
    if name in FORCED:
        assert set(got[5]) == {FORCED[name]}  # every collective compressed
    for at in (lambda r: r[0][0], lambda r: r[1]):
        for p in at(naive):
            if name in COMPRESSED:
                assert np.abs(at(got)[p] - at(naive)[p]).max() < COMPRESSED_MAX_ABS, p
            else:
                np.testing.assert_array_equal(at(got)[p], at(naive)[p], err_msg=p)
    if name not in COMPRESSED:
        assert got[2] == naive[2]


@pytest.mark.parametrize("name", list(FORCED))
def test_forced_codec_first_moments_within_their_limit(steps, name):
    want = steps["port"][0]["naive"][0][1]
    got = steps["port"][0][name][0][1]
    num = sum(float(((got[p].astype(np.float64) - want[p]) ** 2).sum()) for p in want)
    den = sum(float((want[p].astype(np.float64) ** 2).sum()) for p in want)
    assert np.sqrt(num / den) <= FORCED_NORMWISE[FORCED[name]]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_both_ranks_end_bit_for_bit(steps, name):
    a, b = steps["port"][0][name], steps["port"][1][name]
    assert a[2] == b[2]
    for x, y in ((a[0][0], b[0][0]), (a[0][1], b[0][1]), (a[1], b[1])):
        for p in x:
            assert x[p].tobytes() == y[p].tobytes(), p


# ------------------------------------------------------------------ #
# the loop over 2 ranks: a crash and a resume, bit for bit
# ------------------------------------------------------------------ #

LOOP_ARCH, TOTAL, EVERY, CRASH = "llama3.2-3b", 6, 2, 5


def _flat_state(model, state):
    return [(name, np.array(x)) for name, x in ckpt._flatten(state_tree(model, state), copy=True)]


def resume_worker(pods, root, async_ckpt):
    """A straight run and a run that crashes at step CRASH and resumes under
    ``train_with_restarts``, each over the group, checkpoints every EVERY
    steps; this rank's final states, histories and attempts."""
    cfg = reduce_for_smoke(get_config(LOOP_ARCH))
    data = SyntheticLM(cfg, DataConfig(global_batch=B, seq_len=S))
    scfg = StepConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                                            weight_decay=0.0))
    lc = dict(total_steps=TOTAL, ckpt_every=EVERY, async_ckpt=async_ckpt, log_every=1)
    model = build_model(cfg, device="cpu")
    straight = train(model, scfg, data.batches(), LoopConfig(ckpt_dir=os.path.join(root, "a"), **lc),
                     group=pods.group)
    out = {"straight": (_flat_state(model, straight["state"]), straight["history"])}
    attempts, models = [], []

    def run_once(batches):
        attempts.append(len(attempts))
        models.append(build_model(cfg, device="cpu"))
        return train(models[-1], scfg, batches,
                     LoopConfig(ckpt_dir=os.path.join(root, "b"), **lc),
                     crash_at=CRASH if len(attempts) == 1 else None, group=pods.group)

    resumed = train_with_restarts(data.batches, run_once)
    out["resumed"] = (_flat_state(models[-1], resumed["state"]), resumed["history"])
    out["attempts"] = len(attempts)
    out["committed"] = sorted(ckpt._committed_steps(os.path.join(root, "b")))
    return out


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_two_rank_crash_and_resume_is_bit_exact(tmp_path, async_ckpt):
    ranks = run_ranks(resume_worker, 2, tmp_path / "ranks", str(tmp_path), async_ckpt)
    for r, res in enumerate(ranks):
        assert res["attempts"] == 2
        assert res["committed"] == [2, 4, 6]
        straight, hist = res["straight"]
        resumed, rhist = res["resumed"]
        assert [h["step"] for h in rhist] == list(range(CRASH - CRASH % EVERY + 1, TOTAL + 1))
        for a, b in zip(hist[-len(rhist):], rhist):
            assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"], (r, a["step"])
        assert [n for n, _ in straight] == [n for n, _ in resumed]
        for (name, a), (_, b) in zip(straight, resumed):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (r, name)
        # the ranks hold the same state
        for (name, a), (_, b) in zip(straight, ranks[0]["straight"][0]):
            assert a.tobytes() == b.tobytes(), (r, name)
