"""Custom-scheduler rows in the port's batched sweep, on the CPU.

A custom row is a Simulation whose scheduler is not exactly one of the
built-in classes (a subclass of SC, MC or ProMC with no method of its own
is one too). The object ingest gives it kind -1 and no t=0 layout; the
driver applies its initial actions at start and runs its ``on_tick`` /
``on_chunk_complete`` through the reference's scalar callback protocol on
the host, and the loop kernel's plain version stops the row
(``transition.STOP_CUSTOM``) at each event that calls one.

The mixed batch: the smoke grid plus one seeded row on the time-varying
steppy-backbone testbed, every other row's scheduler swapped for a class
defined here (a no-override subclass of SC, MC and ProMC; a tick-driven
mover; a closer that closes a busy channel of another chunk on each
completion, which pushes resume files), with the no-override rows' built-in
twins appended. Limits:

* every route (``device="cpu"``) against the port's event leg: moves and
  bytes exact, throughput within 1e-9 relative; each no-override row within
  1e-9 of its built-in twin;
* the closed-form split route against the reference's NumPy
  ``FabricSimulation`` on the same batch built from the reference's
  classes: events and moves exact, total time within 1e-12 relative.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.core import schedulers as port_schedulers
from repro_torch.core.simulator import Simulation
from repro_torch.eval.fabric import driver as port_driver
from repro_torch.eval.fabric import transition as tr
from repro_torch.eval.fabric.driver import SweepStats, TorchFabricSimulation
from repro_torch.eval.fabric.kernels import fused_step as fs
from repro_torch.eval.fabric.plan import build_plan, from_simulations
from repro_torch.eval.runner import run_matrix, run_simulations
from repro_torch.eval.scenarios import Scenario, build_simulation, smoke_matrix

ROUTES = ("rounds", "kernel", "none")
#: class name -> the built-in algorithm whose chunks it runs on
BASES = {"NoOverrideSC": "sc", "NoOverrideMC": "mc", "NoOverrideProMC": "promc",
         "Mover": "mc", "Closer": "mc"}
CYCLE = tuple(BASES)


def custom_classes(sch):
    """The custom classes over a schedulers module (the port's or the
    reference's: both run the same Python)."""

    class NoOverrideSC(sch.SingleChunkScheduler):
        pass

    class NoOverrideMC(sch.MultiChunkScheduler):
        pass

    class NoOverrideProMC(sch.ProActiveMultiChunkScheduler):
        pass

    class Mover(sch.MultiChunkScheduler):
        """Each tick, one channel from the live chunk with the least ETA
        (holding two or more) to the one with the most."""

        name = "Mover"

        def on_tick(self, view):
            live = [v for v in view if not v.done and v.bytes_remaining > 0 and v.n_channels > 0]
            src = min((v for v in live if v.n_channels > 1), key=lambda v: v.eta, default=None)
            dst = max(live, key=lambda v: v.eta, default=None)
            if src is None or dst is None or src.index == dst.index:
                return []
            return [sch.Move(src=src.index, dst=dst.index, n=1)]

    class Closer(sch.MultiChunkScheduler):
        """On each completion, first close one channel of the live chunk
        with the most channels (its channels are busy: a resume push), then
        MC's redistribution."""

        name = "Closer"

        def on_chunk_complete(self, view, chunk):
            others = [v for v in view if v.index != chunk and not v.done and v.n_channels > 1]
            acts = []
            if others:
                acts.append(sch.Close(chunk=max(others, key=lambda v: v.n_channels).index, n=1))
            return acts + super().on_chunk_complete(view, chunk)

    return {c.__name__: c for c in (NoOverrideSC, NoOverrideMC, NoOverrideProMC, Mover, Closer)}


def mixed_scenarios(seed=0):
    """The smoke grid and one steppy-backbone row (a bandwidth profile with
    steps at 12, 45 and 120 s), built from ``seed``."""
    return smoke_matrix(seed) + [
        Scenario(network="steppy-backbone", dataset="mixed", algorithm="promc", seed=seed)
    ]


def mixed_batch(build, sch, seed=0):
    """``(sims, names, twins)``: every other row of :func:`mixed_scenarios`
    with a custom class (in turn), on the chunks of its base algorithm;
    then the no-override rows' built-in twins. ``twins`` maps a custom row
    to its twin's index."""
    classes = custom_classes(sch)
    sims, names, twin_of = [], [], []
    for i, sc in enumerate(mixed_scenarios(seed)):
        if i % 2 == 0:
            sims.append(build(sc))
            names.append(sc.name)
            continue
        cname = CYCLE[(i // 2) % len(CYCLE)]
        base = dataclasses.replace(sc, algorithm=BASES[cname])
        ref = build(base)
        new = classes[cname](ref.scheduler.chunks, ref.network, base.max_cc)
        sims.append(Simulation(new.chunks, ref.network, new, tick_period=ref.tick_period))
        names.append(f"{sc.name}:{cname}")
        if cname.startswith("NoOverride"):
            twin_of.append((len(sims) - 1, base))
    twins = {}
    for row, base in twin_of:
        twins[row] = len(sims)
        sims.append(build(base))
        names.append(base.name)
    return sims, names, twins


def port_batch(seed=0):
    return mixed_batch(build_simulation, port_schedulers, seed)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.fixture(scope="module")
def event_leg():
    sims, names, twins = port_batch()
    return names, twins, run_simulations(sims, names, backend="event")


def test_the_batch_holds_every_class_and_exercises_the_callbacks(event_leg):
    names, twins, event = event_leg
    plan = from_simulations(port_batch()[0], names)
    custom = plan.kind == tr.KIND_CUSTOM
    assert sorted({n.split(":")[-1] for n, c in zip(names, custom) if c}) == sorted(BASES)
    assert len(twins) >= 6
    moved = {n.split(":")[-1]: 0 for n, c in zip(names, custom) if c}
    for n, c, r in zip(names, custom, event):
        if c:
            moved[n.split(":")[-1]] += r.n_moves
    assert moved["Mover"] > 0 and moved["Closer"] > 0, moved


@pytest.mark.parametrize("route", ROUTES)
def test_custom_rows_hold_the_event_leg(event_leg, route):
    """Every row on each route against the event leg, the no-override rows
    against their built-in twins; the loop's custom stops are counted in
    ``post_row_replays`` and no guard fires. The default route runs through
    the runner (``run_simulations`` on the batched backend)."""
    names, twins, event = event_leg
    sims, _, _ = port_batch()
    if route == "rounds":
        stats = SweepStats()
        out = run_simulations(sims, names, device="cpu", stats=stats)
    else:
        drv = TorchFabricSimulation(from_simulations(sims, names), device="cpu", fused_step=route)
        out = drv.run()
        stats = drv.stats
    for n, a, e in zip(names, out, event):
        assert a.n_moves == e.n_moves, n
        assert a.total_bytes == e.total_bytes, n
        assert _rel(a.throughput, e.throughput) <= 1e-9, n
        assert a.scheduler == e.scheduler, n
    for row, twin in twins.items():
        assert _rel(out[row].throughput, out[twin].throughput) <= 1e-9, names[row]
        assert out[row].n_moves == out[twin].n_moves, names[row]
    assert stats.host_transitions == 0
    if route == "rounds":
        assert stats.post_row_replays > 0 and stats.sweeps < stats.post_row_replays
    else:
        assert stats.post_row_replays == 0


def test_closed_split_route_equals_the_reference_numpy_driver():
    """The same batch built from the reference's classes through its NumPy
    ``FabricSimulation``: events and moves exact, total time 1e-12."""
    from repro.core import schedulers as ref_schedulers
    from repro.eval.fabric.driver import FabricSimulation
    from repro.eval.scenarios import build_simulation as ref_build

    def ref_build_port_scenario(sc):
        from repro.eval.scenarios import Scenario as RefScenario

        return ref_build(RefScenario(**{f.name: getattr(sc, f.name)
                                        for f in dataclasses.fields(sc)}))

    rsims, rnames, _ = mixed_batch(ref_build_port_scenario, ref_schedulers)
    want = FabricSimulation(rsims, names=rnames).run()
    sims, names, _ = port_batch()
    assert names == rnames
    got = TorchFabricSimulation(from_simulations(sims, names), device="cpu", fused_step="none",
                                waterfill_impl="closed")
    out = got.run()
    for n, a, b in zip(names, out, want):
        assert (a.n_events, a.n_moves) == (b.n_events, b.n_moves), n
        assert a.total_bytes == b.total_bytes, n
        assert _rel(a.total_time, b.total_time) <= 1e-12, n


def _started(sims, names):
    drv = TorchFabricSimulation(from_simulations(sims, names), device="cpu", fused_step="rounds")
    drv.start()
    return drv


def _first_callback_event(sim):
    """The event count at which the event leg first calls the row's
    ``on_tick`` or ``on_chunk_complete`` (a copy of the Simulation runs)."""
    import copy

    sim = copy.deepcopy(sim)
    calls = []
    sched = sim.scheduler
    for name in ("on_tick", "on_chunk_complete"):
        if getattr(type(sched), name) is not getattr(port_schedulers.Scheduler, name):
            fn = getattr(sched, name)
            setattr(sched, name, lambda *a, _fn=fn: calls.append(1) or _fn(*a))
    sim.start()
    while not calls:
        sim.step()
    return sim.n_events


@pytest.mark.parametrize("cname", ["NoOverrideSC", "NoOverrideProMC", "Closer"])
def test_plain_loop_stops_a_custom_row_at_its_first_callback_event(cname):
    """From the started state, ``fused_rounds_plain`` stops the row with
    STOP_CUSTOM after as many steps as the event leg takes to its first
    callback, with the callback's event pending (a completion for a class
    with ``on_chunk_complete``, a due tick for one with ``on_tick``); the
    row's built-in rows run on."""
    sims, names, _ = port_batch()
    row = next(i for i, n in enumerate(names) if n.endswith(":" + cname))
    drv = _started([sims[row], sims[0]], [names[row], names[0]])
    s = drv.round_operands(~drv.done)
    out = fs.fused_rounds_plain(s, fs.ROUND_CAP)
    assert int(out["stop"][0]) == tr.STOP_CUSTOM
    assert int(out["stop"][1]) in (tr.STOP_DONE, tr.STOP_CAP)
    assert int(out["steps"][0]) == _first_callback_event(sims[row])
    st = dict(s)
    st.update(out)
    completed, tick_hit = tr.completions(st, torch.tensor([True, False]))
    assert bool(tr.custom_events(st, completed, tick_hit)[0])


def test_plain_loop_never_stops_a_custom_row_without_callbacks():
    """A kind -1 row whose class overrides neither callback (both trivial
    flags) runs in the loop to its end, bit for bit as a trivial row."""
    scs = [sc for sc in smoke_matrix() if sc.algorithm in ("globus", "untuned")][:4]
    drv = TorchFabricSimulation(build_plan(scs), device="cpu", fused_step="rounds")
    drv.start()
    s = drv.round_operands(~drv.done)
    want = fs.fused_rounds_plain(s, fs.ROUND_CAP)
    s["kind"] = torch.full_like(s["kind"], tr.KIND_CUSTOM)
    got = fs.fused_rounds_plain(s, fs.ROUND_CAP)
    assert (got["stop"] == tr.STOP_DONE).all()
    for k in want:
        assert torch.equal(got[k], want[k]) or (
            got[k].dtype == torch.float64 and torch.equal(got[k].isnan(), want[k].isnan())
            and torch.equal(got[k].nan_to_num(), want[k].nan_to_num())
        ), k


@pytest.mark.parametrize("route", ["rounds", "none"])
def test_built_in_smoke_grid_replays_nothing(route):
    stats = SweepStats()
    run_matrix(smoke_matrix(), device="cpu", fused_step=route, stats=stats)
    assert stats.post_row_replays == 0
    assert stats.host_transitions == 0


def _surge_class(sch):
    class Surge(sch.MultiChunkScheduler):
        """MC, with 80 more channels at t=0 for the chunk with the most
        files, all but one of them closed at the first tick (busy ones push
        their remainders): the channel axis and the resume stack grow on
        the host."""

        name = "Surge"

        def _big(self):
            return max(range(len(self.chunks)), key=lambda k: len(self.chunks[k].files))

        def initial_actions(self, view):
            return super().initial_actions(view) + [sch.Open(chunk=self._big(), n=80)]

        def on_tick(self, view):
            v = view[self._big()]
            if getattr(self, "closed", False) or v.n_channels < 2:
                return []
            self.closed = True
            return [sch.Close(chunk=v.index, n=v.n_channels - 1)]

    return Surge


@pytest.mark.parametrize("route", ["rounds", "none"])
def test_callbacks_grow_the_channel_axis_and_the_stack(route):
    """A callback that opens more channels than C holds and pushes more
    resume files than P holds: the driver grows both (C stays within
    1,024) and the row equals the event leg."""
    Surge = _surge_class(port_schedulers)
    # 60 small files: the first tick (at 0.1 s) finds most of them in flight
    sc = Scenario(network="xsede-lonestar-gordon", dataset="small_file_swarm", algorithm="mc",
                  tick_period=0.1)
    base = build_simulation(sc)

    def make():
        s = Surge(base.scheduler.chunks, base.network, sc.max_cc)
        return Simulation(s.chunks, base.network, s, tick_period=base.tick_period)

    ev = make().run()
    drv = TorchFabricSimulation(from_simulations([make(), build_simulation(sc)]),
                                device="cpu", fused_step=route)
    C0, P0 = drv.C, drv.P
    out = drv.run()[0]
    assert drv.C > C0 and drv.P > P0 and drv.C <= port_driver.MAX_COLUMNS
    assert (out.n_moves, out.total_bytes) == (ev.n_moves, ev.total_bytes)
    assert _rel(out.throughput, ev.throughput) <= 1e-9


def test_compaction_with_custom_rows_live(monkeypatch):
    """A batch wider than the compaction floor whose short built-in rows
    finish while its custom rows still run: the compacting run (the
    callbacks reach each row by its new index) equals one that never
    compacts, bit for bit."""
    names = port_batch(0)[1] + port_batch(1)[1]

    def run():
        drv = TorchFabricSimulation(
            from_simulations(port_batch(0)[0] + port_batch(1)[0], names), device="cpu",
            fused_step="none",
        )
        live_custom = []
        orig = drv._compact

        def counted(alive):
            live_custom.append(int((alive & (drv.kind == tr.KIND_CUSTOM)).sum()))
            orig(alive)

        drv._compact = counted
        return drv.run(), live_custom

    assert len(names) > port_driver.COMPACT_FLOOR
    compacted, live_custom = run()
    assert live_custom and live_custom[0] > 0, live_custom
    monkeypatch.setattr(port_driver, "COMPACT_FLOOR", 10**9)
    whole, none = run()
    assert not none
    for x, y in zip(compacted, whole):
        assert (x.total_time, x.n_events, x.n_moves, x.per_chunk_bytes, x.per_chunk_time) == (
            y.total_time, y.n_events, y.n_moves, y.per_chunk_bytes, y.per_chunk_time)


def test_custom_rows_and_shared_fabrics_do_not_mix():
    from repro_torch.eval.fabric.shared import SharedFabric

    sims, names, _ = port_batch()
    plan = from_simulations(sims[:4], names[:4])
    plan.fabrics = [SharedFabric(group="g", links=("bb",), capacity=(1e9,))] + [None] * 3
    with pytest.raises(ValueError, match="custom"):
        TorchFabricSimulation(plan, device="cpu")
