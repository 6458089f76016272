"""The event simulator in lockstep for shared-fabric groups: the coupled
ground truth.

One :class:`repro_torch.core.simulator.Simulation` runs one transfer at a
time; tenants that share links need one clock. :func:`run_coupled_group`
drives a group's Simulations in lockstep and recomputes the link shares at
every event:

  1. every live tenant reports its demand
     (:meth:`Simulation.transfer_demand`: its uncoupled pool, clipped to
     what its transferring channels can carry);
  2. one :func:`repro_torch.eval.fabric.kernels.waterfill_coupled` call,
     the function every sweep route runs, turns the demands and the
     group's (links x tenants) table into grants;
  3. each tenant's horizon under its grant (:meth:`Simulation.next_dt`),
     the group's minimum ``D``, and every live tenant steps with
     ``step(max_dt=D, bandwidth=grant)``.

A tenant whose own horizon lies past ``D`` takes a partial advance that
crosses no completion, feed or tick threshold. A done tenant stops
stepping and offers zero demand, which releases its share.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from repro_torch.core.simulator import SimResult, Simulation

from . import kernels
from .shared import SharedFabric, resolve_fabric


def run_coupled_group(
    sims: Sequence[Simulation],
    fabrics: Sequence[Optional[SharedFabric]],
) -> List[SimResult]:
    """Run one fabric group of Simulations to completion in lockstep."""
    fab = resolve_fabric(fabrics)
    member = torch.from_numpy(fab.member)
    link_cap = torch.from_numpy(fab.link_cap)
    n = len(sims)
    for s in sims:
        s.start()
    while not all(s.done for s in sims):
        demand = torch.zeros(n, dtype=torch.float64)
        for i, s in enumerate(sims):
            if not s.done:
                demand[i] = s.transfer_demand()[1]
        x = kernels.waterfill_coupled(demand, member, link_cap)[0].tolist()
        horizon = math.inf
        for i, s in enumerate(sims):
            if not s.done:
                horizon = min(horizon, s.next_dt(bandwidth=x[i]))
        for i, s in enumerate(sims):
            if not s.done:
                s.step(max_dt=horizon, bandwidth=x[i])
    return [s.result() for s in sims]


def run_event_coupled(scenarios: Sequence) -> List[SimResult]:
    """Event results of a matrix that holds coupled rows, in input order:
    an uncoupled row runs its own event loop, the rows of each fabric group
    run through :func:`run_coupled_group`."""
    from ..scenarios import build_simulation

    results: List[Optional[SimResult]] = [None] * len(scenarios)
    groups: dict = {}
    for i, sc in enumerate(scenarios):
        if sc.shared_fabric is None:
            results[i] = build_simulation(sc).run()
        else:
            groups.setdefault(sc.shared_fabric.group, []).append(i)
    for idxs in groups.values():
        sims = [build_simulation(scenarios[i]) for i in idxs]
        out = run_coupled_group(sims, [scenarios[i].shared_fabric for i in idxs])
        for i, res in zip(idxs, out):
            results[i] = res
    return results  # type: ignore[return-value]
