"""``scenarios.timeline_matrix`` and the sweep's timeline rings on the CPU.

The grid is the smoke cross-section with every row recording its
(t, aggregate rate) timeline, named as the reference's ``timeline_matrix``.
Each route's ring is held to the event leg's host-appended samples by the
reference's rule (``tests/test_timeline_ring.py``: every ring sample matches
an event sample in order within rtol 1e-9, atol 1e-6; the first sample
equal, the last within the same limits, the lengths within 5% or 2; a
route that counts more events than the event leg, where its bisected water
level splits a boundary the scalar loop takes as one, may leave that many
zero-dt samples unmatched: one row of this grid, one sample), and the
closed-form split route to the reference's NumPy ``FabricSimulation``:
the same sample times, exactly, and rates within 1e-12 relative (the rate
sums run in another order).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro_torch.eval.runner import run_matrix
from repro_torch.eval.scenarios import smoke_matrix, timeline_matrix


def _assert_ordered_submatch(sub, full, name, rtol=1e-9, atol=1e-6, spare=0):
    """Every (t, rate) of ``sub`` matches some sample of ``full``, in
    order (the reference's rule: the fluid routes may coalesce a zero-dt
    event boundary the scalar loop splits in two). ``spare``: how many of
    ``sub``'s samples at a zero-dt boundary (at the time of the next
    sample) may go unmatched, for a route that counts that many more events
    than the event leg: its bisected water level splits a boundary the
    scalar loop takes as one. Returns the unmatched samples."""

    def close(a, b):
        return all(abs(x - y) <= atol + rtol * abs(y) for x, y in zip(a, b))

    i, unmatched = 0, []
    for j, s in enumerate(sub):
        k = i
        while k < len(full) and not close(s, full[k]):
            k += 1
        if k < len(full):
            i = k + 1
            continue
        zero_dt = j + 1 < len(sub) and abs(sub[j + 1][0] - s[0]) <= atol
        assert zero_dt and len(unmatched) < spare, (
            f"{name}: ring sample {s} not found in order in the event timeline"
        )
        unmatched.append(s)
    return unmatched


@pytest.fixture(scope="module")
def grid_and_event():
    scs = timeline_matrix()
    return scs, run_matrix(scs, backend="event")


def test_timeline_matrix_is_the_reference_grid():
    from repro.eval.scenarios import timeline_matrix as ref_timeline_matrix

    ours, ref = timeline_matrix(), ref_timeline_matrix()
    assert [s.name for s in ours] == [s.name for s in ref]
    assert all(s.record_timeline for s in ours)
    assert [dataclasses.replace(s, record_timeline=False) for s in ours] == smoke_matrix()
    assert [s.name for s in timeline_matrix(3)] == [s.name for s in ref_timeline_matrix(3)]


@pytest.mark.parametrize("route", ["rounds", "none"])
def test_rings_match_the_event_leg(grid_and_event, route):
    """Each ring against the event leg's samples; a row that counts more
    events than the event leg (the bisected level's split boundaries: one
    row of the grid, one event) may leave that many zero-dt samples
    unmatched, and no other row may."""
    scs, event = grid_and_event
    out = run_matrix(scs, device="cpu", fused_step=route)
    split = {}
    for sc, r, e in zip(scs, out, event):
        tr, te = r.timeline, e.timeline
        assert tr and te, sc.name
        assert abs(len(tr) - len(te)) <= max(2, len(te) // 20), sc.name
        assert tr[0] == te[0], sc.name
        np.testing.assert_allclose(np.asarray(tr[-1]), np.asarray(te[-1]), rtol=1e-9, atol=1e-6,
                                   err_msg=sc.name)
        spare = max(0, r.n_events - e.n_events)
        unmatched = _assert_ordered_submatch(tr, te, sc.name, spare=spare)
        if unmatched:
            split[sc.name] = len(unmatched)
    assert sum(split.values()) <= 1, split


def test_closed_split_route_rings_equal_the_reference_numpy_driver():
    from repro.eval.fabric.driver import FabricSimulation
    from repro.eval.scenarios import build_simulation as ref_build
    from repro.eval.scenarios import timeline_matrix as ref_timeline_matrix

    ref_scs = ref_timeline_matrix()
    want = FabricSimulation([ref_build(s) for s in ref_scs], names=[s.name for s in ref_scs]).run()
    got = run_matrix(timeline_matrix(), device="cpu", fused_step="none", waterfill_impl="closed")
    for sc, a, b in zip(ref_scs, got, want):
        ta, tb = np.asarray(a.timeline), np.asarray(b.timeline)
        assert ta.shape == tb.shape, sc.name
        np.testing.assert_array_equal(ta[:, 0], tb[:, 0], err_msg=sc.name)
        np.testing.assert_allclose(ta[:, 1], tb[:, 1], rtol=1e-12, atol=0.0, err_msg=sc.name)
