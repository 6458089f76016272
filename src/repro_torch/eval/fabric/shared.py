"""Shared-fabric coupling: scenario rows tied through link capacities.

A :class:`SharedFabric` attaches a scenario row to named backbone links of
finite capacity inside a named fabric *group*. Rows of one group are not
independent: every step first finds each row's uncoupled rate pool (link
bandwidth against the disk aggregate), then
:func:`repro_torch.eval.fabric.kernels.waterfill_coupled` shrinks the pools
of rows on saturated links to a max-min fair share over the group's
(links x rows) membership table, and the group advances in lockstep on its
members' earliest event. Groups never interact, even when their link
names collide: links are keyed ``(group, link)``.

The spec is a frozen value with tuple fields, so a ``Scenario`` stays
hashable with a fabric attached. :func:`resolve_fabric` lowers a per-row
``Optional[SharedFabric]`` column into the arrays the sweeps read:
``group_id`` (S,), the ``member`` (L, S) table and ``link_cap`` (L,).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

#: characters reserved by the scenario-name suffix grammar (``|fab:...``)
_RESERVED = ("|", ":")


@dataclasses.dataclass(frozen=True)
class SharedFabric:
    """One row's attachment to a coupled fabric group.

    ``links`` / ``capacity`` are parallel tuples naming the backbone links
    the row rides and their capacities in bytes/s. Capacity belongs to the
    link: every row of a group that declares a link must declare the same
    capacity (:func:`resolve_fabric` rejects a mismatch). ``tenant`` is a
    free label folded into the scenario name, so tenants that are
    otherwise the same matrix point keep unique names.
    """

    group: str
    links: Tuple[str, ...]
    capacity: Tuple[float, ...]
    tenant: str = ""

    def __post_init__(self):
        if not self.group:
            raise ValueError("SharedFabric.group must be non-empty")
        for label, value in (("group", self.group), ("tenant", self.tenant)):
            for ch in _RESERVED:
                if ch in value:
                    raise ValueError(
                        f"SharedFabric.{label} {value!r} contains reserved "
                        f"character {ch!r} (scenario-name suffix grammar)"
                    )
        if len(self.links) != len(self.capacity):
            raise ValueError(
                f"links/capacity length mismatch: {len(self.links)} links, "
                f"{len(self.capacity)} capacities"
            )
        if not self.links:
            raise ValueError(
                "SharedFabric needs at least one link (use "
                "shared_fabric=None for an uncoupled row)"
            )
        if len(set(self.links)) != len(self.links):
            raise ValueError(f"duplicate link names in {self.links!r}")
        for name, cap in zip(self.links, self.capacity):
            if not name:
                raise ValueError("link names must be non-empty")
            if not (cap > 0.0):
                raise ValueError(
                    f"link {name!r} capacity must be positive, got {cap!r}"
                )

    @property
    def name_suffix(self) -> str:
        """The scenario-name tag: ``fab:<group>`` (+ ``:<tenant>``)."""
        t = f":{self.tenant}" if self.tenant else ""
        return f"fab:{self.group}{t}"


@dataclasses.dataclass
class ResolvedFabric:
    """The array form of a batch's fabric column.

    ``group_id[r]`` is -1 for an uncoupled row, else a dense group index in
    order of first appearance; ``member[l, r]`` marks row r's membership of
    global link l, ``link_cap[l]`` its capacity. Links of different groups
    take disjoint global indices, so one table covers many independent
    groups.
    """

    group_id: np.ndarray  # (S,) int64, -1 == uncoupled
    member: np.ndarray  # (L, S) bool
    link_cap: np.ndarray  # (L,) float64
    n_groups: int

    @property
    def coupled(self) -> bool:
        return self.member.shape[0] > 0


def resolve_fabric(fabrics: Sequence[Optional[SharedFabric]]) -> ResolvedFabric:
    """Lower a per-row fabric column into dense coupling arrays."""
    S = len(fabrics)
    group_id = np.full(S, -1, dtype=np.int64)
    group_of: dict = {}
    link_of: dict = {}
    caps: list = []
    hits: list = []
    for r, fab in enumerate(fabrics):
        if fab is None:
            continue
        gid = group_of.setdefault(fab.group, len(group_of))
        group_id[r] = gid
        for name, cap in zip(fab.links, fab.capacity):
            key = (fab.group, name)
            li = link_of.get(key)
            if li is None:
                li = link_of[key] = len(caps)
                caps.append(float(cap))
            elif caps[li] != float(cap):
                raise ValueError(
                    f"link {name!r} of group {fab.group!r} declared with "
                    f"conflicting capacities {caps[li]!r} and {cap!r}"
                )
            hits.append((li, r))
    member = np.zeros((len(caps), S), dtype=bool)
    for li, r in hits:
        member[li, r] = True
    return ResolvedFabric(
        group_id=group_id,
        member=member,
        link_cap=np.asarray(caps, dtype=np.float64),
        n_groups=len(group_of),
    )
