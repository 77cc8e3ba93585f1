"""Gang planning: one engine whose ranks span several nodes' cards.

Port of ``llm_d_fast_model_actuation_tpu/parallel/multihost.py``, by
meaning for NVIDIA cards. There a TPU slice bigger than one host is served
by ONE engine running as N coordinated processes, one per host; here a
tensor-parallel engine wider than one node's cards is the same thing, a
GANG of engine processes, one per node, each opening its own cards and
joined by a ``torch.distributed`` group (``engine/multihost.py``,
``parallel/mesh.py``). This module is the pure planning layer:

  * which nodes, in which process order;
  * which cards each process opens (their UUIDs, in index order);
  * the coordination env each engine child needs
    (``FMA_NUM_PROCESSES`` / ``FMA_PROCESS_ID`` /
    ``FMA_COORDINATOR_ADDRESS``, byte for byte the JAX package's keys:
    the launcher and the controller cross both packages).

What a card gang means, rule by rule against the JAX ``plan_slice``:

  * a member is a node holding the same number of cards as every other
    member (mixed counts are refused, as mixed host shapes are there);
  * the ISC's ``accelerator.chips`` is the GLOBAL card count, and must
    equal members x cards per member (a count that does not tile is
    refused);
  * a member's ``origin`` (the gpu-map's ``origin: a[,b...]`` line,
    ``parallel/topology.py:gang_places``) orders the gang: process 0 is
    the member at the zero corner, the rest follow in lexicographic order
    of their origins (missing trailing coordinates count as 0). Two
    members at one origin are refused, and so is a gang with no member
    at the zero corner;
  * the TPU slice's own geometry has no card meaning: there is no slice
    shape to align an origin to or to bound it by, so a ``topology``
    request is refused by name (:class:`SlicePlanError`), never read as a
    card count. The topology refusal of ``api/types.py`` stands.

The gang lifecycle (grouping requesters, stamping plans, degrading on
member loss) lives in ``controller/gang.py``; the engine side in
``engine/server.py`` (the group joined before any device is touched).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

#: Base port of the coordination store the process-0 engine child binds
#: (distinct from the serving port). The gang coordinator derives a
#: per-gang port from it, so a lingering (asleep) member of a dead gang
#: cannot block the next gang's bind.
COORDINATOR_PORT = 8476


class SlicePlanError(ValueError):
    """The offered nodes cannot realise the requested gang."""


@dataclass(frozen=True)
class HostAssignment:
    """One node's share of a gang."""

    node: str
    process_id: int
    origin: Tuple[int, ...]  #: the member's place in the gang order
    chip_ids: Tuple[str, ...]  #: card UUIDs this process opens, index order


@dataclass(frozen=True)
class SlicePlan:
    """An ordered gang of node assignments serving one engine."""

    chips: int  #: the global card count
    hosts: Tuple[HostAssignment, ...]  #: ordered by process_id

    @property
    def num_processes(self) -> int:
        return len(self.hosts)

    @property
    def coordinator_node(self) -> str:
        return self.hosts[0].node

    def assignment_for(self, node: str) -> Optional[HostAssignment]:
        for h in self.hosts:
            if h.node == node:
                return h
        return None

    def coordination_env(self, process_id: int, coordinator_ip: str, port: int = COORDINATOR_PORT) -> Dict[str, str]:
        """Env for one engine child. The engine reads these (or the
        equivalent flags) and joins the gang's process group before it
        touches a device; the join blocks until every member joins, so
        per-member "serving" implies the whole gang formed."""
        return {
            "FMA_NUM_PROCESSES": str(self.num_processes),
            "FMA_PROCESS_ID": str(process_id),
            "FMA_COORDINATOR_ADDRESS": f"{coordinator_ip}:{port}",
        }


def _card_count(requested) -> int:
    if not isinstance(requested, int) or isinstance(requested, bool):
        raise SlicePlanError(
            f"slice topology {requested!r} refused: a gang of cards is planned by its global card count "
            "(accelerator.chips); a TPU slice's shape, and the origin alignment and bounds it implies, have "
            "no meaning for NVIDIA cards"
        )
    if requested < 1:
        raise SlicePlanError(f"a gang needs at least one card, got {requested}")
    return requested


def plan_slice(
    requested: int,
    members: Mapping[str, Tuple[Sequence[int], Sequence[Tuple[str, int]]]],
) -> SlicePlan:
    """Plan a gang of ``requested`` cards over ``members``: node ->
    (origin, cards), ``cards`` the node's ``(uuid, index)`` pairs as
    ``parallel/topology.py:parse_gpu_map`` gives them (those the member
    serves with). Raises :class:`SlicePlanError` unless the members tile
    the count with one card count each, at distinct origins, one of them
    the zero corner."""
    total = _card_count(requested)
    if not members:
        raise SlicePlanError("no member hosts offered")
    counts = {len(cards) for _, cards in members.values()}
    if len(counts) != 1:
        raise SlicePlanError(f"member hosts have mixed card counts: {sorted(counts)}")
    per_host = counts.pop()
    if per_host < 1:
        raise SlicePlanError("member hosts offer no cards")
    if per_host * len(members) != total:
        raise SlicePlanError(f"{len(members)} hosts x {per_host} cards != {total} cards")

    rank = max(len(tuple(o)) for o, _ in members.values()) or 1
    origins: Dict[str, Tuple[int, ...]] = {}
    seen: Dict[Tuple[int, ...], str] = {}
    for node in sorted(members):
        o = tuple(int(x) for x in members[node][0])
        if any(x < 0 for x in o):
            raise SlicePlanError(f"{node}: origin {o} has a negative coordinate")
        o = o + (0,) * (rank - len(o))
        if o in seen:
            raise SlicePlanError(f"{node} and {seen[o]} share gang origin {o}")
        seen[o] = node
        origins[node] = o

    ordered = sorted(members, key=lambda n: origins[n])
    zero = (0,) * rank
    if origins[ordered[0]] != zero:
        raise SlicePlanError(f"no host at gang origin {zero}; lowest is {origins[ordered[0]]}")
    hosts = tuple(
        HostAssignment(
            node=node,
            process_id=pid,
            origin=origins[node],
            chip_ids=tuple(uuid for uuid, _ in sorted(members[node][1], key=lambda c: c[1])),
        )
        for pid, node in enumerate(ordered)
    )
    return SlicePlan(chips=total, hosts=hosts)


def hosts_needed(requested: int, cards_per_host: int) -> int:
    """How many nodes of ``cards_per_host`` cards a gang of ``requested``
    cards needs (1 = one node)."""
    total = _card_count(requested)
    if cards_per_host <= 0 or total % cards_per_host != 0:
        raise SlicePlanError(f"{total} cards not tileable by hosts of {cards_per_host} cards")
    return total // cards_per_host
