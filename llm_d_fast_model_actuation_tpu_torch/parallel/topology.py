"""Card identity: the gpu-map, and the environment that pins a process
to cards.

The GPU counterpart of the JAX package's ``parallel/topology.py``. A TPU
host's chips have ICI coordinates and a slice shape, and placement must
respect them; a host's NVIDIA cards are a flat list, any subset of which
may serve together. So a card is only (UUID, index): its UUID names it on
the wire (``gpu_uuids``, the requester's accelerator list), its index is
its place in PCI bus order, which ``CUDA_VISIBLE_DEVICES`` takes when
``CUDA_DEVICE_ORDER=PCI_BUS_ID`` is set.

The reference's ``gpu-map`` ConfigMap (controller.go:888-924) maps each
node to lines ``<index> <uuid>``. :func:`parse_gpu_map` is the one parser
of it, read by the launcher's translator (``launcher/chiptranslator.py``)
and by the direct path (``controller/directpath.py``). It also reads the
JAX package's chip-map (``<index> <id> <x,y[,z]>`` and its
``topology:``, ``origin:`` and ``slice:`` lines): coordinates and those
lines are ignored, so one fixture drives either package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..api import constants as C

#: lines of the JAX package's chip-map that a card has no use for
_SKIPPED = ("topology:", "origin:", "slice:")


def parse_gpu_map(data: Dict[str, str]) -> Dict[str, List[Tuple[str, int]]]:
    """node -> [(uuid, index)] from a gpu-map ConfigMap's data, in the
    order of its lines."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for node, text in data.items():
        cards = []
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts or parts[0] in _SKIPPED:
                continue
            cards.append((parts[1], int(parts[0])))
        out[node] = cards
    return out


def indices_for(cards: Sequence[Tuple[str, int]], uuids: Sequence[str]) -> List[int]:
    """``uuids`` -> their indices among one node's ``cards``, in request
    order; KeyError naming the first unknown UUID."""
    index = dict(cards)
    missing = [u for u in uuids if u not in index]
    if missing:
        raise KeyError(missing[0])
    return [index[u] for u in uuids]


def visible_devices_env(indices: Sequence[int]) -> Dict[str, str]:
    """The env that shows a process exactly the cards at ``indices`` (PCI
    bus order), in the order given."""
    return {
        C.VISIBLE_DEVICES_ENV: ",".join(str(i) for i in indices),
        C.DEVICE_ORDER_ENV: C.DEVICE_ORDER,
    }
