"""Card identity: the ids a controller names (``gpu_uuids``) to local
indices, and the environment that pins an engine child to them.

The port of the JAX package's ``launcher/chiptranslator.py``, with its
three modes, highest priority first:

  1. **chip-map mock** — the same chip-map file the JAX translator reads
     (a ConfigMap-shaped JSON object, node -> lines ``<index> <id>
     [x,y[,z]]``, keyed by ``NODE_NAME``); coordinates and the
     ``topology:``, ``origin:`` and ``slice:`` lines are read and ignored;
  2. **naive mock** — N synthetic cards with the JAX translator's ids, so
     the same controller fixtures drive either launcher;
  3. **real** — the machine's cards through NVML (``native/nvml.py``),
     their UUIDs as ids. Without NVML it raises; it never falls back to a
     mock.

A GPU translator has no topology (any set of cards may serve together):
it holds a flat list of (id, index).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


class ChipTranslator:
    def __init__(self, chips: Sequence[Tuple[str, int]], mode: str) -> None:
        self._chips: List[Tuple[str, int]] = list(chips)
        self._index = dict(self._chips)
        self.mode = mode

    # -- constructors --------------------------------------------------------

    @classmethod
    def create(
        cls,
        mock_chips: bool = False,
        mock_chip_count: int = 8,
        mock_topology: str = "",
        chip_map_path: Optional[str] = None,
        node_name: Optional[str] = None,
    ) -> "ChipTranslator":
        """Mode selection, highest priority first: chip-map mock -> naive
        mock -> real cards."""
        if mock_chips:
            node = node_name or os.environ.get("NODE_NAME", "")
            path = chip_map_path or os.environ.get("CHIP_MAP_PATH", "")
            if node and path and os.path.exists(path):
                with open(path) as f:
                    chips = parse_chip_map(json.load(f)).get(node)
                if chips is not None:
                    logger.info("chip-map mock: node %s, %s cards", node, len(chips))
                    return cls(chips, mode="chip-map-mock")
                logger.warning("node %s not in chip map %s; naive fallback", node, path)
            chips = mock_chip_ids(mock_chip_count, mock_topology, node or "mock")
            logger.info("naive mock: %s cards", len(chips))
            return cls(chips, mode="naive-mock")
        return cls(_enumerate_real(), mode="real")

    # -- queries -------------------------------------------------------------

    def chip_ids(self) -> List[str]:
        return [cid for cid, _ in self._chips]

    def id_to_index(self, chip_id: str) -> int:
        if chip_id not in self._index:
            raise KeyError(f"unknown chip id {chip_id!r}")
        return self._index[chip_id]

    def env_for(self, chip_ids: Sequence[str]) -> Dict[str, str]:
        """Env vars pinning an engine process to ``chip_ids``: the cards'
        indices in PCI bus order (NVML's, which CUDA follows only when
        told to), sorted as the JAX translator sorts its chips, and the ids
        in request order. KeyError on an unknown id."""
        indices = [self._index[cid] for cid in chip_ids]
        return {
            "CUDA_VISIBLE_DEVICES": ",".join(str(i) for i in sorted(indices)),
            "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
            "FMA_CHIP_IDS": ",".join(chip_ids),
        }


def parse_chip_map(data: Dict[str, str]) -> Dict[str, List[Tuple[str, int]]]:
    """node -> [(id, index)] from a chip-map ConfigMap's data, as the JAX
    package's ``parallel/topology.py:ChipMap.parse`` reads it."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for node, text in data.items():
        chips = []
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts or parts[0] in ("topology:", "origin:", "slice:"):
                continue
            chips.append((parts[1], int(parts[0])))
        out[node] = chips
    return out


def mock_chip_ids(count: int, topology: str = "", node: str = "mock") -> List[Tuple[str, int]]:
    """The naive mock's (id, index) pairs, the JAX translator's: ids
    ``tpu-<node>-<coords>`` over ``topology`` (default: rows of four
    from eight cards on, else one row), indices in row-major order."""
    dims = [int(d) for d in (topology or _default_topology(count)).lower().split("x")]
    chips = []
    n = 1
    for d in dims:
        n *= d
    for i in range(n):
        coords, rest = [], i
        for d in reversed(dims):
            coords.append(rest % d)
            rest //= d
        chips.append((f"tpu-{node}-" + "-".join(str(c) for c in reversed(coords)), i))
    return chips


def _default_topology(n: int) -> str:
    if n >= 8 and n % 4 == 0:
        return f"{n // 4}x4"
    return str(n)


def _enumerate_real() -> List[Tuple[str, int]]:
    """The machine's cards through NVML, by UUID and PCI bus index."""
    from ..native import nvml

    try:
        gpus = nvml.enumerate_gpus()
    except nvml.NvmlError as e:
        raise RuntimeError(
            f"no NVIDIA cards found ({e}); use --mock-chips for hardware-less operation"
        ) from e
    if not gpus:
        raise RuntimeError("NVML sees no NVIDIA card; use --mock-chips for hardware-less operation")
    return [(g["uuid"], g["index"]) for g in gpus]
