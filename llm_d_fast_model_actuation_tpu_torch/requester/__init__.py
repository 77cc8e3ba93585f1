"""The requester stub: the process inside a server-requesting Pod.

The port of the JAX package's ``requester/`` for NVIDIA cards. The
requesting Pod holds the cards in the scheduler's eyes but does no
inference; this stub (reference: `cmd/requester`, `pkg/server/requester`)
serves two HTTP planes, on asyncio streams:

  * **SPI server** (port $SPI_PORT, default 8081) — the dual-pods controller's
    window into the Pod: which cards the Pod was allocated (NVML UUIDs),
    their memory in use, readiness setters, and a relayed-log sink;
  * **probes server** (port $PROBES_PORT, default 8080) — `/ready` backed by
    the controller-set readiness bool; the kubelet's readiness probe target,
    which is how engine readiness is relayed to everything watching the Pod.
"""

from .spi import LogSink, SpiServer  # noqa: F401
from .probes import ProbesServer  # noqa: F401
