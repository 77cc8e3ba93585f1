"""Requester-stub SPI: the HTTP contract served inside the requesting Pod.

Parity with reference `pkg/spi/interface.go:29-61`, the paths copied as
the JAX package has them. The dual-pods controller is the client; the
requester stub (``requester/``) is the server.
"""

#: GET -> 200 with a JSON array of strings, each identifying one card in a
#: way appropriate for the software accessing the cards (NVML's UUIDs,
#: "GPU-<uuid>").
ACCELERATOR_QUERY_PATH = "/v1/dual-pods/accelerators"

#: GET -> JSON object {uuid: bytes of the card's memory in use}.
ACCELERATOR_MEMORY_QUERY_PATH = "/v1/dual-pods/accelerator-memory-usage"

#: POST -> set readiness true (relayed to the kubelet via the probes server).
BECOME_READY_PATH = "/v1/become-ready"

#: POST -> set readiness false.
BECOME_UNREADY_PATH = "/v1/become-unready"

#: GET -> 200/503 from the readiness bool (kubelet readiness probe target).
READY_PATH = "/ready"

#: POST text/plain chunk of the engine's log, with query param
#: :data:`LOG_START_POS_PARAM` = 0-based start offset; the requester keeps
#: only new content (dedups overlaps), 400 if startPos is beyond the end.
SET_LOG_PATH = "/v1/set-log"

LOG_START_POS_PARAM = "startPos"
