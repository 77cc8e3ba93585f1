"""The launcher: node-local engine-instance manager with a REST API.

The port of the JAX package's ``launcher/`` for NVIDIA cards: it preloads
torch and the port's engine modules into a fork server once, then forks
the port's engine server (``engine/server.py:run_server``) as instances
on demand, each pinned to the cards a controller names (``gpu_uuids`` ->
``CUDA_VISIBLE_DEVICES``); it detects a child's death with zero polling
through its process sentinel, restarts it under a budget, and speaks the
reference's REST surface (``/v2/vllm/instances`` CRUDL, NDJSON watch with
revisions and 410 resync, ranged log reads) so the reference's
controllers drive it unchanged.

On a GPU, engines time-share a card: a create on cards whose holder is
awake is refused, and allowed once every holder sleeps (``manager.py``).
"""

from .chiptranslator import ChipTranslator  # noqa: F401
from .instance import EngineInstance, HalfMade  # noqa: F401
from .manager import EngineProcessManager  # noqa: F401
