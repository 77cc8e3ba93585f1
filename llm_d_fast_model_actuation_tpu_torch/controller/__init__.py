"""The control plane: dual-pods controller + launcher populator.

The port of the JAX package's ``controller/`` for NVIDIA cards. The
reference's controllers (`pkg/controller/dual-pods`, 3.7k LoC Go;
`pkg/controller/launcher-populator`, 3.0k LoC Go) re-designed as asyncio
reconcilers over a pluggable *cluster store*:

  * :class:`~.store.InMemoryStore` — a kube-API-shaped ACID store with
    resourceVersions, finalizers, deletion timestamps, label selection, and
    watch streams; :class:`~.kubestore.KubeStore` is the same interface
    against a kube-apiserver;
  * binding state is externalized to object annotations exactly as the
    reference does (controller restart recovery = re-reading annotations).

No module here imports torch: the controller drives engines only over
HTTP (``clients.py``).
"""

from .store import Conflict, InMemoryStore, NotFound  # noqa: F401
from .dualpods import DualPodsController, DualPodsConfig  # noqa: F401
