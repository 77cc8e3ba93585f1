"""The serving engine of the port: paged KV cache, continuous batching,
level-1/2 sleep/wake and the minimal HTTP server (``server.py``)."""

from .engine import EngineConfig, InferenceEngine  # noqa: F401
from .kv_cache import PageAllocator, PagePool  # noqa: F401
from .sleep import SleepLevel, SleepManager, attach_sleep  # noqa: F401
