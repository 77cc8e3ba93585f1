"""The port's copy of the JAX package's ``api/``: the dual-pods contract's
names (``constants``), the requester SPI's paths (``spi``) and the typed
objects (``types``), ported by meaning where a TPU notion has a GPU one."""

from .constants import *  # noqa: F401,F403
from .types import (  # noqa: F401
    AcceleratorSpec,
    EngineServerConfig,
    InferenceServerConfig,
    InferenceServerConfigSpec,
    LauncherConfig,
    LauncherConfigSpec,
    LauncherPopulationPolicy,
    LauncherPopulationPolicySpec,
    ObjectMeta,
    ServerRequestingPodStatus,
    SleepState,
    Status,
)
