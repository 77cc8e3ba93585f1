"""Hand-written Hopper kernels of the serving path (sources in ``csrc/``).

The counterpart of the JAX package's ``ops/pallas/``: each module holds a
kernel's launch wrapper beside the plain PyTorch version of the same
function. A wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors, and counts its kernel launches in ``launches`` (eager
ones: a launch into a CUDA graph capture runs nothing and is not counted).
"""

from .build import launch_probe, launch_probe_plain  # noqa: F401
from .decode import (  # noqa: F401
    paged_decode_attention,
    paged_decode_attention_inline,
    paged_decode_attention_inline_plain,
    paged_decode_attention_plain,
)
from .prefill import (  # noqa: F401
    causal_prefill_attention,
    causal_prefill_attention_plain,
)
from .ragged import (  # noqa: F401
    RAGGED_BLOCK,
    ragged_paged_attention,
    ragged_paged_attention_plain,
    ragged_paged_attention_sharded,
    ragged_paged_attention_sharded_plain,
)
