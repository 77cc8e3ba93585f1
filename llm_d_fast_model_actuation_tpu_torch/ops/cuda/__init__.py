"""Hand-written Hopper kernels of the serving path (sources in ``csrc/``).

The counterpart of the JAX package's ``ops/pallas/``: each module holds a
kernel's launch wrapper beside the plain PyTorch version of the same
function. A wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors, and counts its kernel launches in ``launches`` (eager
ones: a launch into a CUDA graph capture runs nothing and is not counted).
:func:`kernel_launches` reads them all.
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
from .w8a16 import (  # noqa: F401
    w8a16_matmul,
    w8a16_matmul_experts,
    w8a16_matmul_experts_plain,
    w8a16_matmul_plain,
)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, by the name ``chip_smoke.py`` reports it
    under; its ``launches`` counts its eager launches."""
    return {
        "probe": launch_probe,
        "decode_inline": paged_decode_attention_inline,
        "decode_scatter_first": paged_decode_attention,
        "prefill": causal_prefill_attention,
        "ragged": ragged_paged_attention,
        "ragged_sharded": ragged_paged_attention_sharded,
        "w8a16": w8a16_matmul,
        "w8a16_experts": w8a16_matmul_experts,
    }


def kernel_launches() -> dict:
    """This process's eager launches by wrapper, and by shape where a
    wrapper counts them so (prefill by padded sequence, ragged by buffer
    rows, the W8A16 products by weight shape)."""
    counts = {k: fn.launches for k, fn in kernel_wrappers().items()}
    counts["prefill_by_seq"] = dict(causal_prefill_attention.launches_by_seq)
    counts["ragged_by_rows"] = dict(ragged_paged_attention.launches_by_rows)
    counts["ragged_sharded_by_rows"] = dict(ragged_paged_attention_sharded.launches_by_rows)
    counts["w8a16_by_shape"] = dict(w8a16_matmul.launches_by_shape)
    counts["w8a16_experts_by_shape"] = dict(w8a16_matmul_experts.launches_by_shape)
    return counts
