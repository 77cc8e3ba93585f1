"""The PyTorch/CUDA port of llm-d-fast-model-actuation for one NVIDIA H100.

A second package beside ``llm_d_fast_model_actuation_tpu`` (the JAX
reference it is held against): the same module tree (``ops/``,
``models/``, ``engine/``), PyTorch idiom inside. This slice carries the
main serving path end to end:

* a Llama-family decoder over a paged KV cache, with the two attention
  kernels of that path written by hand for Hopper (``csrc/*.cu``, built
  with ``nvcc`` at first use and bound with ``ctypes``);
* the bucketed continuous-batching engine with prefix caching;
* level-1 sleep/wake (weights and KV to pinned host memory and back);
* a minimal standard-library HTTP server (``engine/server.py``);
* tensor-parallel serving (``parallel/mesh.py``): one process drives
  ``tp`` ranks, each with its slice of the weights and of the KV cache,
  and the ragged kernel is launched once per rank over its heads.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); with no card and no explicit CPU request they raise.
The package imports ``torch``, never ``jax`` and nothing of the JAX
package.
"""

__version__ = "0.1.0"
