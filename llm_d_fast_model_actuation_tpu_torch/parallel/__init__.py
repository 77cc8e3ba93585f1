"""Parallelism: the tensor-parallel mesh and its two collectives
(``mesh``, which imports torch), and card identity (``topology``, which
does not: the control plane reads the gpu-map through it). Import the
module you need; the package itself imports neither."""
