"""Parallelism: the mesh over dp, sp, tp and ep and its collectives
(``mesh``, which imports torch), and card identity (``topology``, which
does not: the control plane reads the gpu-map through it). Import the
module you need; the package itself imports neither."""
