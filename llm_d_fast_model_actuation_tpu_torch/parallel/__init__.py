"""Parallelism: the mesh over dp, pp, sp, tp and ep, its collectives and
its pipeline stages (``mesh``, which imports torch), and card identity
(``topology``, which does not: the control plane reads the gpu-map
through it). Import the module you need; the package itself imports
neither."""
