"""Parallelism: the tensor-parallel mesh and its two collectives."""

from .mesh import (  # noqa: F401
    AXES,
    LOGICAL_RULES,
    MeshPlan,
    TpMesh,
    make_mesh,
    plan_for_devices,
    serving_mesh,
    shard,
    spec_for,
    tp_dim,
)
