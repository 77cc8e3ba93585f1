"""Admission rules: the deploy/policies CEL, executable in Python.

The port's copy of the JAX package's ``admission.py``, over the port's own
``api/constants``, ``controller/directpath`` and ``api/types``. Two uses:
(1) a unit-testable source of truth for what the cluster policies enforce
(``deploy/policies/*.yaml`` mirror these semantics: the reference's
``fma-immutable-fields`` and ``fma-bound-serverreqpod``,
config/validating-admission-policies/fma-immutable-fields.yaml:1-33);
(2) structural validation of the three CRD kinds for clients and tests
without an apiserver.

Ported by meaning for GPUs: the reference checks an ISC's TPU slice
topology against its chip count (the global slice holds chips x hosts
chips). A host's NVIDIA cards have no slice topology, and an engine spans
one host until multi-host gangs are ported (ROADMAP queue 1 item 15), so
an ISC that names a topology or more than one host is refused with the
messages ``api/types.py:AcceleratorSpec.validate`` gives the controller;
``chips`` counts cards.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

from .api import constants as C
from .api.types import AcceleratorSpec, parse_quantity
from .controller.directpath import LAST_USED_ANNOTATION, NOMINAL_HASH_ANNOTATION

#: Service accounts allowed to touch FMA-managed metadata
#: (fma-immutable-fields.yaml's serviceAccountMatch).
FMA_CONTROLLER_SA = re.compile(r"^system:serviceaccount:[^:]+:[^:]*-fma-controllers$")

#: Pod metadata the controllers own (frozen for everyone else).
PROTECTED_ANNOTATIONS = (
    C.REQUESTER_ANNOTATION,
    C.INSTANCE_ID_ANNOTATION,
    C.SERVER_PORT_ANNOTATION,
    C.ENGINE_CONFIG_ANNOTATION,
    C.ISC_ROUTING_METADATA_ANNOTATION,
    C.ACCELERATORS_ANNOTATION,
    C.STATUS_ANNOTATION,
    NOMINAL_HASH_ANNOTATION,
    LAST_USED_ANNOTATION,
)
PROTECTED_LABELS = (C.DUAL_LABEL, C.INSTANCE_LABEL, C.SLEEPING_LABEL)

#: Annotations frozen on a BOUND requester (they define the committed
#: actuation; editing them mid-binding desyncs the provider).
BOUND_ACTUATION_ANNOTATIONS = (
    C.SERVER_PATCH_ANNOTATION,
    C.INFERENCE_SERVER_CONFIG_ANNOTATION,
    C.ADMIN_PORT_ANNOTATION,
)


def is_fma_controller(username: str) -> bool:
    return bool(FMA_CONTROLLER_SA.match(username))


def _get(obj: Dict[str, Any], section: str, key: str) -> str:
    return ((obj.get("metadata") or {}).get(section) or {}).get(key, "")


def validate_pod_update(old: Dict[str, Any], new: Dict[str, Any], username: str) -> List[str]:
    """The two Pod policies; returns denial messages (empty = admitted)."""
    if is_fma_controller(username):
        return []
    errors: List[str] = []
    for key in PROTECTED_ANNOTATIONS:
        if _get(old, "annotations", key) != _get(new, "annotations", key):
            errors.append(f"annotation {key} is FMA-managed and may only be changed by the FMA controllers")
    for key in PROTECTED_LABELS:
        if _get(old, "labels", key) != _get(new, "labels", key):
            errors.append(f"label {key} is FMA-managed and may only be changed by the FMA controllers")
    # bound requester: actuation annotations frozen
    is_requester = _get(old, "annotations", C.SERVER_PATCH_ANNOTATION) or _get(
        old, "annotations", C.INFERENCE_SERVER_CONFIG_ANNOTATION
    )
    if is_requester and _get(old, "labels", C.DUAL_LABEL):
        for key in BOUND_ACTUATION_ANNOTATIONS:
            if _get(old, "annotations", key) != _get(new, "annotations", key):
                errors.append(f"annotation {key} is frozen while the requester is bound")
    return errors


# --------------------------------------------------------- CRD validation


def validate_isc(obj: Dict[str, Any]) -> List[str]:
    errors: List[str] = []
    spec = obj.get("spec") or {}
    msc = spec.get("modelServerConfig")
    if not isinstance(msc, dict):
        return ["spec.modelServerConfig is required"]
    port = msc.get("port")
    if not isinstance(port, int) or not (1 <= port <= 65535):
        errors.append("spec.modelServerConfig.port must be an integer in 1..65535")
    acc = msc.get("accelerator") or {}
    chips = acc.get("chips", 1)
    if not isinstance(chips, int) or chips < 1:
        errors.append("spec.modelServerConfig.accelerator.chips must be >= 1")
    hosts = acc.get("hosts", 1)
    if not isinstance(hosts, int) or hosts < 1:
        errors.append("spec.modelServerConfig.accelerator.hosts must be >= 1")
        hosts = 1
    # the reference's slice-topology rule, for cards: no topology, one host
    errors += AcceleratorSpec(topology=acc.get("topology", "") or "", hosts=hosts).validate()
    for section in ("labels", "annotations", "env_vars"):
        val = msc.get(section)
        if val is not None and not (
            isinstance(val, dict) and all(isinstance(k, str) and isinstance(v, str) for k, v in val.items())
        ):
            errors.append(f"spec.modelServerConfig.{section} must map string->string")
    return errors


def validate_lc(obj: Dict[str, Any]) -> List[str]:
    errors: List[str] = []
    spec = obj.get("spec") or {}
    if not isinstance(spec.get("podTemplate"), dict):
        errors.append("spec.podTemplate is required")
    max_instances = spec.get("maxInstances", 1)
    if not isinstance(max_instances, int) or max_instances < 1:
        errors.append("spec.maxInstances must be >= 1")
    return errors


def validate_lpp(obj: Dict[str, Any]) -> List[str]:
    errors: List[str] = []
    spec = obj.get("spec") or {}
    if not isinstance(spec.get("nodeSelector"), dict):
        errors.append("spec.nodeSelector is required")
    cfl = spec.get("countForLauncher")
    if not isinstance(cfl, list) or not cfl:
        errors.append("spec.countForLauncher must be a non-empty list")
        return errors
    for i, entry in enumerate(cfl):
        if not isinstance(entry, dict):
            errors.append(f"spec.countForLauncher[{i}] must be an object")
            continue
        if not entry.get("launcherConfigName"):
            errors.append(f"spec.countForLauncher[{i}].launcherConfigName is required")
        count = entry.get("launcherCount")
        if not isinstance(count, int) or count < 0:
            errors.append(f"spec.countForLauncher[{i}].launcherCount must be >= 0")
    ranges = ((spec.get("nodeSelector") or {}).get("allocatableResources")) or {}
    for res, rng in ranges.items():
        lo, hi = (rng or {}).get("min"), (rng or {}).get("max")
        try:
            lo_v = parse_quantity(lo) if lo is not None else None
            hi_v = parse_quantity(hi) if hi is not None else None
            if lo_v is not None and hi_v is not None and lo_v > hi_v:
                errors.append(f"allocatableResources[{res}]: min > max")
        except (ValueError, TypeError):
            errors.append(f"allocatableResources[{res}]: unparsable quantity")
    return errors


_VALIDATORS = {
    "InferenceServerConfig": validate_isc,
    "LauncherConfig": validate_lc,
    "LauncherPopulationPolicy": validate_lpp,
}


def validate(obj: Dict[str, Any]) -> List[str]:
    """Dispatch on kind; unknown kinds are admitted (no opinion)."""
    fn = _VALIDATORS.get(obj.get("kind", ""))
    return fn(obj) if fn else []


def review(request: Dict[str, Any]) -> Dict[str, Any]:
    """AdmissionReview-shaped entry point (for a webhook deployment):
    request = {object, oldObject?, userInfo: {username}, operation}."""
    op = request.get("operation", "CREATE")
    obj = request.get("object") or {}
    if obj.get("kind") == "Pod" and op == "UPDATE":
        errors = validate_pod_update(
            request.get("oldObject") or {}, obj, ((request.get("userInfo") or {}).get("username", ""))
        )
    else:
        errors = validate(obj)
    return {"allowed": not errors, **({"status": {"message": "; ".join(errors)}} if errors else {})}
