"""Typed API objects (the CRD equivalents), the port's copy.

Parity map:
  InferenceServerConfig  -> api/fma/v1alpha1/inferenceserverconfig_types.go:24-107
  LauncherConfig         -> api/fma/v1alpha1/launcherconfig_types.go:26-101
  LauncherPopulationPolicy -> api/fma/v1alpha1/launcherpopulationpolicy_types.go:25-143

The JAX package's objects with the same ``from_dict``/``to_dict`` shapes
(camelCase JSON field names match the reference CRDs, so manifests port
verbatim). Ported by meaning: an :class:`AcceleratorSpec`'s ``chips``
counts cards, and the TPU slice topology (the JAX package's
``SliceTopology``) has no GPU counterpart — a set of cards on one host
serves together whatever their indices. An ISC that names a topology, or
more than one host, is refused by :meth:`AcceleratorSpec.validate`, and
the controller writes the refusal into the requester's status.

Quantities are plain ints/strings; the k8s ``resource.Quantity`` grammar is
handled by :func:`parse_quantity`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# -- k8s resource.Quantity ---------------------------------------------------

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+)([EPTGMk]i?|[munpf]|[eE][+-]?[0-9]+)?$")
_SUFFIX = {
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
    "m": 10**-3, "u": 10**-6, "n": 10**-9, "p": 10**-12, "f": 10**-15,
}


def parse_quantity(q: "int | float | str") -> float:
    """Parse a Kubernetes resource quantity ("4", "16Gi", "500m") to a float."""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {q!r}")
    base, suffix = m.groups()
    mult = 1.0
    if suffix:
        if suffix[0] in "eE" and suffix not in _SUFFIX and len(suffix) > 1:
            mult = 10 ** int(suffix[1:])
        else:
            mult = _SUFFIX[suffix]
    return float(base) * mult


# -- metadata ----------------------------------------------------------------


@dataclass
class ObjectMeta:
    """The subset of kube ObjectMeta the framework uses."""

    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    generation: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[Dict[str, Any]] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    creation_timestamp: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name}
        if self.namespace:
            d["namespace"] = self.namespace
        if self.uid:
            d["uid"] = self.uid
        if self.resource_version:
            d["resourceVersion"] = self.resource_version
        if self.generation:
            d["generation"] = self.generation
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.finalizers:
            d["finalizers"] = list(self.finalizers)
        if self.owner_references:
            d["ownerReferences"] = list(self.owner_references)
        if self.deletion_timestamp is not None:
            d["deletionTimestamp"] = self.deletion_timestamp
        if self.creation_timestamp is not None:
            d["creationTimestamp"] = self.creation_timestamp
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", ""),
            uid=d.get("uid", ""),
            resource_version=str(d.get("resourceVersion", "") or ""),
            generation=int(d.get("generation", 0) or 0),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            finalizers=list(d.get("finalizers") or []),
            owner_references=list(d.get("ownerReferences") or []),
            deletion_timestamp=d.get("deletionTimestamp"),
            creation_timestamp=d.get("creationTimestamp"),
        )


@dataclass
class Status:
    """Common CR status: reference *_types.go `{ObservedGeneration, Errors}`."""

    observed_generation: int = 0
    errors: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.observed_generation:
            d["observedGeneration"] = self.observed_generation
        if self.errors:
            d["errors"] = list(self.errors)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Status":
        return cls(
            observed_generation=int(d.get("observedGeneration", 0) or 0),
            errors=list(d.get("errors") or []),
        )


# -- accelerators ------------------------------------------------------------


@dataclass
class AcceleratorSpec:
    """The cards one engine instance needs."""

    #: Number of cards (the engine's tensor-parallel degree).
    chips: int = 1
    #: A TPU slice topology in the JAX package; a card has none, so a
    #: non-empty value is refused (:meth:`validate`). Kept so an ISC
    #: written for the JAX package parses and is refused by name.
    topology: str = ""
    #: Hosts the engine spans; only 1 runs here (:meth:`validate`).
    hosts: int = 1
    #: Whether the ISC explicitly declared an accelerator spec. Only then is
    #: placement validated against it (an absent spec accepts whatever the
    #: scheduler assigned, matching the reference's behavior).
    specified: bool = False

    def validate(self) -> List[str]:
        """What a GPU cannot honour in this spec, one message per field."""
        errors = []
        if self.topology:
            errors.append(
                f"accelerator.topology={self.topology} is refused: a GPU has no "
                "slice topology; give the number of cards in accelerator.chips"
            )
        if self.hosts > 1:
            errors.append(
                f"accelerator.hosts={self.hosts} is refused: an engine spans one "
                "host until multi-host gangs are ported (ROADMAP queue 1, item 15)"
            )
        return errors

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"chips": self.chips}
        if self.topology:
            d["topology"] = self.topology
        if self.hosts != 1:
            d["hosts"] = self.hosts
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AcceleratorSpec":
        return cls(
            chips=int(d.get("chips", 1) or 1),
            topology=d.get("topology", ""),
            hosts=int(d.get("hosts", 1) or 1),
            specified=bool(d),
        )


# -- InferenceServerConfig ---------------------------------------------------


@dataclass
class EngineServerConfig:
    """One engine instance's config (the reference's ModelServerConfig,
    inferenceserverconfig_types.go:35-62).

    ``options`` is the engine CLI option string passed through verbatim
    (e.g. ``--model meta-llama/Llama-3-8B --tensor-parallel-size 2``);
    ``labels``/``annotations`` are routing metadata stamped on the providing
    Pod only while bound and serving (deferred-routing invariant).
    """

    port: int = 8000
    options: str = ""
    env_vars: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    accelerator: AcceleratorSpec = field(default_factory=AcceleratorSpec)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"port": self.port}
        if self.options:
            d["options"] = self.options
        if self.env_vars:
            d["env_vars"] = dict(self.env_vars)
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        acc = self.accelerator.to_dict()
        if acc != {"chips": 1}:
            d["accelerator"] = acc
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineServerConfig":
        return cls(
            port=int(d.get("port", 8000) or 8000),
            options=d.get("options", ""),
            env_vars=dict(d.get("env_vars") or {}),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            accelerator=AcceleratorSpec.from_dict(d.get("accelerator") or {}),
        )


@dataclass
class InferenceServerConfigSpec:
    engine_server_config: EngineServerConfig = field(default_factory=EngineServerConfig)
    launcher_config_name: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "modelServerConfig": self.engine_server_config.to_dict(),
            "launcherConfigName": self.launcher_config_name,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InferenceServerConfigSpec":
        return cls(
            engine_server_config=EngineServerConfig.from_dict(
                d.get("modelServerConfig") or {}
            ),
            launcher_config_name=d.get("launcherConfigName", ""),
        )


@dataclass
class InferenceServerConfig:
    """Declares one engine instance config; shortName `isc`."""

    KIND = "InferenceServerConfig"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: InferenceServerConfigSpec = field(default_factory=InferenceServerConfigSpec)
    status: Status = field(default_factory=Status)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "fma.llm-d.ai/v1alpha1",
            "kind": self.KIND,
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InferenceServerConfig":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=InferenceServerConfigSpec.from_dict(d.get("spec") or {}),
            status=Status.from_dict(d.get("status") or {}),
        )


# -- LauncherConfig ----------------------------------------------------------


@dataclass
class PodTemplate:
    """EmbeddedPodTemplateSpec (launcherconfig_types.go:26-44): metadata
    labels/annotations + a Pod spec dict (kept as a plain dict — the template
    builder manipulates it structurally)."""

    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    spec: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {}
        if self.labels:
            meta["labels"] = dict(self.labels)
        if self.annotations:
            meta["annotations"] = dict(self.annotations)
        return {"metadata": meta, "spec": self.spec}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PodTemplate":
        meta = d.get("metadata") or {}
        return cls(
            labels=dict(meta.get("labels") or {}),
            annotations=dict(meta.get("annotations") or {}),
            spec=dict(d.get("spec") or {}),
        )


@dataclass
class LauncherConfigSpec:
    pod_template: PodTemplate = field(default_factory=PodTemplate)
    max_instances: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "podTemplate": self.pod_template.to_dict(),
            "maxInstances": self.max_instances,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LauncherConfigSpec":
        return cls(
            pod_template=PodTemplate.from_dict(d.get("podTemplate") or {}),
            max_instances=int(d.get("maxInstances", 1) or 1),
        )


@dataclass
class LauncherConfig:
    """Pod template for launcher Pods + per-launcher instance cap;
    shortName `lcfg`."""

    KIND = "LauncherConfig"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LauncherConfigSpec = field(default_factory=LauncherConfigSpec)
    status: Status = field(default_factory=Status)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "fma.llm-d.ai/v1alpha1",
            "kind": self.KIND,
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LauncherConfig":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=LauncherConfigSpec.from_dict(d.get("spec") or {}),
            status=Status.from_dict(d.get("status") or {}),
        )


# -- LauncherPopulationPolicy ------------------------------------------------


@dataclass
class ResourceRange:
    """Allocatable-resource min/max (launcherpopulationpolicy_types.go:103-113)."""

    min: Optional[str] = None
    max: Optional[str] = None

    def matches(self, value: "int | float | str") -> bool:
        v = parse_quantity(value)
        if self.min is not None and v < parse_quantity(self.min):
            return False
        if self.max is not None and v > parse_quantity(self.max):
            return False
        return True

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.min is not None:
            d["min"] = self.min
        if self.max is not None:
            d["max"] = self.max
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResourceRange":
        return cls(
            min=None if d.get("min") is None else str(d["min"]),
            max=None if d.get("max") is None else str(d["max"]),
        )


@dataclass
class EnhancedNodeSelector:
    """Label selector AND allocatable-resource ranges
    (launcherpopulationpolicy_types.go:88-113)."""

    #: matchLabels-style exact-equality selector (the subset the framework
    #: evaluates; matchExpressions can be added without API change).
    match_labels: Dict[str, str] = field(default_factory=dict)
    allocatable_resources: Dict[str, ResourceRange] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"labelSelector": {"matchLabels": dict(self.match_labels)}}
        if self.allocatable_resources:
            d["allocatableResources"] = {
                k: v.to_dict() for k, v in self.allocatable_resources.items()
            }
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EnhancedNodeSelector":
        sel = d.get("labelSelector") or {}
        return cls(
            match_labels=dict(sel.get("matchLabels") or {}),
            allocatable_resources={
                k: ResourceRange.from_dict(v or {})
                for k, v in (d.get("allocatableResources") or {}).items()
            },
        )


@dataclass
class CountForLauncher:
    launcher_config_name: str = ""
    launcher_count: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "launcherConfigName": self.launcher_config_name,
            "launcherCount": self.launcher_count,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CountForLauncher":
        return cls(
            launcher_config_name=d.get("launcherConfigName", ""),
            launcher_count=int(d.get("launcherCount", 0) or 0),
        )


@dataclass
class LauncherPopulationPolicySpec:
    enhanced_node_selector: EnhancedNodeSelector = field(
        default_factory=EnhancedNodeSelector
    )
    count_for_launcher: List[CountForLauncher] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "enhancedNodeSelector": self.enhanced_node_selector.to_dict(),
            "countForLauncher": [c.to_dict() for c in self.count_for_launcher],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LauncherPopulationPolicySpec":
        return cls(
            enhanced_node_selector=EnhancedNodeSelector.from_dict(
                d.get("enhancedNodeSelector") or {}
            ),
            count_for_launcher=[
                CountForLauncher.from_dict(c)
                for c in (d.get("countForLauncher") or [])
            ],
        )


@dataclass
class LauncherPopulationPolicy:
    """Proactive launcher population policy; shortName `lpp`. All LPPs jointly
    define (Node, LauncherConfig) -> max(count); effective desired =
    max(policy, demand) (docs/dual-pods.md:151-174)."""

    KIND = "LauncherPopulationPolicy"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LauncherPopulationPolicySpec = field(
        default_factory=LauncherPopulationPolicySpec
    )
    status: Status = field(default_factory=Status)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "fma.llm-d.ai/v1alpha1",
            "kind": self.KIND,
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LauncherPopulationPolicy":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=LauncherPopulationPolicySpec.from_dict(d.get("spec") or {}),
            status=Status.from_dict(d.get("status") or {}),
        )


# -- wire types --------------------------------------------------------------


@dataclass
class ServerRequestingPodStatus:
    """JSON value of the status annotation (pkg/api/interface.go:58-66)."""

    errors: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"Errors": list(self.errors)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServerRequestingPodStatus":
        return cls(errors=list(d.get("Errors") or []))


@dataclass
class SleepState:
    """GET /is_sleeping response (pkg/api/interface.go:131-135)."""

    is_sleeping: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {"is_sleeping": self.is_sleeping}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SleepState":
        return cls(is_sleeping=bool(d.get("is_sleeping")))

