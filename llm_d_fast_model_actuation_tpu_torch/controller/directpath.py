"""Direct-provider path (M2): server-patch rendering and nominal Pods.

In the direct path the user puts a *server patch* annotation on the
server-requesting Pod instead of naming an InferenceServerConfig. The
controller derives the server-providing Pod ("nominal Pod") from the
requester itself:

  requester spec --de-individualize--> base
  server-patch template --render(ProviderData)--> strategic-merge patch
  base + patch --merge--> provider spec
  + node pinning + CUDA_VISIBLE_DEVICES injection + zeroed `nvidia.com/gpu`
  + nominal-hash annotation (identity for sleeping-twin reuse)

The port of the JAX package's ``controller/directpath.py``. Reference
behavior being reproduced:
`getNominalServerProvidingPod` (pkg/controller/dual-pods/
inference-server.go:1842-1946), nominal hash at :1880-1888,
`DeIndividualize` (pkg/controller/utils/pod-helper.go:85-109), engine-port
discovery from the readiness probe (pod-helper.go:112-140), sleeper budget
(`enforceSleeperBudget`, inference-server.go:1353-1427).

Ported by meaning: where the JAX package injects `TPU_VISIBLE_DEVICES` and
the process-bounds env from its chip-map and zeroes `google.com/tpu`, the
provider here gets the reference's own `CUDA_VISIBLE_DEVICES` (with
`CUDA_DEVICE_ORDER=PCI_BUS_ID`, the gpu-map's index order) and a zeroed
`nvidia.com/gpu`.
"""

from __future__ import annotations

import copy
import json
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..api import constants as C
from ..parallel.topology import indices_for, parse_gpu_map, visible_devices_env
from ..utils.hashing import canonical_json, sha256_hex

#: node -> [(uuid, index)], as ``parallel/topology.py:parse_gpu_map`` reads it
GpuMap = Dict[str, List[Tuple[str, int]]]

#: Annotation carrying the SHA-256 identity of a direct providing Pod:
#: hash(provider spec + chip IDs + node). Two requesters whose rendered
#: providers hash equal can share one (sleeping) provider.
NOMINAL_HASH_ANNOTATION = "dual-pods.llm-d.ai/nominal-hash"

#: Component label value for direct (non-launcher) providing Pods.
DIRECT_PROVIDER_COMPONENT = "server-provider"

#: Annotation recording when a direct provider was last unbound (seconds,
#: wall clock) — the LRU key for sleeper-budget eviction. Persisted on the
#: Pod so controller restarts don't reset eviction order.
LAST_USED_ANNOTATION = "dual-pods.llm-d.ai/last-used"

_TEMPLATE_FIELD = re.compile(r"\{\{\s*\.(\w+)\s*\}\}")


@dataclass
class ProviderData:
    """Data available to the server-patch template (inference-server.go's
    ProviderData)."""

    node_name: str
    local_volume: str = ""

    def fields(self) -> Dict[str, str]:
        return {"NodeName": self.node_name, "LocalVolume": self.local_volume}


def render_server_patch(template: str, data: ProviderData) -> Dict[str, Any]:
    """Render the ``{{.Field}}`` references and parse the result as a
    strategic-merge patch document (JSON, or YAML when available)."""
    fields = data.fields()

    def sub(m: "re.Match[str]") -> str:
        name = m.group(1)
        if name not in fields:
            raise ValueError(f"server-patch references unknown field .{name}")
        return fields[name]

    rendered = _TEMPLATE_FIELD.sub(sub, template)
    try:
        doc = json.loads(rendered)
    except json.JSONDecodeError as json_err:
        try:
            import yaml  # type: ignore
        except ImportError as e:  # pragma: no cover
            raise ValueError(f"server-patch is not valid JSON: {json_err}") from e
        try:
            doc = yaml.safe_load(rendered)
        except yaml.YAMLError as e:
            raise ValueError(f"server-patch is neither valid JSON nor YAML: {e}") from e
    if not isinstance(doc, dict):
        raise ValueError("server-patch must render to an object")
    return doc


# -------------------------------------------------------------- merge logic

#: list fields merged element-wise by this key (the subset of the strategic
#: merge-patch schema that Pod specs exercise).
_MERGE_KEYS = {
    "containers": "name",
    "initContainers": "name",
    "ephemeralContainers": "name",
    "volumes": "name",
    "env": "name",
    "volumeMounts": "mountPath",
    "ports": "containerPort",
}


def strategic_merge(base: Any, patch: Any, merge_key: Optional[str] = None) -> Any:
    """Strategic-merge `patch` into `base` (both unmodified; returns new).

    Dicts merge recursively; `null` deletes a key; lists whose field name has
    a merge key merge element-wise by that key (honoring the
    ``$patch: delete`` directive); other lists are replaced.
    """
    if isinstance(base, dict) and isinstance(patch, dict):
        out = dict(base)
        for k, v in patch.items():
            if v is None:
                out.pop(k, None)
            elif k in out:
                out[k] = strategic_merge(out[k], v, _MERGE_KEYS.get(k))
            else:
                out[k] = copy.deepcopy(v)
        return out
    if isinstance(base, list) and isinstance(patch, list) and merge_key:
        by_key = {e.get(merge_key): i for i, e in enumerate(base) if isinstance(e, dict)}
        out_list = [copy.deepcopy(e) for e in base]
        deletions: List[int] = []
        for e in patch:
            if not isinstance(e, dict) or merge_key not in e:
                out_list.append(copy.deepcopy(e))
                continue
            idx = by_key.get(e[merge_key])
            if e.get("$patch") == "delete":
                if idx is not None:
                    deletions.append(idx)
                continue
            if idx is None:
                out_list.append(copy.deepcopy(e))
            else:
                out_list[idx] = strategic_merge(out_list[idx], e)
        for idx in sorted(deletions, reverse=True):
            del out_list[idx]
        return out_list
    return copy.deepcopy(patch)


def de_individualize(pod: Dict[str, Any]) -> Dict[str, Any]:
    """Strip the parts of a Pod that are individual to one instance
    (pod-helper.go:85-109): the projected service-account token volume and
    its mounts, ephemeral containers, scheduling outcome, and status."""
    spec = copy.deepcopy(pod.get("spec") or {})
    spec.pop("ephemeralContainers", None)
    spec.pop("nodeName", None)
    api_vols = {
        v["name"]
        for v in spec.get("volumes", [])
        if v.get("name", "").startswith("kube-api-access-")
    }
    if api_vols:
        spec["volumes"] = [v for v in spec["volumes"] if v["name"] not in api_vols]
        for c in spec.get("containers", []) + spec.get("initContainers", []):
            if "volumeMounts" in c:
                c["volumeMounts"] = [
                    m for m in c["volumeMounts"] if m.get("name") not in api_vols
                ]
    return spec


def engine_port_of(pod_spec: Dict[str, Any]) -> int:
    """Engine port = the inference-server container's readiness-probe HTTP
    port (pod-helper.go:112-140). The probe port is a kube IntOrString: an
    int, a numeric string, or a named port resolved against the container's
    ports list; falls back to the first containerPort."""
    for c in pod_spec.get("containers", []):
        if c.get("name") != C.INFERENCE_SERVER_CONTAINER_NAME:
            continue
        ports = c.get("ports") or []
        probe = ((c.get("readinessProbe") or {}).get("httpGet") or {}).get("port")
        if isinstance(probe, int):
            return probe
        if isinstance(probe, str):
            if probe.isdigit():
                return int(probe)
            for p in ports:  # named port
                if p.get("name") == probe and isinstance(p.get("containerPort"), int):
                    return p["containerPort"]
        if ports and isinstance(ports[0].get("containerPort"), int):
            return ports[0]["containerPort"]
    return 8000


def chip_indices(
    chip_ids: Sequence[str], node: str, gpu_map: Optional[GpuMap]
) -> List[int]:
    """Card UUIDs -> local indices via the gpu-map.

    When the node HAS a gpu-map entry, an unknown UUID is a hard error —
    silently guessing indices would point CUDA_VISIBLE_DEVICES at cards the
    requester does not hold. The sorted-rank fallback applies only when no
    map entry exists at all (hardware-less tests).
    """
    if gpu_map is not None and gpu_map.get(node) is not None:
        try:
            return indices_for(gpu_map[node], chip_ids)
        except KeyError as e:
            raise ValueError(
                f"chip id {e.args[0]!r} not in the chip map for node {node}"
            ) from e
    ranked = {cid: i for i, cid in enumerate(sorted(set(chip_ids)))}
    return [ranked[cid] for cid in chip_ids]


def nominal_provider_pod(
    req: Dict[str, Any],
    patch: Dict[str, Any],
    node: str,
    chip_ids: Sequence[str],
    gpu_map: Optional[GpuMap] = None,
) -> Dict[str, Any]:
    """Build the nominal server-providing Pod for a direct-path requester.

    The returned Pod has no name/namespace yet; its nominal-hash annotation
    is the identity used for sleeping-twin lookup.
    """
    # normalize: the SPI may report the same chip set in any order, and the
    # order must not leak into the rendered spec (and thus the nominal hash)
    chip_ids = sorted(chip_ids)
    base = de_individualize(req)
    spec = strategic_merge(base, patch.get("spec") or {})

    # pin to the requester's node without consuming scheduler resources
    sel = spec.setdefault("nodeSelector", {})
    sel["kubernetes.io/hostname"] = node

    pin = visible_devices_env(chip_indices(chip_ids, node, gpu_map))
    for c in spec.get("containers", []):
        if c.get("name") != C.INFERENCE_SERVER_CONTAINER_NAME:
            continue
        env = c.setdefault("env", [])
        for name, value in pin.items():
            for entry in env:
                if entry.get("name") == name:
                    entry["value"] = value
                    break
            else:
                env.append({"name": name, "value": value})
        # the provider must NOT request cards from the device plugin — the
        # requester already holds the allocation
        res = c.setdefault("resources", {})
        for section in ("limits", "requests"):
            if C.GPU_RESOURCE in (res.get(section) or {}):
                res[section][C.GPU_RESOURCE] = "0"

    meta_patch = patch.get("metadata") or {}
    pod: Dict[str, Any] = {
        "kind": "Pod",
        "metadata": {
            "labels": {
                **(req["metadata"].get("labels") or {}),
                **(meta_patch.get("labels") or {}),
                C.COMPONENT_LABEL: DIRECT_PROVIDER_COMPONENT,
            },
            "annotations": {
                **(meta_patch.get("annotations") or {}),
                C.ACCELERATORS_ANNOTATION: ",".join(sorted(chip_ids)),
                C.SERVER_PORT_ANNOTATION: str(engine_port_of(spec)),
            },
        },
        "spec": spec,
    }
    pod["metadata"]["annotations"][NOMINAL_HASH_ANNOTATION] = nominal_hash(
        spec, chip_ids, node
    )
    return pod


def nominal_hash(spec: Dict[str, Any], chip_ids: Sequence[str], node: str) -> str:
    """SHA-256 over (canonical provider spec, sorted chips, node) —
    inference-server.go:1880-1888."""
    return sha256_hex(
        canonical_json({"spec": spec, "chips": sorted(chip_ids), "node": node})
    )


def load_gpu_map(store: Any, namespace: str) -> Optional[GpuMap]:
    """Parse the gpu-map ConfigMap (controller.go:888-924) from the cluster
    store, if present."""
    cm = store.try_get("ConfigMap", namespace, C.GPU_MAP_CONFIGMAP)
    if cm is None:
        return None
    try:
        return parse_gpu_map(cm.get("data") or {})
    except (ValueError, IndexError):
        return None
