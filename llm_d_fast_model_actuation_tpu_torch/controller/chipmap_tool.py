"""gpu-map population tool: the GPU edition of the JAX package's
``controller/chipmap_tool.py``, which ports the reference's
``scripts/ensure-nodes-mapped.sh`` (the gpu-map ConfigMap,
controller.go:888-924).

Ensures the ``gpu-map`` ConfigMap has a data entry for every schedulable
node with ``nvidia.com/gpu`` capacity: nodes already mapped are left
untouched; an unmapped node is probed (in production by a one-shot Pod on
the node that reads its cards through NVML, ``native/nvml.py``, and prints
them with ``--table``; in tests by an injected prober) and written in the
grammar :func:`..parallel.topology.parse_gpu_map` reads, one card a line
in PCI bus order::

    0 GPU-5f0c...
    1 GPU-9a71...

The launcher's translator and the direct path agree on card identity only
through this map. A TPU host's slice topology has no GPU counterpart, so
the map holds (index, UUID) and nothing else.
"""

from __future__ import annotations

import argparse
import logging
import subprocess
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..api import constants as C
from ..parallel.topology import parse_gpu_map
from .store import AlreadyExists

logger = logging.getLogger(__name__)

#: node -> its cards as (index, UUID) in PCI bus order; None = the probe
#: failed, the node is skipped this run
Prober = Callable[[str], Optional[Sequence[Tuple[int, str]]]]


def gpu_nodes(store: Any, selector: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
    """Schedulable nodes that look like GPU hosts: those matching the given
    label selector, or reporting ``nvidia.com/gpu`` capacity."""
    out = []
    for node in store.list("Node", selector=selector or None):
        if (node.get("spec") or {}).get("unschedulable"):
            logger.info("skipping unschedulable node %s", node["metadata"]["name"])
            continue
        if selector:
            out.append(node)
            continue
        capacity = ((node.get("status") or {}).get("capacity")) or {}
        if C.GPU_RESOURCE in capacity:
            out.append(node)
    return out


def map_text(cards: Sequence[Tuple[int, str]]) -> str:
    """A node's gpu-map entry: ``<index> <uuid>`` a line, by index."""
    return "\n".join(f"{int(i)} {u}" for i, u in sorted(cards, key=lambda c: int(c[0])))


def ensure_nodes_mapped(
    store: Any,
    namespace: str,
    prober: Prober,
    selector: Optional[Dict[str, str]] = None,
) -> List[str]:
    """Idempotently fill the gpu-map; returns the nodes newly mapped."""
    cm_name = C.GPU_MAP_CONFIGMAP
    cm = store.try_get("ConfigMap", namespace, cm_name)
    if cm is None:
        try:
            cm = store.create({"kind": "ConfigMap", "metadata": {"name": cm_name, "namespace": namespace}, "data": {}})
        except AlreadyExists:
            cm = store.get("ConfigMap", namespace, cm_name)
    added: List[str] = []
    for node in gpu_nodes(store, selector):
        name = node["metadata"]["name"]
        if (cm.get("data") or {}).get(name):
            continue  # already mapped: the map is append-only, like gpu-map
        cards = prober(name)
        if not cards:
            logger.warning("could not index node %s", name)
            continue
        value = map_text(cards)
        parse_gpu_map({name: value})  # the readers' grammar, checked before it is written

        def apply(obj, name=name, value=value):
            obj.setdefault("data", {})[name] = value
            return obj

        cm = store.mutate("ConfigMap", namespace, cm_name, apply)
        added.append(name)
        logger.info("mapped node %s (%d cards)", name, len(cards))
    return added


def local_cards(lib: Optional[Any] = None) -> List[Tuple[int, str]]:
    """This host's cards through NVML, ``(index, UUID)`` in PCI bus order."""
    from ..native import nvml

    return [(g["index"], g["uuid"]) for g in nvml.enumerate_gpus(lib)]


def kubectl_nvml_prober(image: str, namespace: str, kubectl: str = "kubectl") -> Prober:
    """Production prober: a one-shot Pod pinned to the node runs this
    module's ``--table`` with ``NVIDIA_VISIBLE_DEVICES=all`` (the NVIDIA
    container runtime shows it every card of the host, and it requests no
    ``nvidia.com/gpu``, so it takes none from the scheduler), and its log
    is parsed: the choreography of ensure-nodes-mapped.sh's nvidia-smi
    Pod."""

    def probe(node: str) -> Optional[List[Tuple[int, str]]]:
        pod = f"{node}-gpu-map"
        manifest = f"""
apiVersion: v1
kind: Pod
metadata:
  name: {pod}
  labels: {{app: gather-gpu-map}}
spec:
  restartPolicy: OnFailure
  nodeSelector: {{kubernetes.io/hostname: "{node}"}}
  containers:
  - name: c1
    image: {image}
    command: ["python", "-m", "llm_d_fast_model_actuation_tpu_torch.controller.chipmap_tool", "--table"]
    env: [{{name: NVIDIA_VISIBLE_DEVICES, value: all}}]
"""
        try:
            subprocess.run([kubectl, "-n", namespace, "create", "-f", "-"], input=manifest.encode(), check=True)
            subprocess.run([kubectl, "-n", namespace, "wait", f"pod/{pod}", "--for",
                            "jsonpath={.status.phase}=Succeeded", "--timeout", "120s"], check=True)
            logs = subprocess.run([kubectl, "-n", namespace, "logs", pod], check=True,
                                  capture_output=True).stdout.decode()
            return [(i, u) for u, i in parse_gpu_map({node: logs})[node]] or None
        except (subprocess.CalledProcessError, ValueError, IndexError) as e:
            logger.warning("probe of %s failed: %s", node, e)
            return None
        finally:
            subprocess.run([kubectl, "-n", namespace, "delete", "pod", pod, "--ignore-not-found"], check=False)

    return probe


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="fma-ensure-nodes-mapped",
                                description="populate the gpu-map ConfigMap for unmapped GPU nodes")
    p.add_argument("--table", action="store_true",
                   help="print this host's cards through NVML in the gpu-map grammar and exit (the probe Pod's command)")
    p.add_argument("--namespace", default="default")
    p.add_argument("--api-base", default="", help="apiserver base URL (default: in-cluster)")
    p.add_argument("--node-selector", default="",
                   help="label selector key=value[,k=v] for GPU nodes (default: nodes with nvidia.com/gpu capacity)")
    p.add_argument("--probe-image", default="ghcr.io/llm-d/fma-gpu-launcher:latest",
                   help="image holding this package for the probe Pods")
    args = p.parse_args(argv)
    if args.table:
        print(map_text(local_cards()))
        return 0
    logging.basicConfig(level=logging.INFO)

    from .kubestore import KubeStore

    store = KubeStore(args.api_base, args.namespace, kinds=None) if args.api_base else KubeStore.in_cluster(args.namespace)
    # a one-shot tool: a plain relist is enough, no watch loops
    store._relist("Node")
    store._relist("ConfigMap")
    selector = dict(kv.split("=", 1) for kv in args.node_selector.split(",")) if args.node_selector else None
    added = ensure_nodes_mapped(store, args.namespace, kubectl_nvml_prober(args.probe_image, args.namespace), selector)
    print(f"mapped {len(added)} node(s): {', '.join(added) or '(none)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
