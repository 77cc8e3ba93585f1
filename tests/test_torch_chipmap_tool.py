"""The gpu-map tool (``controller/chipmap_tool.py``), the GPU edition of
the JAX package's chip-map tool (tests/test_chipmap_tool.py mirrored): GPU
nodes by ``nvidia.com/gpu`` capacity, an injected prober, the map in the
grammar the launcher's translator reads, and the production prober's NVML
read (a fake library). Then ``deploy/gpu/``: the manifests parse, request
``nvidia.com/gpu`` and name the port's modules."""

import ctypes
import json
import pathlib

import pytest
import yaml

from llm_d_fast_model_actuation_tpu_torch.api import constants as C
from llm_d_fast_model_actuation_tpu_torch.api.types import InferenceServerConfig, LauncherConfig
from llm_d_fast_model_actuation_tpu_torch.controller import chipmap_tool as tool
from llm_d_fast_model_actuation_tpu_torch.controller.store import InMemoryStore
from llm_d_fast_model_actuation_tpu_torch.launcher.chiptranslator import ChipTranslator
from llm_d_fast_model_actuation_tpu_torch.parallel.topology import parse_gpu_map

NS = "fma"
GPU_DIR = pathlib.Path(__file__).resolve().parent.parent / "deploy" / "gpu"


def _node(name, gpu=True, unschedulable=False, labels=None):
    return {"kind": "Node", "metadata": {"name": name, "labels": labels or {}},
            "spec": {"unschedulable": unschedulable} if unschedulable else {},
            "status": {"capacity": {C.GPU_RESOURCE: "4"} if gpu else {"cpu": "8"}}}


def _store(*nodes):
    s = InMemoryStore()
    for n in nodes:
        s.create(n)
    return s


def _cards(node, n=4):
    return [(i, f"GPU-{node}-{i:04d}") for i in range(n)]


def test_node_selection():
    s = _store(_node("gpu1"), _node("cpu1", gpu=False), _node("cordoned", unschedulable=True),
               _node("labeled", gpu=False, labels={"pool": "gpu"}))
    assert [n["metadata"]["name"] for n in tool.gpu_nodes(s)] == ["gpu1"]
    assert [n["metadata"]["name"] for n in tool.gpu_nodes(s, {"pool": "gpu"})] == ["labeled"]


def test_populates_missing_nodes_idempotently():
    s = _store(_node("n1"), _node("n2"))
    probed = []

    def prober(node):
        probed.append(node)
        return list(reversed(_cards(node)))  # any order: written by index

    assert sorted(tool.ensure_nodes_mapped(s, NS, prober)) == ["n1", "n2"]
    cm = s.get("ConfigMap", NS, C.GPU_MAP_CONFIGMAP)
    parsed = parse_gpu_map(cm["data"])
    assert parsed["n1"] == [(u, i) for i, u in _cards("n1")]
    probed.clear()
    assert tool.ensure_nodes_mapped(s, NS, prober) == [] and probed == []


def test_existing_entries_preserved_and_failures_skipped():
    s = _store(_node("mapped"), _node("flaky"))
    s.create({"kind": "ConfigMap", "metadata": {"name": C.GPU_MAP_CONFIGMAP, "namespace": NS},
              "data": {"mapped": "0 GPU-custom"}})
    assert tool.ensure_nodes_mapped(s, NS, lambda node: None) == []
    cm = s.get("ConfigMap", NS, C.GPU_MAP_CONFIGMAP)
    assert cm["data"]["mapped"] == "0 GPU-custom" and "flaky" not in cm["data"]
    assert tool.ensure_nodes_mapped(s, NS, _cards) == ["flaky"]


def test_the_map_drives_the_launchers_translator(tmp_path):
    s = _store(_node("n1"))
    tool.ensure_nodes_mapped(s, NS, lambda node: _cards(node, 2))
    path = tmp_path / "gpu-map.json"  # the ConfigMap's data, as a mounted file
    path.write_text(json.dumps(s.get("ConfigMap", NS, C.GPU_MAP_CONFIGMAP)["data"]))
    tr = ChipTranslator.create(mock_chips=True, chip_map_path=str(path), node_name="n1")
    assert tr.chip_ids() == ["GPU-n1-0000", "GPU-n1-0001"]


class _FakeNvml:
    """The NVML calls ``native/nvml.py:enumerate_gpus`` makes, for two cards."""

    UUIDS = ["GPU-aaaa", "GPU-bbbb"]

    def nvmlInit_v2(self):
        return 0

    def nvmlShutdown(self):
        return 0

    def nvmlDeviceGetCount_v2(self, ref):
        ref._obj.value = len(self.UUIDS)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, ref):
        ref._obj.value = i.value + 1
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, n):
        ctypes.memmove(buf, self.UUIDS[handle.value - 1].encode() + b"\0", len(self.UUIDS[handle.value - 1]) + 1)
        return 0

    def nvmlDeviceGetName(self, handle, buf, n):
        ctypes.memmove(buf, b"NVIDIA H100 80GB HBM3\0", 22)
        return 0


def test_the_production_table_reads_nvml(monkeypatch, capsys):
    from llm_d_fast_model_actuation_tpu_torch.native import nvml

    monkeypatch.setattr(nvml, "load", lambda: _FakeNvml())
    assert tool.local_cards() == [(0, "GPU-aaaa"), (1, "GPU-bbbb")]
    assert tool.main(["--table"]) == 0
    out = capsys.readouterr().out
    assert parse_gpu_map({"n": out}) == {"n": [("GPU-aaaa", 0), ("GPU-bbbb", 1)]}


def test_the_kubectl_prober_parses_the_table(monkeypatch):
    calls = []

    class Done:
        stdout = b"0 GPU-aaaa\n1 GPU-bbbb\n"

    def run(cmd, **kw):
        calls.append(cmd)
        return Done()

    monkeypatch.setattr(tool.subprocess, "run", run)
    assert tool.kubectl_nvml_prober("img", NS)("n1") == [(0, "GPU-aaaa"), (1, "GPU-bbbb")]
    assert calls[0][:4] == ["kubectl", "-n", NS, "create"] and calls[-1][3:5] == ["delete", "pod"]


# -- deploy/gpu ------------------------------------------------------------------


def test_the_gpu_examples_parse_and_request_cards():
    docs = [d for d in yaml.safe_load_all((GPU_DIR / "examples.yaml").read_text()) if d]
    by_kind = {d["kind"]: d for d in docs}
    lc = LauncherConfig.from_dict(by_kind["LauncherConfig"])
    isc = InferenceServerConfig.from_dict(by_kind["InferenceServerConfig"])
    spec = lc.spec.pod_template.spec
    assert spec["hostNetwork"] is True
    assert spec["containers"][0]["resources"]["limits"][C.GPU_RESOURCE] == 1
    assert isc.spec.launcher_config_name == lc.metadata.name
    assert isc.spec.engine_server_config.accelerator.validate() == []
    from llm_d_fast_model_actuation_tpu_torch import admission

    assert admission.validate(by_kind["InferenceServerConfig"]) == []
    assert admission.validate(by_kind["LauncherConfig"]) == []
    from llm_d_fast_model_actuation_tpu_torch.engine.server import parse_engine_options

    parse_engine_options(isc.spec.engine_server_config.options)


@pytest.mark.parametrize("name,module", [
    ("Dockerfile.controller", "llm_d_fast_model_actuation_tpu_torch.controller"),
    ("Dockerfile.launcher", "llm_d_fast_model_actuation_tpu_torch.launcher.main"),
    ("Dockerfile.requester", "llm_d_fast_model_actuation_tpu_torch.requester.main"),
])
def test_the_gpu_dockerfiles_run_the_ports_modules(name, module):
    import importlib

    text = (GPU_DIR / name).read_text()
    assert module in text and "llm_d_fast_model_actuation_tpu/" not in text
    assert "COPY llm_d_fast_model_actuation_tpu_torch" in text
    importlib.import_module(module)


def test_the_values_overlay_names_the_charts_keys():
    base = yaml.safe_load((GPU_DIR.parent / "chart" / "fma-tpu-controllers" / "values.yaml").read_text())
    overlay = yaml.safe_load((GPU_DIR / "values-gpu.yaml").read_text())
    for section, values in overlay.items():
        assert set(values) <= set(base[section]), section
    assert overlay["dualPodsController"]["image"] == overlay["launcherPopulator"]["image"] == "fma-gpu-controller"
