"""The port's admission rules (``admission.py``) against the JAX package's:
the Pod policies and the CRD validators give the same answers on the
reference's cases, and the accelerator rule is the GPU's (a topology or
more than one host is refused, ``api/types.py:AcceleratorSpec``)."""

import pytest

from llm_d_fast_model_actuation_tpu import admission as jadm
from llm_d_fast_model_actuation_tpu.api import constants as JC
from llm_d_fast_model_actuation_tpu_torch import admission as tadm
from llm_d_fast_model_actuation_tpu_torch.api import constants as C

FMA_SA = "system:serviceaccount:prod:release-fma-controllers"
USER = "kubernetes-admin"


def _pod(ann=None, labels=None):
    return {"kind": "Pod", "metadata": {"name": "p", "annotations": dict(ann or {}), "labels": dict(labels or {})}}


def _isc(acc=None, port=8000):
    msc = {"port": port}
    if acc is not None:
        msc["accelerator"] = acc
    return {"kind": "InferenceServerConfig", "metadata": {"name": "x", "namespace": "ns"},
            "spec": {"modelServerConfig": msc, "launcherConfigName": "lc1"}}


def test_the_protected_keys_are_the_references():
    assert tadm.PROTECTED_ANNOTATIONS == jadm.PROTECTED_ANNOTATIONS
    assert tadm.PROTECTED_LABELS == jadm.PROTECTED_LABELS
    assert tadm.BOUND_ACTUATION_ANNOTATIONS == jadm.BOUND_ACTUATION_ANNOTATIONS
    assert tadm.FMA_CONTROLLER_SA.pattern == jadm.FMA_CONTROLLER_SA.pattern


@pytest.mark.parametrize("user", [FMA_SA, "system:serviceaccount:ns:-fma-controllers",
                                  "system:serviceaccount:ns:other", USER])
def test_sa_pattern(user):
    assert tadm.is_fma_controller(user) == jadm.is_fma_controller(user)


@pytest.mark.parametrize("old,new", [
    (_pod(ann={C.REQUESTER_ANNOTATION: "r1/u1"}), _pod(ann={C.REQUESTER_ANNOTATION: "hacker/u9"})),
    (_pod(ann={C.REQUESTER_ANNOTATION: "r1/u1"}), _pod()),
    (_pod(ann={C.REQUESTER_ANNOTATION: "r1/u1"}), _pod(ann={C.REQUESTER_ANNOTATION: "r1/u1"})),
    (_pod(labels={C.SLEEPING_LABEL: "true"}), _pod(labels={C.SLEEPING_LABEL: "false"})),
    (_pod(ann={C.INFERENCE_SERVER_CONFIG_ANNOTATION: "isc1"}, labels={C.DUAL_LABEL: "provider-x"}),
     _pod(ann={C.INFERENCE_SERVER_CONFIG_ANNOTATION: "isc2"}, labels={C.DUAL_LABEL: "provider-x"})),
    (_pod(ann={C.INFERENCE_SERVER_CONFIG_ANNOTATION: "isc1"}), _pod(ann={C.INFERENCE_SERVER_CONFIG_ANNOTATION: "isc2"})),
    (_pod(), _pod(ann={C.STATUS_ANNOTATION: "tampered"})),
])
@pytest.mark.parametrize("user", [FMA_SA, USER])
def test_pod_updates_are_judged_as_the_reference_judges_them(old, new, user):
    assert tadm.validate_pod_update(old, new, user) == jadm.validate_pod_update(old, new, user)


def test_the_constants_agree():
    for name in ("REQUESTER_ANNOTATION", "STATUS_ANNOTATION", "DUAL_LABEL", "SLEEPING_LABEL",
                 "INFERENCE_SERVER_CONFIG_ANNOTATION"):
        assert getattr(C, name) == getattr(JC, name)


@pytest.mark.parametrize("obj", [
    _isc({"chips": 8}),
    _isc(port=0),
    {"kind": "InferenceServerConfig", "spec": {}},
    _isc({"chips": 0}),
    _isc({"chips": 2, "hosts": 0}),
    {"kind": "InferenceServerConfig", "spec": {"modelServerConfig": {"port": 8000, "labels": {"a": 1}}}},
    {"kind": "LauncherConfig", "spec": {"podTemplate": {}, "maxInstances": 2}},
    {"kind": "LauncherConfig", "spec": {"maxInstances": 0}},
    {"kind": "LauncherPopulationPolicy", "spec": {
        "nodeSelector": {"labelSelector": {"matchLabels": {"pool": "gpu"}},
                         "allocatableResources": {C.GPU_RESOURCE: {"min": "4", "max": "8"}}},
        "countForLauncher": [{"launcherConfigName": "lc1", "launcherCount": 2}]}},
    {"kind": "LauncherPopulationPolicy", "spec": {
        "nodeSelector": {"allocatableResources": {"x": {"min": "9", "max": "1"}}},
        "countForLauncher": [{"launcherConfigName": "lc1", "launcherCount": 1}]}},
    {"kind": "LauncherPopulationPolicy", "spec": {"nodeSelector": {}, "countForLauncher": [{"launcherCount": -1}]}},
    {"kind": "LauncherPopulationPolicy", "spec": {"nodeSelector": {"allocatableResources": {"x": {"min": "zz"}}},
                                                  "countForLauncher": [{"launcherConfigName": "a",
                                                                        "launcherCount": 1}]}},
    {"kind": "Secret"},
])
def test_crd_validation_without_a_topology_is_the_references(obj):
    assert tadm.validate(obj) == jadm.validate(obj)


def test_the_accelerator_rule_is_the_gpus():
    """The reference checks a TPU slice topology against chips x hosts;
    cards have none, and an engine spans one host until item 15."""
    assert tadm.validate_isc(_isc({"chips": 8})) == []
    errs = tadm.validate_isc(_isc({"chips": 8, "topology": "2x4"}))
    assert len(errs) == 1 and "a GPU has no slice topology" in errs[0]
    errs = tadm.validate_isc(_isc({"chips": 8, "topology": "4x4", "hosts": 2}))
    assert any("item 15" in e for e in errs) and any("topology" in e for e in errs)
    assert jadm.validate_isc(_isc({"chips": 8, "topology": "4x4", "hosts": 2})) == []


def test_review_shape():
    out = tadm.review({"operation": "UPDATE", "object": _pod(ann={C.STATUS_ANNOTATION: "tampered"}),
                       "oldObject": _pod(), "userInfo": {"username": USER}})
    assert out == jadm.review({"operation": "UPDATE", "object": _pod(ann={C.STATUS_ANNOTATION: "tampered"}),
                               "oldObject": _pod(), "userInfo": {"username": USER}})
    assert out["allowed"] is False and "status" in out
    assert tadm.review({"operation": "CREATE", "object": {"kind": "LauncherConfig",
                                                          "spec": {"podTemplate": {}}}}) == {"allowed": True}
