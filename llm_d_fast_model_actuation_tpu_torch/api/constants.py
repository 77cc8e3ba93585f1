"""Annotation / label / port contract between users, controllers, and agents.

The port's copy of the JAX package's ``api/constants.py``, word for word
where a name travels on the wire, with its TPU-only block ported by
meaning for NVIDIA cards (the GPU reference's own names):

  google.com/tpu                         -> nvidia.com/gpu
  TPU_VISIBLE_DEVICES + process bounds   -> CUDA_VISIBLE_DEVICES with
                                            CUDA_DEVICE_ORDER=PCI_BUS_ID
  chip-map ConfigMap (ICI coordinates)   -> gpu-map (``<index> <uuid>``)

A card has no slice topology, so the topology annotation has no
counterpart.

Parity map (reference `file:line` -> here):
  pkg/api/interface.go:47-135      -> user-facing annotations and FYI labels
  pkg/controller/common/interface.go:19-42 -> controller-internal shared keys
  pkg/spi/interface.go:29-61       -> requester SPI paths (see `spi.py`)
  launcher.py:157-340              -> the instance status vocabulary

In the dual-pods technique a *server-requesting Pod* is a stub that holds the
card allocation in the eyes of the scheduler, while the *server-providing
Pod* actually runs the inference engine but is accounted as using zero
cards. These constants are the single vocabulary binding the two.
"""

# --------------------------------------------------------------------------
# User-facing annotations on the server-requesting Pod.
# --------------------------------------------------------------------------

#: Annotation holding a template that transforms the requesting Pod's
#: (de-individualized) spec into the providing Pod's spec — a strategic-merge
#: patch rendered with ``ProviderData``. Mutually exclusive with
#: :data:`INFERENCE_SERVER_CONFIG_ANNOTATION`.
SERVER_PATCH_ANNOTATION = "dual-pods.llm-d.ai/server-patch"

#: Annotation naming the InferenceServerConfig the providing Pod uses
#: (launcher-based path). Mutually exclusive with
#: :data:`SERVER_PATCH_ANNOTATION`.
INFERENCE_SERVER_CONFIG_ANNOTATION = "dual-pods.llm-d.ai/inference-server-config"

#: Annotation maintained by the dual-pods controller reporting
#: ``ServerRequestingPodStatus`` as JSON.
STATUS_ANNOTATION = "dual-pods.llm-d.ai/status"

#: Name of the container (in the requesting Pod) that the server patch
#: describes and that the providing Pod actually runs.
INFERENCE_SERVER_CONTAINER_NAME = "inference-server"

#: Annotation naming the port of the requester stub's SPI server.
ADMIN_PORT_ANNOTATION = "dual-pods.llm-d.ai/admin-port"

#: Default SPI port of the requester stub.
ADMIN_PORT_DEFAULT = "8081"

# --------------------------------------------------------------------------
# FYI annotations/labels emitted by the dual-pods controller.
# --------------------------------------------------------------------------

#: FYI annotation listing the accelerator (card UUID) IDs associated with a
#: requesting/providing Pod pair.
ACCELERATORS_ANNOTATION = "dual-pods.llm-d.ai/accelerators"

#: FYI annotation marking a providing Pod as launcher-based.
LAUNCHER_BASED_ANNOTATION = "dual-pods.llm-d.ai/launcher-based"

#: FYI label: while bound, present on both Pods with the other Pod's name.
DUAL_LABEL = "dual-pods.llm-d.ai/dual"

#: FYI label on a bound requesting Pod: the engine instance ID.
INSTANCE_LABEL = "dual-pods.llm-d.ai/instance"

#: FYI label on providing Pods: "true"/"false" — whether (all instances of)
#: the provider are asleep.
SLEEPING_LABEL = "dual-pods.llm-d.ai/sleeping"

# --------------------------------------------------------------------------
# Controller-internal shared keys (dual-pods controller <-> populator <->
# launcher template builder).
# --------------------------------------------------------------------------

#: Annotation on a providing Pod naming the requesting Pod bound to it
#: ("<name>" or "<name>/<uid>"): presence == bound.
REQUESTER_ANNOTATION = "dual-pods.llm-d.ai/requester"

COMPONENT_LABEL = "app.kubernetes.io/component"
LAUNCHER_COMPONENT = "launcher"

#: Label on launcher Pods naming their LauncherConfig.
LAUNCHER_CONFIG_NAME_LABEL = "dual-pods.llm-d.ai/launcher-config-name"

#: Label on launcher Pods naming their Node.
NODE_NAME_LABEL = "dual-pods.llm-d.ai/node-name"

#: Annotation: node-specialized hash of the launcher config a providing Pod
#: was built from.
LAUNCHER_CONFIG_HASH_ANNOTATION = "dual-pods.llm-d.ai/launcher-config-hash"

#: Annotation: node-independent launcher template hash, for drift detection
#: by the populator.
LAUNCHER_TEMPLATE_HASH_ANNOTATION = "dual-pods.llm-d.ai/launcher-populator-template-hash"

#: Port on which every launcher exposes its instance-management REST API.
LAUNCHER_SERVICE_PORT = 8001

#: Annotation: per-pod override of LAUNCHER_SERVICE_PORT. Needed when the
#: LauncherConfig pod template uses hostNetwork: two launchers on one node
#: then share the host's port space, and the second gets a distinct port —
#: the reference handles the same same-node port collision by spawning a
#: differently-ported launcher (test/e2e/test-cases.sh:320).
LAUNCHER_PORT_ANNOTATION = "dual-pods.llm-d.ai/launcher-port"

# --------------------------------------------------------------------------
# Instance state persisted on launcher Pods (restart recovery).
# Reference: pkg/controller/dual-pods/controller.go:63-115.
# --------------------------------------------------------------------------

#: Annotation: ID of the engine instance serving the bound requester.
INSTANCE_ID_ANNOTATION = "dual-pods.llm-d.ai/instance-id"

#: Annotation: port the bound instance serves on.
SERVER_PORT_ANNOTATION = "dual-pods.llm-d.ai/server-port"

#: Annotation: JSON of the engine config the bound instance was created with.
ENGINE_CONFIG_ANNOTATION = "dual-pods.llm-d.ai/engine-config"

#: Annotation: JSON of the ISC routing labels/annotations stamped while bound.
ISC_ROUTING_METADATA_ANNOTATION = "dual-pods.llm-d.ai/isc-routing-metadata"

#: Annotation patched by the launcher notifier: SHA-256 signature of the
#: sorted (instance_id, status) pairs, which turns node-local instance
#: state changes into Pod events (launcher_pod_notifier.py:16-198).
INSTANCE_SIGNATURE_ANNOTATION = "dual-pods.llm-d.ai/vllm-instance-signature"

# --------------------------------------------------------------------------
# The cards (the JAX package's TPU block, by meaning).
# --------------------------------------------------------------------------

#: Resource name of NVIDIA cards in Kubernetes (the device plugin's).
GPU_RESOURCE = "nvidia.com/gpu"

#: Env var pinning the cards visible to an engine process (comma-separated
#: local indices).
VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"

#: CUDA numbers cards fastest first unless told otherwise; the gpu-map's
#: and NVML's indices are in PCI bus order, so a pinned process is told.
DEVICE_ORDER_ENV = "CUDA_DEVICE_ORDER"
DEVICE_ORDER = "PCI_BUS_ID"

#: Name of the ConfigMap mapping node -> lines ``<index> <uuid>`` (the
#: reference's, controller.go:888-924).
GPU_MAP_CONFIGMAP = "gpu-map"

# --------------------------------------------------------------------------
# Engine admin API (contract kept engine-agnostic, mirroring vLLM sleep mode;
# reference: pkg/controller/dual-pods/inference-server.go:1497,1712,1984).
# --------------------------------------------------------------------------

ENGINE_SLEEP_PATH = "/sleep"
ENGINE_WAKE_PATH = "/wake_up"
ENGINE_IS_SLEEPING_PATH = "/is_sleeping"

# --------------------------------------------------------------------------
# An instance's status, as its launcher reports it.
# --------------------------------------------------------------------------

STATUS_STARTED = "started"  #: answer to a create that forked the child
STATUS_ALREADY_RUNNING = "already_running"  #: a start of a live child
STATUS_RUNNING = "running"  #: the child is alive
STATUS_STOPPED = "stopped"  #: the child died on its own
STATUS_NOT_RUNNING = "not_running"  #: a stop found the child dead
STATUS_TERMINATED = "terminated"  #: a stop ended the child
