"""The names the launcher shares with the controllers, as the JAX
package's ``api/constants.py`` spells them; only those the port's
launcher and notifier use.

Reference: launcher_pod_notifier.py:16-198 (the signature annotation);
launcher.py:157-340 (the instance status vocabulary).
"""

#: Annotation patched by the launcher notifier: SHA-256 signature of the
#: sorted (instance_id, status) pairs, which turns node-local instance
#: state changes into Pod events.
INSTANCE_SIGNATURE_ANNOTATION = "dual-pods.llm-d.ai/vllm-instance-signature"

#: An instance's status, as its launcher reports it.
STATUS_STARTED = "started"  #: answer to a create that forked the child
STATUS_ALREADY_RUNNING = "already_running"  #: a start of a live child
STATUS_RUNNING = "running"  #: the child is alive
STATUS_STOPPED = "stopped"  #: the child died on its own
STATUS_NOT_RUNNING = "not_running"  #: a stop found the child dead
STATUS_TERMINATED = "terminated"  #: a stop ended the child
