"""Deterministic identity hashing: the JAX package's ``utils/hashing.py``,
copied. Instance IDs and launcher-template hashes name objects on the
wire, so the same inputs give byte-identical strings in both packages.

The reference derives several load-bearing identities from content hashes:
  * instance ID = "I" + base64url(SHA-256(ModelServerConfig YAML + gpus)) + "i"
    (inference-server.go:1015-1057) — same config + same accelerators on a
    different day must produce the same instance, enabling the wake fast path;
  * nominal-provider hash = SHA-256(patched pod JSON + gpus + node)
    (inference-server.go:1880-1888; ``controller/directpath.py``);
  * launcher template hash over a canonicalized (order-independent) template
    (pod-helper.go:143-197).

Here all hashes run over canonical JSON (sorted keys, no whitespace drift).
"""

from __future__ import annotations

import base64
import hashlib
import json
from typing import Any, Sequence


def canonical_json(obj: Any) -> str:
    """Deterministic JSON: sorted keys, compact separators."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), default=str)


def sha256_hex(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()


def instance_id_for(engine_config: Any, chip_ids: Sequence[str]) -> str:
    """Deterministic engine-instance ID from (config, chip set).

    Format "I<base64url(sha256)>i" — the reference's shape
    (inference-server.go:1030-1045); base64url keeps it label-safe.
    Chip order is normalized: the same chips in any order are the same
    instance.

    The JAX package also hashes in a slice gang's coordination env; an
    engine here spans one host, and without that env the two IDs are the
    same bytes.
    """
    cfg = engine_config.to_dict() if hasattr(engine_config, "to_dict") else engine_config
    payload = canonical_json({"config": cfg, "chips": sorted(chip_ids)})
    digest = hashlib.sha256(payload.encode()).digest()
    return "I" + base64.urlsafe_b64encode(digest).decode().rstrip("=") + "i"


def canonicalize_for_hash(obj: Any) -> Any:
    """Canonicalize a pod-template-shaped dict for stable hashing: sort
    order-independent list fields (env, volumes, ...) by name; recurse.

    Reference: canonicalizeTemplateForHash (pod-helper.go:143-197).
    """
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            v = canonicalize_for_hash(v)
            if isinstance(v, list) and v and all(
                isinstance(e, dict) and "name" in e for e in v
            ):
                v = sorted(v, key=lambda e: e["name"])
            out[k] = v
        return out
    if isinstance(obj, list):
        return [canonicalize_for_hash(e) for e in obj]
    return obj


def template_hash(template: Any) -> str:
    """Order-independent hash of a launcher Pod template."""
    return sha256_hex(canonical_json(canonicalize_for_hash(template)))
