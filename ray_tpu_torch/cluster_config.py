"""Cluster launch configuration: YAML schema + validation.

Analogue of the reference's cluster YAML + ``ray-schema.json``
(``python/ray/autoscaler/ray-schema.json``; loaded/validated in
``autoscaler/_private/util.py`` ``prepare_config``/``validate_config``),
reduced to the fields the TPU-era launcher actually uses:

.. code-block:: yaml

    cluster_name: demo
    provider:
      type: fake_multinode        # or: gpu_vm
      project_id: my-project      # gpu_vm only
      zone: us-central1-a         # gpu_vm only
      accelerator_type: h100-8    # cards of one node (a host group)
      machine_type: a3-highgpu-8g # each host's Compute Engine type
    min_workers: 0
    max_workers: 8
    idle_timeout_minutes: 5
    head:
      resources: {CPU: 4}
    worker:
      resources: {CPU: 4, GPU: 1}
      labels: {pool: gpu}
    auth:                          # gpu_vm only (command runner)
      ssh_user: ray
      ssh_private_key: ~/.ssh/id_rsa
    setup_commands:
      - pip install -e .
    dry_run: false                 # gpu_vm: record API/SSH calls, no egress

Unknown top-level keys are rejected (typo protection — the reference's
jsonschema does the same via ``additionalProperties: false``).

The port's copy of ``ray_tpu/cluster_config.py``: the cloud provider is
``gpu_vm`` (Compute Engine instances, ``gpu_vm_api.py``) with a
``machine_type`` where the JAX file's ``tpu_vm`` takes a
``runtime_version``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class ConfigError(ValueError):
    """Invalid cluster config; message carries the YAML path."""


_TOP_KEYS = {"cluster_name", "provider", "min_workers", "max_workers",
             "idle_timeout_minutes", "head", "worker", "auth",
             "setup_commands", "dry_run"}
_PROVIDER_TYPES = {"fake_multinode", "gpu_vm"}
DEFAULT_ACCELERATOR_TYPE = "h100-8"
DEFAULT_MACHINE_TYPE = "a3-highgpu-8g"  # 8 H100 80GB cards a host


@dataclass
class ProviderConfig:
    type: str = "fake_multinode"
    project_id: Optional[str] = None
    zone: Optional[str] = None
    accelerator_type: str = DEFAULT_ACCELERATOR_TYPE
    machine_type: str = DEFAULT_MACHINE_TYPE


@dataclass
class NodeTypeConfig:
    resources: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class AuthConfig:
    ssh_user: str = "ray"
    ssh_private_key: Optional[str] = None


@dataclass
class ClusterConfig:
    cluster_name: str = "ray-tpu"
    provider: ProviderConfig = field(default_factory=ProviderConfig)
    min_workers: int = 0
    max_workers: int = 8
    idle_timeout_minutes: float = 5.0
    head: NodeTypeConfig = field(default_factory=NodeTypeConfig)
    worker: NodeTypeConfig = field(default_factory=NodeTypeConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    setup_commands: List[str] = field(default_factory=list)
    dry_run: bool = False


def _require(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise ConfigError(f"{path}: {msg}")


def _mapping(value: Any, path: str) -> Dict:
    _require(isinstance(value, dict), path,
             f"expected a mapping, got {type(value).__name__}")
    return value


def _resources(value: Any, path: str) -> Dict[str, float]:
    value = _mapping(value, path)
    out = {}
    for k, v in value.items():
        _require(isinstance(k, str), f"{path}.{k}", "resource keys are "
                 "strings")
        _require(isinstance(v, (int, float)) and v >= 0, f"{path}.{k}",
                 f"resource amounts are non-negative numbers, got {v!r}")
        out[k] = float(v)
    return out


def validate_config(raw: Dict[str, Any]) -> ClusterConfig:
    raw = _mapping(raw, "<root>")
    unknown = set(raw) - _TOP_KEYS
    _require(not unknown, "<root>",
             f"unknown keys {sorted(unknown)} (valid: {sorted(_TOP_KEYS)})")

    cfg = ClusterConfig()
    if "cluster_name" in raw:
        _require(isinstance(raw["cluster_name"], str) and raw["cluster_name"],
                 "cluster_name", "must be a non-empty string")
        cfg.cluster_name = raw["cluster_name"]

    prov = _mapping(raw.get("provider", {}), "provider")
    ptype = prov.get("type", "fake_multinode")
    _require(ptype in _PROVIDER_TYPES, "provider.type",
             f"must be one of {sorted(_PROVIDER_TYPES)}, got {ptype!r}")
    cfg.provider = ProviderConfig(
        type=ptype,
        project_id=prov.get("project_id"),
        zone=prov.get("zone"),
        accelerator_type=prov.get("accelerator_type",
                                  DEFAULT_ACCELERATOR_TYPE),
        machine_type=prov.get("machine_type", DEFAULT_MACHINE_TYPE),
    )
    if ptype == "gpu_vm":
        _require(bool(cfg.provider.project_id), "provider.project_id",
                 "required for gpu_vm")
        _require(bool(cfg.provider.zone), "provider.zone",
                 "required for gpu_vm")

    for key in ("min_workers", "max_workers"):
        if key in raw:
            _require(isinstance(raw[key], int) and raw[key] >= 0, key,
                     f"must be a non-negative integer, got {raw[key]!r}")
            setattr(cfg, key, raw[key])
    _require(cfg.min_workers <= cfg.max_workers, "min_workers",
             f"min_workers ({cfg.min_workers}) exceeds max_workers "
             f"({cfg.max_workers})")
    if "idle_timeout_minutes" in raw:
        v = raw["idle_timeout_minutes"]
        _require(isinstance(v, (int, float)) and v >= 0,
                 "idle_timeout_minutes", f"must be >= 0, got {v!r}")
        cfg.idle_timeout_minutes = float(v)

    for section in ("head", "worker"):
        if section in raw:
            sec = _mapping(raw[section], section)
            unknown = set(sec) - {"resources", "labels"}
            _require(not unknown, section, f"unknown keys {sorted(unknown)}")
            node = NodeTypeConfig()
            if "resources" in sec:
                node.resources = _resources(sec["resources"],
                                            f"{section}.resources")
            if "labels" in sec:
                labels = _mapping(sec["labels"], f"{section}.labels")
                node.labels = {str(k): str(v) for k, v in labels.items()}
            setattr(cfg, section, node)

    if "auth" in raw:
        sec = _mapping(raw["auth"], "auth")
        unknown = set(sec) - {"ssh_user", "ssh_private_key"}
        _require(not unknown, "auth", f"unknown keys {sorted(unknown)}")
        cfg.auth = AuthConfig(
            ssh_user=sec.get("ssh_user", "ray"),
            ssh_private_key=sec.get("ssh_private_key"))

    if "setup_commands" in raw:
        cmds = raw["setup_commands"]
        _require(isinstance(cmds, list)
                 and all(isinstance(c, str) for c in cmds),
                 "setup_commands", "must be a list of strings")
        cfg.setup_commands = list(cmds)

    if "dry_run" in raw:
        _require(isinstance(raw["dry_run"], bool), "dry_run",
                 "must be a boolean")
        cfg.dry_run = raw["dry_run"]
    return cfg


def load_config(path: str) -> ClusterConfig:
    import yaml

    with open(os.path.expanduser(path)) as f:
        raw = yaml.safe_load(f)
    _require(isinstance(raw, dict), path, "cluster YAML must be a mapping")
    return validate_config(raw)
