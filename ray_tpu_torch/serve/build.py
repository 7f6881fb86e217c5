"""Config-file serve deployment (reference: ``serve build`` /
``serve deploy config.yaml`` — ``serve/schema.py`` ServeDeploySchema +
``serve/scripts.py``).

A YAML/dict config declares applications by import path; ``deploy_config``
imports each app, applies per-deployment overrides, and runs it against
the (detached) serve controller — so deployments are declarative and
re-runnable from CI, not just from a driver script.

Schema (subset of the reference's, same shape)::

    applications:
      - name: summarizer
        import_path: my_module:app      # a Deployment (bound or not)
        route_prefix: /summarize        # optional
        num_replicas: 2                 # optional override
        max_ongoing_requests: 8         # optional override
        mesh_shape: [2, 4]              # optional: chips per replica
        init_args: []                   # optional (unbound deployments)
        init_kwargs: {}

CLI: ``python -m ray_tpu serve deploy config.yaml | status | shutdown``.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional, Union


def _load_import_path(spec: str):
    module_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {spec!r} must be 'module:attribute'")
    module = importlib.import_module(module_name)
    obj = module
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def load_config(path_or_dict: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    import yaml

    with open(path_or_dict) as f:
        return yaml.safe_load(f)


def deploy_config(path_or_dict: Union[str, Dict[str, Any]],
                  ready_timeout_s: float = 60.0) -> List[Any]:
    """Deploy every application in the config; returns their handles."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.deployment import Deployment

    config = load_config(path_or_dict)
    apps = config.get("applications") or []
    if not apps:
        raise ValueError("config has no 'applications'")
    handles = []
    for app_cfg in apps:
        target = _load_import_path(app_cfg["import_path"])
        if not isinstance(target, Deployment):
            raise TypeError(
                f"{app_cfg['import_path']} resolved to {type(target)}; "
                f"expected a @serve.deployment object")
        overrides = {k: app_cfg[k] for k in
                     ("num_replicas", "max_ongoing_requests",
                      "autoscaling_config", "mesh_shape")
                     if k in app_cfg}
        if isinstance(overrides.get("autoscaling_config"), dict):
            from ray_tpu_torch.serve.deployment import AutoscalingConfig

            overrides["autoscaling_config"] = AutoscalingConfig(
                **overrides["autoscaling_config"])
        # options() always: it clones, so bind() below never mutates the
        # module-level Deployment (one import_path can serve many apps).
        target = target.options(**overrides)
        if app_cfg.get("init_args") or app_cfg.get("init_kwargs"):
            target = target.bind(*(app_cfg.get("init_args") or ()),
                                 **(app_cfg.get("init_kwargs") or {}))
        handles.append(serve.run(
            target,
            name=app_cfg.get("name"),
            route_prefix=app_cfg.get("route_prefix"),
            ready_timeout_s=ready_timeout_s))
    return handles
