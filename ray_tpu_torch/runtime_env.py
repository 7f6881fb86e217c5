"""Runtime environments: not ported yet (ROADMAP.md queue 1, item 4).

The port runs every worker in the driver's environment. A task, actor or
deployment that asks for a non-empty ``runtime_env`` (``env_vars``,
``working_dir``, ``py_modules``, ``pip``) is refused at submission by
``normalize``, so the node's env-build paths, which the JAX package's
``ray_tpu/runtime_env.py`` serves, are never reached.
"""

from __future__ import annotations

from typing import Any, Dict, Set

from ray_tpu_torch.core.errors import not_ported


class RuntimeEnvBuildError(RuntimeError):
    """Deterministic env-build failure (the JAX package's type, so the
    node's lease path reads the same)."""


def normalize(runtime_env: Dict[str, Any]) -> Dict[str, Any]:
    raise not_ported("a non-empty runtime_env", "item 4, runtime_env")


def build_env(runtime_env: Dict[str, Any], controller) -> Dict[str, Any]:
    raise not_ported("a non-empty runtime_env", "item 4, runtime_env")


def gc_envs(budget_bytes: int, in_use: Set[str]) -> None:
    """Nothing to collect: the port materializes no env."""


def pin_env_dir(env_dir: str, worker_hex: str, pid: int) -> None:
    raise not_ported("a non-empty runtime_env", "item 4, runtime_env")


def unpin_env_dir(env_dir: str, worker_hex: str) -> None:
    raise not_ported("a non-empty runtime_env", "item 4, runtime_env")
