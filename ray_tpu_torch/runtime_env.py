"""Runtime environments: per-task/actor isolated Python environments (copy
of ``ray_tpu/runtime_env.py``).

Analogue of the reference's runtime-env subsystem
(``_private/runtime_env/agent/runtime_env_agent.py:162`` builds envs on
each node; ``packaging.py`` ships working_dir/py_modules zips through the
GCS KV; ``runtime_env/pip.py`` builds per-env virtualenvs). The supported
spec keys:

* ``env_vars``: dict merged into the worker's environment at fork.
* ``working_dir``: local path (same-host clusters) or ``kv://<key>`` from
  :func:`upload_working_dir` — extracted once per node per env hash, set
  as the worker's cwd and prepended to ``PYTHONPATH``.
* ``py_modules``: list of module/package paths or ``kv://`` zips from
  :func:`upload_py_module` — each lands on the worker's ``PYTHONPATH``.
* ``pip``: list of requirement strings (or local wheel paths). Built into
  a per-hash virtualenv on each node (``--system-site-packages`` so torch
  & friends stay visible — the CUDA stack must not be reinstalled per env),
  cached across leases; the worker forks from the venv's interpreter.
  Build failures surface at lease time as the task's error (reference:
  ``pip.py`` + the agent's CreateRuntimeEnv reply).
* ``image_uri``: container-image seam (reference:
  ``runtime_env/image_uri.py``). On hosts without a container runtime the
  only backing is ``dir://<path>`` — a pre-unpacked image root used as
  the worker's cwd; ``docker://`` URIs fail the lease with a clear error.
  Third parties add further isolation backends via
  :func:`register_plugin` (reference: ``runtime_env/plugin.py``).

Workers are pooled per runtime-env hash (reference: worker_pool.h's
runtime_env_hash matching), so repeated tasks with the same env reuse
their workers.

**Cache GC** (reference: the agent's URI reference counting + cache
eviction in ``runtime_env/plugin.py``): every materialized dir under
``ENV_ROOT`` is LRU-tracked via its ``.ready`` marker's mtime;
:func:`gc_envs` evicts past a size budget, skipping dirs pinned by live
workers. The node supervisor runs it periodically
(``runtime_env_cache_bytes``).
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import tempfile
import threading
import zipfile
from typing import Any, Dict, List, Optional

ENV_ROOT = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_envs")


class RuntimeEnvBuildError(RuntimeError):
    """Deterministic env-build failure (bad pip requirement, missing
    image root, …): leases fail FAST instead of retrying until the lease
    deadline — the same spec will fail the same way on every node."""

_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
_MAX_PACKAGE_BYTES = 100 * 1024 * 1024


def package_working_dir(path: str, arcname_prefix: str = "") -> bytes:
    """Zip a directory (reference: packaging.py's package zips), size-capped.
    ``arcname_prefix`` nests the content under one directory inside the
    archive (py_modules packages zip under their own name)."""
    buf = io.BytesIO()
    root = os.path.abspath(path)
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in _EXCLUDE_DIRS]
            for fname in filenames:
                full = os.path.join(dirpath, fname)
                total += os.path.getsize(full)
                if total > _MAX_PACKAGE_BYTES:
                    raise ValueError(
                        f"package {path} exceeds "
                        f"{_MAX_PACKAGE_BYTES >> 20} MiB")
                zf.write(full, os.path.join(
                    arcname_prefix, os.path.relpath(full, root)))
    return buf.getvalue()


def _upload_blob(blob: bytes) -> str:
    import hashlib

    from ray_tpu_torch.core.runtime import get_core_worker

    key = f"__pkg__/{hashlib.sha1(blob).hexdigest()[:20]}.zip"
    get_core_worker().controller.call("kv_put", key, blob)
    return f"kv://{key}"


def upload_working_dir(path: str) -> str:
    """Package + upload a working dir to the cluster KV; returns the
    ``kv://`` URI to put in ``runtime_env['working_dir']``."""
    return _upload_blob(package_working_dir(path))


def materialize_working_dir(spec: str, controller_client) -> str:
    """Resolve a working_dir spec to a local directory: plain paths pass
    through; ``kv://`` packages are fetched from the controller KV and
    extracted once per content hash (used by the worker pool AND job
    supervisors)."""
    if not str(spec).startswith("kv://"):
        return str(spec)
    import hashlib

    key = str(spec)[len("kv://"):]
    dest = os.path.join(ENV_ROOT,
                        hashlib.sha1(key.encode()).hexdigest()[:16])
    marker = os.path.join(dest, ".ready")
    if not os.path.exists(marker):
        blob = controller_client.call("kv_get", key)
        if blob is None:
            raise RuntimeEnvBuildError(
                f"working_dir package {key} not in KV")
        os.makedirs(dest, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(dest)
        with open(marker, "w") as f:
            f.write("ok")
    return dest


def upload_py_module(path: str) -> str:
    """Package one module/package (zipped UNDER its own name, so the
    extraction dir is a valid sys.path entry) and upload to the KV; returns
    the ``kv://`` URI for ``runtime_env['py_modules']`` (reference:
    packaging.py py_modules upload)."""
    root = os.path.abspath(path)
    name = os.path.basename(root.rstrip("/"))
    if os.path.isfile(root):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.write(root, name)
        return _upload_blob(buf.getvalue())
    return _upload_blob(package_working_dir(root, arcname_prefix=name))


def materialize_py_module(spec: str, controller_client) -> str:
    """Resolve one py_modules entry to a sys.path directory: ``kv://``
    zips extract (cached per content) and the extraction dir is the path
    entry; plain paths contribute their parent directory."""
    if str(spec).startswith("kv://"):
        return materialize_working_dir(spec, controller_client)
    return os.path.dirname(os.path.abspath(str(spec)))


# ----------------------------------------------------------- pip / venv

_pip_lock = threading.Lock()


def pip_env_dir(pip: List[str]) -> str:
    import hashlib
    import json

    key = hashlib.sha1(
        json.dumps(list(pip), sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(ENV_ROOT, f"venv-{key}")


def ensure_pip_env(pip: List[str]) -> str:
    """Build (once, cached per requirement-list hash) a virtualenv with the
    requested packages; returns its python executable. The venv sees the
    base interpreter's site-packages (--system-site-packages), so torch
    and the CUDA stack are inherited, not reinstalled (reference:
    runtime_env/pip.py builds a venv per env and caches by URI hash)."""
    dest = pip_env_dir(pip)
    python = os.path.join(dest, "bin", "python")
    marker = os.path.join(dest, ".ready")
    if os.path.exists(marker):
        return python
    with _pip_lock:  # serialize builds in this node process
        if os.path.exists(marker):
            return python
        build = f"{dest}.build-{os.getpid()}"
        try:
            # Building the venv under _pip_lock is the point of the
            # lock: concurrent builds of the same env would thrash pip's
            # cache and race the final rename; waiters get the marker
            # fast-path the moment the first build lands.
            # graftlint: disable=lock-held-blocking
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 build],
                check=True, capture_output=True, text=True, timeout=300)
            # graftlint: disable=lock-held-blocking
            proc = subprocess.run(
                [os.path.join(build, "bin", "python"), "-m", "pip",
                 "install", "--no-input", *pip],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                # Deterministic for the spec in the common case (bad
                # requirement); genuinely-transient index trouble is rare
                # and recoverable at the task-retry layer.
                raise RuntimeEnvBuildError(
                    f"pip install {pip} failed: "
                    f"{(proc.stderr or proc.stdout)[-800:]}")
            with open(os.path.join(build, ".ready"), "w") as f:
                f.write("ok")
            try:
                os.rename(build, dest)
            except OSError:
                if not os.path.exists(marker):  # lost a cross-process race
                    raise
        finally:
            import shutil

            # graftlint: disable=lock-held-blocking  (cleanup of the
            # build dir belongs to the same critical section)
            shutil.rmtree(build, ignore_errors=True)
    return python


# --------------------------------------------------------------- plugins


class RuntimeEnvPlugin:
    """Isolation-backend seam (reference: ``runtime_env/plugin.py``'s
    RuntimeEnvPlugin + ``image_uri.py``). A plugin owns one spec key:
    ``validate`` runs at submission time (driver side), ``build`` at
    lease time on the worker's node, mutating the build output in place
    (set ``python`` for a different interpreter, ``cwd`` for a rooted
    filesystem, extend ``pythonpath``/``env_vars``). Build failures
    become the lease's error."""

    name: str = ""

    def validate(self, value: Any) -> Any:
        return value

    def build(self, value: Any, controller_client,
              out: Dict[str, Any]) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class ImageURIPlugin(RuntimeEnvPlugin):
    """Container-image seam. Backings:

    * ``dir://<path>`` — a pre-unpacked image root (the only backing on
      hosts without a container runtime): becomes the
      worker's cwd, and its ``site-packages`` (if present) joins
      PYTHONPATH.
    * anything else (``docker://…``) — fails the lease with a clear
      error until a container runtime backend is registered.
    """

    name = "image_uri"

    def validate(self, value: Any) -> str:
        value = str(value)
        if "://" not in value:
            raise ValueError(
                "runtime_env['image_uri'] must be a URI (dir://<path> on "
                "container-less hosts, docker://<image> with a container "
                "runtime)")
        return value

    def build(self, value: Any, controller_client,
              out: Dict[str, Any]) -> None:
        uri = str(value)
        if uri.startswith("dir://"):
            root = uri[len("dir://"):]
            if not os.path.isdir(root):
                raise RuntimeEnvBuildError(
                    f"image root {root} does not exist")
            touch_env_dir(root)
            out["cwd"] = root
            site = os.path.join(root, "site-packages")
            if os.path.isdir(site):
                out["pythonpath"].append(site)
            out["env_vars"].setdefault("RAY_TPU_IMAGE_URI", uri)
            return
        raise RuntimeEnvBuildError(
            f"no container runtime available for {uri!r} on this host "
            f"(supported here: dir://<unpacked-image-root>)")


_plugins: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise ValueError("plugin needs a name (its runtime_env key)")
    _plugins[plugin.name] = plugin


register_plugin(ImageURIPlugin())


# ------------------------------------------------------------------- GC


def touch_env_dir(path: str) -> None:
    """Mark an env dir as recently used (LRU clock for gc_envs)."""
    marker = os.path.join(path, ".ready")
    try:
        os.utime(marker if os.path.exists(marker) else path)
    except OSError:
        pass


def pin_env_dir(path: str, worker_id_hex: str, pid: int) -> None:
    """Record a live-process pin inside the env dir. Pins are HOST-global
    (ENV_ROOT is shared by every node on the host, and by every test
    session): GC honors any pin whose pid is still alive, so one node's
    eviction can never delete another node's live worker's env."""
    d = os.path.join(path, ".pins")
    try:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, worker_id_hex), "w") as f:
            f.write(str(pid))
    except OSError:
        pass


def unpin_env_dir(path: str, worker_id_hex: str) -> None:
    try:
        os.unlink(os.path.join(path, ".pins", worker_id_hex))
    except OSError:
        pass


def _has_live_pin(path: str) -> bool:
    pins = os.path.join(path, ".pins")
    try:
        names = os.listdir(pins)
    except OSError:
        return False
    for name in names:
        try:
            with open(os.path.join(pins, name)) as f:
                pid = int(f.read().strip() or 0)
        except (OSError, ValueError):
            continue
        if pid <= 0:
            continue
        try:
            os.kill(pid, 0)  # alive (or zombie) => pinned
            return True
        except OSError:
            # Dead owner: clear the stale pin.
            try:
                os.unlink(os.path.join(pins, name))
            except OSError:
                pass
    return False


def _dir_bytes(path: str) -> int:
    total = 0
    for dirpath, _dirnames, filenames in os.walk(path):
        for f in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, f))
            except OSError:
                pass
    return total


def gc_envs(budget_bytes: int, in_use: Optional[set] = None,
            root: str = ENV_ROOT, min_age_s: float = 300.0) -> List[str]:
    """Evict least-recently-used env dirs until the cache fits the
    budget. Never touched: dirs in ``in_use``, dirs with a live pid pin
    (``pin_env_dir`` — covers OTHER nodes' workers on this shared host),
    dirs younger than ``min_age_s`` (closes the build-to-fork window and
    prevents evict-the-freshest thrash when pinned dirs alone exceed the
    budget), and half-built dirs (no ``.ready``). Returns the evicted
    paths (reference: the agent's URI cache eviction,
    runtime_env/plugin.py — without GC ENV_ROOT grows
    forever)."""
    import shutil
    import time as _time

    in_use = {os.path.abspath(p) for p in (in_use or set())}
    entries = []
    try:
        names = os.listdir(root)
    except OSError:
        return []
    now = _time.time()
    for name in names:
        path = os.path.abspath(os.path.join(root, name))
        marker = os.path.join(path, ".ready")
        try:
            if not os.path.isdir(path) or not os.path.exists(marker):
                continue  # half-built or foreign: leave it alone
            mtime = os.path.getmtime(marker)
            size = _dir_bytes(path)
        except OSError:
            continue  # vanished mid-scan (concurrent GC): skip
        entries.append((mtime, path, size))
    total = sum(size for _m, _p, size in entries)
    evicted: List[str] = []
    for mtime, path, size in sorted(entries):  # oldest first
        if total <= budget_bytes:
            break
        if path in in_use or now - mtime < min_age_s:
            continue
        if _has_live_pin(path):
            continue
        shutil.rmtree(path, ignore_errors=True)
        evicted.append(path)
        total -= size
    return evicted


def build_env(runtime_env: Dict[str, Any],
              controller_client) -> Dict[str, Any]:
    """Materialize a full runtime env on this node. Returns
    ``{python, pythonpath, cwd, env_vars, env_dirs}`` for the worker fork
    (``env_dirs`` = cache dirs the worker now pins against GC); raises on
    build failure (the node surfaces it in the lease reply — reference:
    the raylet failing a lease when the agent's CreateRuntimeEnv errors)."""
    out: Dict[str, Any] = {
        "python": None,
        "pythonpath": [],
        "cwd": None,
        "env_vars": {str(k): str(v) for k, v in
                     (runtime_env.get("env_vars") or {}).items()},
        "env_dirs": [],
    }
    try:
        wd = runtime_env.get("working_dir")
        if wd:
            out["cwd"] = materialize_working_dir(wd, controller_client)
            out["pythonpath"].append(out["cwd"])
            touch_env_dir(out["cwd"])
            out["env_dirs"].append(out["cwd"])
        for mod in runtime_env.get("py_modules") or []:
            entry = materialize_py_module(mod, controller_client)
            out["pythonpath"].append(entry)
            touch_env_dir(entry)
            out["env_dirs"].append(entry)
        pip = runtime_env.get("pip")
        if pip:
            out["python"] = ensure_pip_env(list(pip))
            venv_dir = os.path.dirname(os.path.dirname(out["python"]))
            touch_env_dir(venv_dir)
            out["env_dirs"].append(venv_dir)
        for key, plugin in _plugins.items():
            if key in runtime_env:
                plugin.build(runtime_env[key], controller_client, out)
    except ValueError as e:
        # Spec validation problems are deterministic on every node.
        raise RuntimeEnvBuildError(str(e)) from e
    # Everything else: RuntimeEnvBuildError only where the RAISE SITE
    # knows the failure is deterministic (bad pip requirement, package
    # missing from the KV, missing image root). Node-local trouble (full
    # disk, transport blips) stays generic so the lease loop can exclude
    # the node and re-pick instead of aborting the submission.
    return out


def normalize(runtime_env: Dict[str, Any]) -> Dict[str, Any]:
    """Validate + normalize a runtime_env spec (uploads local working_dir
    automatically when the cluster spans hosts is the caller's choice —
    pass a kv:// URI for that)."""
    out: Dict[str, Any] = {}
    env_vars = runtime_env.get("env_vars")
    if env_vars:
        out["env_vars"] = {str(k): str(v) for k, v in env_vars.items()}
    wd = runtime_env.get("working_dir")
    if wd:
        out["working_dir"] = str(wd)
    mods = runtime_env.get("py_modules")
    if mods:
        if not isinstance(mods, (list, tuple)):
            raise ValueError("runtime_env['py_modules'] must be a list of "
                             "paths or kv:// URIs")
        out["py_modules"] = [str(m) for m in mods]
    pip = runtime_env.get("pip")
    if pip:
        if not isinstance(pip, (list, tuple)) or not all(
                isinstance(p, str) for p in pip):
            raise ValueError("runtime_env['pip'] must be a list of "
                             "requirement strings")
        out["pip"] = list(pip)
    for key, plugin in _plugins.items():
        if key in runtime_env:
            out[key] = plugin.validate(runtime_env[key])
    known = {"env_vars", "working_dir", "py_modules", "pip"} | set(_plugins)
    unknown = set(runtime_env) - known
    if unknown:
        raise ValueError(f"unsupported runtime_env keys: {sorted(unknown)} "
                         f"(supported: {sorted(known)})")
    return out
