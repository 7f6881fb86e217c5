"""Build the native shared library (g++ -shared), cached by source mtime
(copy of ``ray_tpu/_native/build.py``).

The reference builds its native layer with bazel (``BUILD.bazel``); here the
native surface is small enough that a direct g++ invocation at the first
``ShmStore`` use (never at import) keeps the dev loop to sub-second
rebuilds. The built ``.so`` lands in ``ray_tpu_torch/_build/``, which git
ignores, beside the CUDA kernels' libraries.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()


def build_library(name: str, sources: list, extra_flags: list = ()) -> str:
    """Compile ``sources`` (relative to _native/) into _build/lib<name>.so,
    rebuilding only when a source is newer than the output. Returns the path.
    """
    out = os.path.join(_BUILD_DIR, f"lib{name}.so")
    srcs = [os.path.join(_DIR, s) for s in sources]
    with _LOCK:
        if _fresh(out, srcs):
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # One builder across processes too (every worker of a cluster
        # opens the store): the others wait for the .so on this lock.
        with open(out[:-3] + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _fresh(out, srcs):
                # Compiling under _LOCK is deliberate: one build per
                # process, the other threads wait for the .so instead of
                # racing g++ on the same output.
                # graftlint: disable=lock-held-blocking
                _compile(out, srcs, extra_flags)
    return out


def _fresh(out: str, srcs: list) -> bool:
    if not os.path.exists(out):
        return False
    out_mtime = os.path.getmtime(out)
    return all(os.path.getmtime(s) <= out_mtime for s in srcs)


def _compile(out: str, srcs: list, extra_flags) -> None:
    tmp = out + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-g", "-shared", "-fPIC", "-std=c++17",
           "-pthread", *extra_flags, "-o", tmp, *srcs]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, out)  # atomic: a reader never maps a partial file
