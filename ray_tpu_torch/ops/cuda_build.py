"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into its own shared library, loaded with ``ctypes``.
Builds happen at first use, never at import, into ``ray_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the source, the headers of
``csrc`` it includes (``hopper.cuh``) and the flags, so an edited kernel or
header is rebuilt and an unchanged one is reused. ``build`` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin``, else
    ``/usr/local/cuda/bin``; raises if none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from ray_tpu_torch/ops/csrc at first "
        "use and need the CUDA toolkit")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _sources(name: str, csrc: Path) -> List[Path]:
    """``<name>.cu`` and every file of ``csrc`` it includes by a quoted
    ``#include``, directly or through another such header, each once, in
    the order first reached."""
    csrc = Path(csrc)
    seen = [csrc / f"{name}.cu"]
    for path in seen:
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = csrc / inc.decode()
            if dep.exists() and dep not in seen:
                seen.append(dep)
    return seen


def _artifact(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for path in _sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the current build of ``name``, or '' before it is built."""
    log = _artifact(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str], csrc: Path = CSRC) -> List[Path]:
    """Compile every named kernel of ``csrc`` that has no current build,
    one ``nvcc`` process per source, all started together. Returns the
    libraries."""
    names = list(names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = []
        for name in names:
            out = _artifact(name, csrc)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(Path(csrc) / f"{name}.cu")]
            # Starting nvcc under _lock is deliberate: one build of each
            # kernel per process, the other threads wait for its library.
            # graftlint: disable=lock-held-blocking
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in pending:
            text, _ = proc.communicate()
            out.with_suffix(".log").write_text(text)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                              f"{text}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return [_artifact(n, csrc) for n in names]


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (from ``csrc``), building it
    first if needed. Every launch calls this: the cache is keyed by the
    directory as given, since resolving it costs file-system calls, which
    are slow on some hosts."""
    key = f"{csrc}/{name}"
    lib = _loaded.get(key)
    if lib is None:
        path = build([name], csrc)[0]
        with _lock:
            lib = _loaded.get(key)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _loaded[key] = lib
    return lib
