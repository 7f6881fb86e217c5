"""Worker forkserver: pre-imported template process that ``os.fork()``s
warm workers on demand (copy of ``ray_tpu/core/forkserver.py``).

Answer to the reference's prestarted worker pool
(``src/ray/raylet/worker_pool.h:357`` ``PrestartWorkers`` +
``StartWorkerProcess`` ``worker_pool.h:423``): instead of paying interpreter
startup + imports per worker process, the node supervisor starts ONE template
process that imports the worker hot path once, then forks children in
~10 ms each. Children inherit the warm import state copy-on-write and jump
straight into ``worker_main.run``.

Why a custom forkserver rather than ``multiprocessing``'s: the child must
exec nothing (keeping the warm imports is the whole point), must re-point
stdout/stderr at per-worker session log files before any user code runs, and
must stay attached to the node's registration/ping protocol — all of which
is a 30-line ``os.fork`` away here and fights the stdlib harness otherwise.

Protocol (stdin/stdout of the template, length-prefixed pickle):
  request  {"worker_id": hex, "env": {str: str}, "stdout": path|None,
            "stderr": path|None}
  reply    {"pid": int} | {"error": str}

The template is SINGLE-THREADED (fork in a threaded process deadlocks
arbitrary locks); it reaps dead children via SIGCHLD so the node never
accumulates zombies, and exits when its stdin closes (node death — the same
orphan protection workers get from their node ping loop).

Fork-safety note: children MUST NOT inherit the template's signal handler —
they restore default SIGCHLD before running, or CoreWorker subprocesses
(none today, but spill helpers may come) would be mis-reaped.
"""

from __future__ import annotations

import os
import pickle
import signal
import struct
import sys


def _read_msg(f):
    header = f.read(4)
    if len(header) < 4:
        return None
    (n,) = struct.unpack("!I", header)
    body = f.read(n)
    if len(body) < n:
        return None
    return pickle.loads(body)


def _write_msg(f, obj) -> None:
    blob = pickle.dumps(obj, protocol=5)
    f.write(struct.pack("!I", len(blob)) + blob)
    f.flush()


def _reap(_signum, _frame) -> None:
    try:
        while True:
            pid, _ = os.waitpid(-1, os.WNOHANG)
            if pid <= 0:
                break
    except OSError:
        pass


def _child(req, node_addr, controller_addr, node_id_hex: str) -> "int":
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    os.environ.update(req.get("env") or {})
    # Per-worker session log files, wired before ANY output (the log
    # monitor tails these; reference: default_worker.py stdout/stderr
    # redirection under session_latest/logs).
    for path, fd in ((req.get("stdout"), 1), (req.get("stderr"), 2)):
        if path:
            log_fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                             0o644)
            os.dup2(log_fd, fd)
            os.close(log_fd)
    if not req.get("stdout"):
        # fd 1 is the template's REPLY PIPE — a stray user print would
        # corrupt the fork protocol. Point it wherever stderr goes.
        os.dup2(2, 1)
    # fd 0 is the template's REQUEST PIPE: user code reading stdin would
    # race the template and eat fork-request bytes.
    null_fd = os.open(os.devnull, os.O_RDONLY)
    os.dup2(null_fd, 0)
    os.close(null_fd)
    sys.stdout = os.fdopen(1, "w", buffering=1, closefd=False)
    sys.stderr = os.fdopen(2, "w", buffering=1, closefd=False)
    from ray_tpu_torch.core import worker_main

    return worker_main.run(node_addr, controller_addr, node_id_hex,
                           req["worker_id"])


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--node-host", required=True)
    parser.add_argument("--node-port", type=int, required=True)
    parser.add_argument("--controller-host", required=True)
    parser.add_argument("--controller-port", type=int, required=True)
    parser.add_argument("--node-id", required=True)
    args = parser.parse_args()
    node_addr = (args.node_host, args.node_port)
    controller_addr = (args.controller_host, args.controller_port)

    # Warm the import state children will inherit copy-on-write. Everything
    # a CoreWorker touches before its first task; NOT torch, and never a
    # CUDA call: the node runs this template with the card hidden, and a
    # CUDA context does not survive fork. GPU leases get a fresh
    # interpreter instead (core/node.py).
    from ray_tpu_torch.core import runtime, serialization  # noqa: F401
    from ray_tpu_torch.core import object_store, rpc, ids  # noqa: F401

    signal.signal(signal.SIGCHLD, _reap)
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    while True:
        try:
            req = _read_msg(stdin)
        except (OSError, EOFError, pickle.UnpicklingError):
            break
        if req is None:  # stdin closed: node is gone
            break
        try:
            pid = os.fork()
        except OSError as e:
            _write_msg(stdout, {"error": f"fork failed: {e}"})
            continue
        if pid == 0:
            code = 1
            try:
                code = _child(req, node_addr, controller_addr, args.node_id)
            except BaseException:
                import traceback

                traceback.print_exc()
            finally:
                # Skip atexit/gc of inherited state: exit NOW, flushing only
                # this child's own streams.
                try:
                    sys.stdout.flush()
                    sys.stderr.flush()
                except Exception:  # graftlint: disable=swallowed-exception
                    # About to os._exit inside a forked child: nothing
                    # to report to, nowhere to report.
                    pass
                os._exit(code)
        _write_msg(stdout, {"pid": pid})
    return 0


if __name__ == "__main__":
    sys.exit(main())
