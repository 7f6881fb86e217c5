"""Per-node log monitor + driver-side log streaming.

Reference analogue: ``python/ray/_private/log_monitor.py:103`` — workers
write stdout/stderr to per-worker files under the session log dir; a
per-node monitor tails them and publishes new lines to GCS pubsub; drivers
subscribe and echo the lines prefixed with the producing worker.

Here the monitor rides the controller's versioned long-poll pubsub
(``core/pubsub.py``). Because that hub stores only the *latest* value per
key, each publish carries a cumulative window of the last
``log_window_lines`` lines plus a monotonically increasing end counter —
the driver diffs counters to print exactly the unseen suffix, so bursts
between polls are never lost (up to the window size).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

LOG_CHANNEL = "logs"

# Transport slack ABOVE the long-poll window on every streamer RPC: the
# bound that turns a dead head into a typed RpcTimeout (the _loop's
# catch-and-backoff path) instead of a silently parked log pump.
_RPC_SLACK_S = 10.0


def worker_log_paths(node_hex: str, worker_hex: str) -> Tuple[str, str]:
    d = os.path.join(config.worker_log_dir, node_hex)
    os.makedirs(d, exist_ok=True)
    short = worker_hex[:8]
    return (os.path.join(d, f"worker-{short}.out"),
            os.path.join(d, f"worker-{short}.err"))


class LogMonitor:
    """Tails every worker log file under this node's log dir and publishes
    appended lines to the controller pubsub (one key per node)."""

    def __init__(self, node):
        self._node = node
        self._dir = os.path.join(config.worker_log_dir, node.node_id.hex())
        os.makedirs(self._dir, exist_ok=True)
        self._offsets: Dict[str, int] = {}
        self._window: List[Tuple[str, str]] = []  # (tag, line)
        self._end = 0  # lines ever published
        self._scan_lock = threading.Lock()  # scan_once callable off-thread
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="log-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.wait(config.log_monitor_scan_s):
            try:
                self.scan_once()
            except Exception:
                log_every("log_monitor.scan", 60.0, logger,
                          "log scan pass failed", exc_info=True)

    def scan_once(self) -> int:
        """Read appended bytes from every log file; publish if new lines.
        Serialized by a lock: the shutdown drain calls this concurrently
        with the scan thread."""
        with self._scan_lock:
            return self._scan_once_locked()

    def _scan_once_locked(self) -> int:
        new: List[Tuple[str, str]] = []
        try:
            names = sorted(os.listdir(self._dir))
        except OSError:
            return 0
        for name in names:
            path = os.path.join(self._dir, name)
            off = self._offsets.get(name, 0)
            try:
                size = os.path.getsize(path)
                if size <= off:
                    continue
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(size - off)
            except OSError:
                continue
            # Only consume complete lines; a partially written tail stays
            # for the next scan.
            cut = data.rfind(b"\n")
            if cut < 0:
                continue
            self._offsets[name] = off + cut + 1
            # Rotation: once the consumed prefix passes the cap, truncate
            # the file in place (workers write O_APPEND, so writes continue
            # at the new end; a line landing between read and truncate is
            # lost, which rotation accepts by design).
            if self._offsets[name] > config.log_rotation_max_bytes:
                try:
                    os.truncate(path, 0)
                    self._offsets[name] = 0
                except OSError:
                    pass
            tag = name.rsplit(".", 1)[0] + (
                ":err" if name.endswith(".err") else "")
            for raw in data[:cut].split(b"\n"):
                line = raw.decode("utf-8", "replace").rstrip("\r")
                if line:
                    new.append((tag, line))
        if not new:
            return 0
        self._window.extend(new)
        del self._window[:-config.log_window_lines]
        self._end += len(new)
        try:
            self._node._controller.notify(
                "psub_publish", LOG_CHANNEL, self._node.node_id.hex(),
                {"end": self._end, "window": list(self._window)})
        except Exception:
            # Lines stay in the window; the next scan republishes them.
            log_every("log_monitor.publish", 60.0, logger,
                      "log window publish failed", exc_info=True)
        return len(new)


class LogStreamer:
    """Driver-side subscriber: long-polls the logs channel for every node
    and echoes unseen lines to this process's stdout, prefixed with the
    producing worker (reference: log lines proxied to the driver with
    ``(pid=…, ip=…)`` prefixes)."""

    def __init__(self, controller_client, out=None):
        self._controller = controller_client
        self._out = out  # defaults to sys.stdout at print time
        self._seen: Dict[str, int] = {}  # node hex -> last end counter
        self._versions: Dict[str, int] = {}  # node hex -> pubsub version
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="log-streamer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                self.poll_once(window_s=5.0)
            except Exception:
                if self._stopped.wait(1.0):
                    return

    def poll_once(self, window_s: float = 5.0) -> int:
        """One long-poll round; returns number of lines printed.
        ``window_s`` is the server-side long-poll WINDOW (how long the
        head may hold the poll open waiting for new lines), not a call
        budget — each RPC below carries a transport bound of the window
        plus slack, so a dead head surfaces as a typed timeout rather
        than a parked streamer. Key discovery is version-only
        (psub_keys) — window payloads transfer only for keys that
        actually advanced."""
        keymap = self._controller.call("psub_keys", LOG_CHANNEL,
                                       timeout=window_s + _RPC_SLACK_S)
        printed = 0
        behind = {key: ver for key, ver in keymap.items()
                  if ver > self._versions.get(key, 0)}
        if behind:
            # Fetch just the advanced keys (version-1 so poll returns the
            # current value immediately).
            updates = self._controller.call(
                "psub_poll_many",
                {k: (LOG_CHANNEL, k, v - 1) for k, v in behind.items()},
                0.5, timeout=window_s + _RPC_SLACK_S)
            for key, (version, value) in (updates or {}).items():
                printed += self._emit(key, value)
                self._versions[key] = version
        if not keymap:
            # No node has published logs yet; re-check soon rather than
            # sleeping a full long-poll period (first-line latency).
            self._stopped.wait(min(window_s, 1.0))
            return printed
        watches = {key: (LOG_CHANNEL, key, self._versions.get(key, 0))
                   for key in keymap}
        updates = self._controller.call(
            "psub_poll_many", watches, window_s,
            timeout=window_s + _RPC_SLACK_S)
        for key, (version, value) in (updates or {}).items():
            printed += self._emit(key, value)
            self._versions[key] = version
        return printed

    def _emit(self, node_hex: str, value: dict) -> int:
        import sys

        end = value.get("end", 0)
        window = value.get("window", [])
        last = self._seen.get(node_hex, 0)
        fresh = min(end - last, len(window))
        if fresh <= 0:
            self._seen[node_hex] = max(last, end)
            return 0
        out = self._out or sys.stdout
        for tag, line in window[-fresh:]:
            print(f"({tag}, node={node_hex[:8]}) {line}", file=out)
        self._seen[node_hex] = end
        return fresh
