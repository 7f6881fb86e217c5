"""The port's log monitor (``ray_tpu_torch.core.log_monitor``): the 2
cases of ``tests/test_log_monitor.py`` under the same names; worker
prints reach the driver through pubsub.
"""

import io
import time

import pytest
from torch_fixtures import ray_start_regular  # noqa: F401


@pytest.mark.timeout_s(120)
def test_task_print_streams_to_driver(ray_start_regular):
    import ray_tpu_torch
    from ray_tpu_torch.core.log_monitor import LOG_CHANNEL, LogStreamer

    core = ray_start_regular
    marker = f"hello-from-task-{time.time_ns()}"

    @ray_tpu_torch.remote
    def shout():
        import sys

        print(marker)
        print(marker + "-err", file=sys.stderr)
        return 1

    assert ray_tpu_torch.get(shout.remote()) == 1

    # The node's monitor publishes the lines; poll the hub until they land.
    deadline = time.monotonic() + 30
    window = []
    while time.monotonic() < deadline:
        snap = core.controller.call("psub_snapshot", LOG_CHANNEL)
        window = [line for _ver, value in snap.values()
                  for _tag, line in value.get("window", [])]
        if any(marker in line for line in window) and any(
                marker + "-err" in line for line in window):
            break
        time.sleep(0.1)
    assert any(marker in line for line in window), window
    assert any(marker + "-err" in line for line in window), window

    # A fresh driver-side streamer replays the window with worker prefixes.
    buf = io.StringIO()
    streamer = LogStreamer.__new__(LogStreamer)
    streamer._controller = core.controller
    streamer._out = buf
    streamer._seen = {}
    streamer._versions = {}
    import threading

    streamer._stopped = threading.Event()
    streamer.poll_once(window_s=0.5)
    streamer.stop()
    text = buf.getvalue()
    assert marker in text
    assert "(worker-" in text


@pytest.mark.timeout_s(120)
def test_streamer_diffs_no_duplicates(ray_start_regular):
    import threading

    import ray_tpu_torch
    from ray_tpu_torch.core.log_monitor import LogStreamer

    core = ray_start_regular

    @ray_tpu_torch.remote
    def shout(i):
        print(f"line-{i}")
        return i

    assert ray_tpu_torch.get(shout.remote(1)) == 1
    buf = io.StringIO()
    streamer = LogStreamer.__new__(LogStreamer)
    streamer._controller = core.controller
    streamer._out = buf
    streamer._seen = {}
    streamer._versions = {}
    streamer._stopped = threading.Event()
    deadline = time.monotonic() + 30
    while "line-1" not in buf.getvalue() and time.monotonic() < deadline:
        streamer.poll_once(window_s=0.5)
    first = buf.getvalue().count("line-1")
    assert first >= 1
    # Re-polling with nothing new must not reprint old lines.
    streamer.poll_once(window_s=0.5)
    assert buf.getvalue().count("line-1") == first
    streamer.stop()
