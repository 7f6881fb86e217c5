"""Durable workflows on the port (``ray_tpu_torch.workflow``): the four
workflow cases of ``tests/test_ft_subsystems.py`` under the same names
(run and resume after a failed step, no finished step run again, a
dynamic continuation, an event listener), and one parity case: the same
workflow (``tests/torch_host_program.workflow_program``: three steps and
a continuation, its third step failing once) on ``ray_tpu``, then on
``ray_tpu_torch``, with equal results, statuses, runs of each step and
file names in storage (the step keys hash each step's position and its
function's name, so both packages key it alike). Results are exact:
no tolerance."""

import os

import pytest

import ray_tpu_torch
import torch_host_program as prog
from torch_fixtures import ray_start_regular  # noqa: F401


def test_workflow_run_and_resume(ray_start_regular, tmp_path):
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    marker = str(tmp_path / "ran_flaky")

    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    @ray_tpu_torch.remote
    def flaky_add(x):
        # Fails the first time only (simulates a crash mid-workflow).
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("1")
            raise RuntimeError("transient failure")
        return x + 5

    @ray_tpu_torch.remote(max_retries=0)
    def flaky_add_noretry(x):
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("1")
            raise RuntimeError("transient failure")
        return x + 5

    storage = str(tmp_path / "durable")
    with InputNode() as inp:
        dag = flaky_add_noretry.bind(double.bind(inp))

    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf1", storage=storage, args=10)
    assert workflow.get_status("wf1", storage=storage) == "FAILED"

    result = workflow.resume("wf1", storage=storage)
    assert result == 25  # 10*2 + 5
    assert workflow.get_status("wf1", storage=storage) == "SUCCEEDED"
    # Resume of a finished workflow returns the stored result instantly.
    assert workflow.resume("wf1", storage=storage) == 25


def test_workflow_steps_not_reexecuted(ray_start_regular, tmp_path):
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    count_file = str(tmp_path / "count")

    @ray_tpu_torch.remote
    def counted(x):
        n = 0
        if os.path.exists(count_file):
            with open(count_file) as f:
                n = int(f.read())
        with open(count_file, "w") as f:
            f.write(str(n + 1))
        return x + 1

    storage = str(tmp_path / "durable2")
    with InputNode() as inp:
        dag = counted.bind(inp)
    assert workflow.run(dag, workflow_id="wf2", storage=storage,
                        args=1) == 2
    assert workflow.resume("wf2", storage=storage) == 2
    with open(count_file) as f:
        assert int(f.read()) == 1  # executed exactly once


def test_workflow_dynamic_continuation(ray_start_regular, tmp_path):
    """A step returning workflow.continuation(sub_dag) has the sub-graph
    executed durably in its place (reference: dynamic workflows,
    workflow_executor.py continuations), including nesting and resume."""
    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    count_file = str(tmp_path / "leaf_runs")

    @ray_tpu_torch.remote
    def leaf(x):
        n = int(open(count_file).read()) if os.path.exists(count_file) else 0
        with open(count_file, "w") as f:
            f.write(str(n + 1))
        return x * 10

    @ray_tpu_torch.remote
    def fan_in(a, b):
        return a + b

    @ray_tpu_torch.remote
    def planner(x):
        # Dynamic: the shape of the rest of the workflow depends on x.
        from ray_tpu_torch import workflow as wf
        return wf.continuation(fan_in.bind(leaf.bind(x), leaf.bind(x + 1)))

    storage = str(tmp_path / "durable")
    with InputNode() as inp:
        dag = planner.bind(inp)
    result = workflow.run(dag, workflow_id="dyn1", storage=storage, args=3)
    assert result == 3 * 10 + 4 * 10
    assert int(open(count_file).read()) == 2
    # Resume of the finished workflow replays from storage: no new runs.
    assert workflow.resume("dyn1", storage=storage) == 70
    assert int(open(count_file).read()) == 2


def test_workflow_event_listener(ray_start_regular, tmp_path):
    """workflow.event() blocks until the listener fires and persists the
    payload — a resumed workflow does not wait again."""
    import pickle
    import threading
    import time as _t

    from ray_tpu_torch import workflow
    from ray_tpu_torch.dag import InputNode

    evt_path = str(tmp_path / "evt")

    @ray_tpu_torch.remote
    def combine(x, payload):
        return f"{x}:{payload}"

    storage = str(tmp_path / "durable")
    with InputNode() as inp:
        dag = combine.bind(
            inp, workflow.event(workflow.FileEventListener(evt_path),
                                poll_interval_s=0.05))

    def fire():
        _t.sleep(0.5)
        with open(evt_path, "wb") as f:
            pickle.dump("lift-off", f)

    threading.Thread(target=fire, daemon=True).start()
    t0 = _t.monotonic()
    result = workflow.run(dag, workflow_id="evt1", storage=storage,
                          args="go")
    assert result == "go:lift-off"
    assert _t.monotonic() - t0 >= 0.4  # actually waited for the event
    # Payload persisted: resume doesn't need the file anymore.
    os.unlink(evt_path)
    assert workflow.resume("evt1", storage=storage) == "go:lift-off"



def test_workflow_matches_jax(tmp_path):
    import ray_tpu

    out = {}
    for name, pkg in (("ray_tpu", ray_tpu), ("ray_tpu_torch",
                                              ray_tpu_torch)):
        pkg.init(num_cpus=4)
        try:
            out[name] = prog.workflow_program(
                name, str(tmp_path / name / "store"),
                str(tmp_path / name / "marks"))
        finally:
            pkg.shutdown()
    got, want = out["ray_tpu_torch"], out["ray_tpu"]
    assert got == want
    assert got["first_run"] is True
    assert got["status_failed"] == "FAILED"
    assert got["result"] == got["again"] == "total=30"
    assert got["status_done"] == "SUCCEEDED"
    # The failed step ran twice; no finished step ran again on resume.
    assert got["runs"] == {"label": 1, "load": 1, "plan": 1, "square": 1,
                           "total": 2}
    # Four step files, the continuation's, and the three records.
    assert len(got["files"]) == 8
    assert {"__graph__.pkl", "__result__.pkl",
            "__status__.pkl"} <= set(got["files"])
