"""The user programs of ``tests/test_torch_workflow.py`` and
``tests/test_torch_util.py``: one durable workflow, and ActorPool, Queue
and the host collectives, run on ``ray_tpu`` and on ``ray_tpu_torch``
(the package name is an argument). Results are plain values, so the two
runs compare with ``==``.

The module imports neither package at import time: workers import it to
find the step functions and actor classes."""

from __future__ import annotations

import importlib
import os
import time

import numpy as np


def _count(path: str) -> int:
    """Add one to the run counter in ``path``; returns the new count."""
    n = int(open(path).read()) if os.path.exists(path) else 0
    with open(path, "w") as f:
        f.write(str(n + 1))
    return n + 1


# ---------------------------------------------------------- workflow


def wf_load(x, marks):
    _count(os.path.join(marks, "load"))
    return list(range(x))


def wf_square(xs, marks):
    _count(os.path.join(marks, "square"))
    return [v * v for v in xs]


def wf_total(xs, marks):
    """Fails on its first run only (a crash mid-workflow), guarded by a
    marker file."""
    if _count(os.path.join(marks, "total")) == 1:
        raise RuntimeError("interrupted")
    return sum(xs)


def wf_plan(total, marks, pkg):
    """A dynamic step: the rest of the workflow is a continuation."""
    _count(os.path.join(marks, "plan"))
    rt = importlib.import_module(pkg)
    workflow = importlib.import_module(f"{pkg}.workflow")
    return workflow.continuation(
        rt.remote(wf_label).bind(total, marks))


def wf_label(total, marks):
    _count(os.path.join(marks, "label"))
    return f"total={total}"


def workflow_program(pkg: str, storage: str, marks: str) -> dict:
    """Run a 3-step workflow with one continuation under an initialized
    ``pkg``: its third step fails once, ``resume`` finishes it, and a
    second ``resume`` returns the stored result. Returns the result, the
    statuses, the runs of each step and the files in storage."""
    rt = importlib.import_module(pkg)
    workflow = importlib.import_module(f"{pkg}.workflow")
    dag_mod = importlib.import_module(f"{pkg}.dag")
    os.makedirs(marks, exist_ok=True)
    no_retry = dict(max_retries=0)
    with dag_mod.InputNode() as inp:
        xs = rt.remote(**no_retry)(wf_load).bind(inp, marks)
        sq = rt.remote(**no_retry)(wf_square).bind(xs, marks)
        tot = rt.remote(**no_retry)(wf_total).bind(sq, marks)
        dag = rt.remote(**no_retry)(wf_plan).bind(tot, marks, pkg)
    out = {}
    try:
        workflow.run(dag, workflow_id="wf", storage=storage, args=5)
        out["first_run"] = "finished"
    except Exception as e:  # noqa: BLE001 - the interruption is the point
        out["first_run"] = "interrupted" in str(e)
    out["status_failed"] = workflow.get_status("wf", storage=storage)
    out["result"] = workflow.resume("wf", storage=storage)
    out["status_done"] = workflow.get_status("wf", storage=storage)
    out["again"] = workflow.resume("wf", storage=storage)
    out["runs"] = {name: int(open(os.path.join(marks, name)).read())
                   for name in sorted(os.listdir(marks))}
    out["files"] = sorted(os.listdir(os.path.join(storage, "workflows",
                                                  "wf")))
    return out


# --------------------------------------------------- pool, queue, collectives


class Squarer:
    def __init__(self, rank: int):
        self.rank = rank

    def square(self, x):
        time.sleep(0.01 * ((x * 7) % 3))  # finish out of order
        return x * x


class Member:
    """One rank of a host collective group."""

    def __init__(self, pkg: str, name: str, world: int, rank: int):
        coll = importlib.import_module(f"{pkg}.util.collective")
        self.group = coll.init_collective_group(name, world, rank)
        self.rank = rank

    def run(self, n: int):
        g = self.group
        base = np.arange(n, dtype=np.float32) + self.rank
        out = {"sum": g.allreduce(base, "sum"),
               "mean": g.allreduce(base, "mean"),
               "max": g.allreduce(base, "max"),
               "min": g.allreduce(base, "min"),
               "gather": g.allgather(base[:4]),
               "bcast": g.broadcast(base * 10 if self.rank == 2 else None,
                                    src_rank=2)}
        g.barrier()
        # A second round of the same op must not see the first's entries.
        out["sum2"] = g.allreduce(base * 2, "sum")
        return {k: (np.stack(v).tolist() if isinstance(v, list)
                    else np.asarray(v).tolist()) for k, v in out.items()}


def produce(pkg: str, q, n: int):
    for i in range(n):
        q.put(i, timeout=30)
    return n


def consume(pkg: str, q, n: int):
    return [q.get(timeout=30) for _ in range(n)]


def util_program(pkg: str) -> dict:
    """ActorPool, Queue and the collectives under an initialized ``pkg``;
    returns plain values."""
    rt = importlib.import_module(pkg)
    util = importlib.import_module(f"{pkg}.util")
    coll = importlib.import_module(f"{pkg}.util.collective")
    out = {}

    actors = [rt.remote(Squarer).options(num_cpus=0).remote(r)
              for r in range(4)]
    pool = util.ActorPool(actors)
    out["map"] = list(pool.map(lambda a, v: a.square.remote(v), range(12)))
    for v in range(8):
        if not pool.has_free():
            break
        pool.submit(lambda a, v: a.square.remote(v), v)
    unordered = []
    while pool.has_next():
        unordered.append(pool.get_next_unordered(timeout=30))
    out["unordered_sorted"] = sorted(unordered)
    try:
        for v in range(5):
            pool.submit(lambda a, v: a.square.remote(v), v)
        out["submit_past_idle"] = None
    except ValueError as e:
        out["submit_past_idle"] = str(e)
    out["drain"] = [pool.get_next(timeout=30) for _ in range(4)]
    for a in actors:
        rt.kill(a)

    q = util.Queue(maxsize=2)
    q.put("a")
    q.put("b")
    errs = []
    try:
        q.put("c", block=False)
    except util.Full:
        errs.append("full_nowait")
    t0 = time.monotonic()
    try:
        q.put("c", timeout=0.2)
    except util.Full:
        errs.append("full_timeout")
    out["full_waited"] = time.monotonic() - t0 >= 0.2
    out["qsize"] = q.qsize()
    out["fifo"] = [q.get(), q.get()]
    out["empty"] = q.empty()
    try:
        q.get(block=False)
    except util.Empty:
        errs.append("empty_nowait")
    try:
        q.get(timeout=0.2)
    except util.Empty:
        errs.append("empty_timeout")
    out["errors"] = errs
    q4 = util.Queue(maxsize=4)
    # Two tasks of one resource shape share a worker lease on both
    # runtimes, so the second waits for the first to end: the consumer
    # asks for another shape to run beside the producer it waits on.
    prod = rt.remote(produce).remote(pkg, q4, 20)
    cons = rt.remote(consume).options(num_cpus=2).remote(pkg, q4, 20)
    out["through"] = rt.get(cons, timeout=60)
    out["produced"] = rt.get(prod, timeout=60)

    coll.create_collective_group("g", 4)
    members = [rt.remote(Member).options(num_cpus=0).remote(pkg, "g", 4, r)
               for r in range(4)]
    out["collective"] = rt.get([m.run.remote(256) for m in members],
                               timeout=120)
    for m in members:
        rt.kill(m)
    return out
