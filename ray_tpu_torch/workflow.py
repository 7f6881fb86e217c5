"""Durable workflows: crash-resumable DAG execution (copy of
``ray_tpu/workflow.py``, with the same step keys in storage).

Analogue of the reference's workflow engine
(``workflow/workflow_executor.py`` + ``workflow_state_from_storage.py``):
every step's result is persisted to durable storage as it completes; a
crashed driver (or a deliberate ``resume``) reconstructs workflow state
from storage and re-executes only the steps whose results are missing.

Built on the same ``.bind()`` DAGs as ``ray_tpu_torch.dag`` — a workflow
IS a DAG plus a storage contract:

    with InputNode() as inp:
        dag = train.bind(preprocess.bind(inp))
    result = workflow.run(dag, workflow_id="exp1", storage="/durable", args=x)
    # ... crash anywhere ...
    result = workflow.resume("exp1", storage="/durable")   # skips done steps

Step identity: a content hash of the step's position in the graph + the
function's qualified name, so the same graph resumes onto the same step
files (the reference keys steps the same way, by step id in storage).

Dynamic workflows (reference: ``workflow/workflow_executor.py``
continuations): a step may return ``workflow.continuation(sub_dag)`` — the
engine executes the returned DAG in the step's place, durably, with the
sub-steps keyed under the parent step (resume replays finished sub-steps
from storage; the parent must re-return the same continuation shape, the
reference's determinism contract). Events (reference:
``workflow/event_listener.py``): ``workflow.event(listener)`` is a DAG
node that blocks until the listener's ``poll()`` yields a payload; the
payload persists like a step result, so a resumed workflow never re-waits
for an event it already consumed. Virtual actors are deliberately out of
scope (deprecated upstream).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode, InputNode  # noqa: F401 (re-export)


def _step_key(node: DAGNode, path: str) -> str:
    fn = getattr(node.fn, "_fn", node.fn)
    name = getattr(fn, "__qualname__", str(fn))
    return hashlib.sha1(f"{path}:{name}".encode()).hexdigest()[:16]


class Continuation:
    """A step's dynamic return: 'execute THIS graph in my place'. Capture
    happens step-side (``workflow.continuation(dag)``) so the graph ships
    home as a plain picklable record."""

    def __init__(self, dag: DAGNode):
        self.record = _make_picklable(dag)


def continuation(dag: DAGNode) -> Continuation:
    return Continuation(dag)


class EventListener:
    """Poll-based external event source (reference:
    ``workflow/event_listener.py``). ``poll()`` returns None while the
    event is absent, or the (picklable) payload once it fired. Listeners
    must be picklable — they persist in the workflow graph."""

    def poll(self):
        raise NotImplementedError


class FileEventListener(EventListener):
    """Fires when ``path`` exists; payload is the file's pickled content
    (or raw bytes when not a pickle)."""

    def __init__(self, path: str):
        self.path = path

    def poll(self):
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            data = f.read()
        try:
            return pickle.loads(data)
        except Exception:
            return data


def event(listener: EventListener, poll_interval_s: float = 0.2) -> DAGNode:
    """A DAG node that resolves to the listener's payload. Durable: once
    consumed, the payload is a stored step result and resume never waits
    again."""
    return DAGNode("event", None, (listener, float(poll_interval_s)), {})


def _wf_dir(storage: str, workflow_id: str) -> str:
    return os.path.join(storage, "workflows", workflow_id)


def _store(storage: str, workflow_id: str, key: str, value: Any) -> None:
    d = _wf_dir(storage, workflow_id)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, key + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(value, f)
    os.replace(tmp, os.path.join(d, key + ".pkl"))


def _load(storage: str, workflow_id: str, key: str):
    path = os.path.join(_wf_dir(storage, workflow_id), key + ".pkl")
    if not os.path.exists(path):
        return None, False
    with open(path, "rb") as f:
        return pickle.load(f), True


def run(dag: DAGNode, *, workflow_id: str, storage: str,
        args: Any = None) -> Any:
    """Execute a DAG durably; persists the graph + every step result.

    Re-running an existing workflow_id with DIFFERENT args starts fresh
    (old step results are invalidated — step keys don't encode args, so
    reusing them would silently return the previous run's answers)."""
    args_blob = pickle.dumps(args)
    prior, ok = _load(storage, workflow_id, "__graph__")
    if ok and prior.get("args") != args_blob:
        import shutil

        shutil.rmtree(_wf_dir(storage, workflow_id), ignore_errors=True)
    _store(storage, workflow_id, "__graph__",
           {"dag": pickle.dumps(_make_picklable(dag)),
            "args": args_blob})
    _store(storage, workflow_id, "__status__", "RUNNING")
    try:
        result = _execute(dag, workflow_id, storage, args)
    except BaseException:
        _store(storage, workflow_id, "__status__", "FAILED")
        raise
    _store(storage, workflow_id, "__status__", "SUCCEEDED")
    _store(storage, workflow_id, "__result__", result)
    return result


def resume(workflow_id: str, *, storage: str) -> Any:
    """Resume a workflow from storage: completed steps load from disk, the
    rest re-execute (reference: ``workflow_state_from_storage.py``)."""
    graph, ok = _load(storage, workflow_id, "__graph__")
    if not ok:
        raise ValueError(f"no workflow {workflow_id!r} in {storage}")
    result, done = _load(storage, workflow_id, "__result__")
    if done:
        return result
    dag = _restore_dag(pickle.loads(graph["dag"]))
    args = pickle.loads(graph["args"])
    _store(storage, workflow_id, "__status__", "RUNNING")
    try:
        result = _execute(dag, workflow_id, storage, args)
    except BaseException:
        _store(storage, workflow_id, "__status__", "FAILED")
        raise
    _store(storage, workflow_id, "__status__", "SUCCEEDED")
    _store(storage, workflow_id, "__result__", result)
    return result


def get_status(workflow_id: str, *, storage: str) -> Optional[str]:
    status, ok = _load(storage, workflow_id, "__status__")
    return status if ok else None


def _execute(dag: DAGNode, workflow_id: str, storage: str, args: Any) -> Any:
    """Walk the graph; each step's result is fetched (blocking) and
    persisted before dependents run — the durability contract: a step runs
    at most once per completed execution."""
    import time as _time

    cache: Dict[int, Any] = {}

    def run_node(node: DAGNode, path: str):
        if id(node) in cache:
            return cache[id(node)]
        if node.kind == "input":
            value = args
        elif node.kind == "output":
            value = [run_node(a, f"{path}.{i}")
                     for i, a in enumerate(node.args)]
        elif node.kind == "event":
            key = _step_key(node, path)
            value, done = _load(storage, workflow_id, key)
            if not done:
                listener, interval = node.args
                while True:
                    value = listener.poll()
                    if value is not None:
                        break
                    _time.sleep(interval)
                _store(storage, workflow_id, key, value)
        else:
            key = _step_key(node, path)
            value, done = _load(storage, workflow_id, key)
            if not done:
                call_args = [run_node(a, f"{path}.a{i}")
                             if isinstance(a, DAGNode) else a
                             for i, a in enumerate(node.args)]
                call_kwargs = {
                    k: (run_node(v, f"{path}.k{k}")
                        if isinstance(v, DAGNode) else v)
                    for k, v in node.kwargs.items()}
                value = ray_tpu_torch.get(node.fn.remote(*call_args,
                                                   **call_kwargs))
                # Dynamic workflow: the step returned a continuation —
                # execute the sub-graph in its place, durably, keyed
                # under this step (sub-steps resume independently; the
                # step's own file stores only the FINAL value, so an
                # interrupted sub-graph re-enters here and replays
                # finished sub-steps from storage).
                while isinstance(value, Continuation):
                    sub = _restore_dag(value.record)
                    value = run_node(sub, f"{path}.c[{key}]")
                _store(storage, workflow_id, key, value)
        cache[id(node)] = value
        return value

    return run_node(dag, "r")


# --------------------------------------------------- graph (de)serialization

def _make_picklable(node: DAGNode):
    """DAGNodes hold RemoteFunctions (picklable via cloudpickle of the
    underlying fn); rebuild records keep kind/fn/args/kwargs."""
    from ray_tpu_torch.core import serialization

    if not isinstance(node, DAGNode):
        return ("v", node)
    fn_blob = None
    if node.fn is not None:
        fn = getattr(node.fn, "_fn", node.fn)
        opts = getattr(node.fn, "_options", {})
        fn_blob = (serialization.dumps_function(fn), opts)
    return ("n", node.kind, fn_blob,
            tuple(_make_picklable(a) for a in node.args),
            {k: _make_picklable(v) for k, v in node.kwargs.items()})


def _restore_dag(record):
    from ray_tpu_torch.core import serialization

    if record[0] == "v":
        return record[1]
    _, kind, fn_blob, args, kwargs = record
    fn = None
    if fn_blob is not None:
        raw, opts = fn_blob
        raw_fn = serialization.loads_function(raw)
        fn = (ray_tpu_torch.remote(**opts)(raw_fn) if opts
              else ray_tpu_torch.remote(raw_fn))
    node = DAGNode(kind, fn,
                   tuple(_restore_dag(a) for a in args),
                   {k: _restore_dag(v) for k, v in kwargs.items()})
    return node
