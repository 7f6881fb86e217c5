"""Lazy DAGs + compiled execution (the pipeline-parallel substrate; copy
of ``ray_tpu/dag.py``).

Analogue of the reference's ``ray.dag`` (``dag/dag_node.py`` ``.bind()``
graphs) and compiled graphs (``dag/compiled_dag_node.py:389`` — pre-bound
actor loops + typed channels so repeated execution has no per-call
task-submission overhead; the declared substrate for pipeline parallelism,
SURVEY §2.4 PP row).

As in the JAX package, what the DAG layer owns is the HOST pipeline:
stage actors connected by direct actor-to-actor pushes (no driver
round-trip per hop — each stage calls the next stage's ``_pipe_push``
itself), with a bounded number of in-flight items for backpressure. That
gives classic 1F1B-style microbatch pipelining when each stage hosts one
model partition. A CUDA tensor crosses an edge through the host: the
serializer stages it to a CPU copy (``core/serialization.py``), and the
next stage reads it back as a CPU view of the channel slot or the pushed
frame, which its function moves to its card.

Surface:

    with InputNode() as inp:
        dag = stage_b.bind(stage_a.bind(inp))
    dag.execute(x)                  # interpreted: one task per node
    cdag = dag.experimental_compile(max_in_flight=8)
    futs = [cdag.execute(x) for x in batches]   # pipelined
    [f.result() for f in futs]
"""

from __future__ import annotations

import sys
import threading
import uuid
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.remote_function import RemoteFunction


class DAGNode:
    """One node of a lazy ``.bind()`` graph."""

    def __init__(self, kind: str, fn=None, args: tuple = (),
                 kwargs: Optional[dict] = None):
        self.kind = kind  # "input" | "task" | "actor_method" | "output"
        self.fn = fn
        self.args = args
        self.kwargs = kwargs or {}

    # ---------------------------------------------------- interpreted path

    def execute(self, *input_values):
        """Interpreted execution: walk the graph, submit one task per node
        (reference: DAGNode.execute before compilation)."""
        cache: Dict[int, Any] = {}

        def run(node: "DAGNode"):
            if id(node) in cache:
                return cache[id(node)]
            if node.kind == "input":
                value = input_values[0] if input_values else None
            elif node.kind == "output":
                value = [run(a) for a in node.args]
            else:
                args = [run(a) if isinstance(a, DAGNode) else a
                        for a in node.args]
                kwargs = {k: run(v) if isinstance(v, DAGNode) else v
                          for k, v in node.kwargs.items()}
                value = node.fn.remote(*args, **kwargs)
            cache[id(node)] = value
            return value

        return run(self)

    # ------------------------------------------------------ compiled path

    def experimental_compile(self, max_in_flight: int = 8) -> "CompiledDAG":
        return CompiledDAG(self, max_in_flight)

    def _linear_chain(self) -> List["DAGNode"]:
        """Flatten to a linear stage chain (v1 compiled topology: each node
        has exactly one DAGNode dependency; the reference's general graphs
        reduce to this for pipeline parallelism)."""
        chain: List[DAGNode] = []
        node: Optional[DAGNode] = self
        while node is not None and node.kind != "input":
            if node.kind == "output":
                if len(node.args) != 1:
                    raise ValueError(
                        "compiled DAGs currently support linear pipelines "
                        "(single output)")
                node = node.args[0]
                continue
            chain.append(node)
            deps = [a for a in list(node.args) + list(node.kwargs.values())
                    if isinstance(a, DAGNode)]
            if len(deps) > 1:
                raise ValueError(
                    "compiled DAGs currently support linear pipelines "
                    f"(node has {len(deps)} upstream nodes)")
            node = deps[0] if deps else None
        chain.reverse()
        return chain


class InputNode(DAGNode):
    def __init__(self):
        super().__init__("input")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class MultiOutputNode(DAGNode):
    def __init__(self, nodes: List[DAGNode]):
        super().__init__("output", args=tuple(nodes))


def _bind_function(remote_fn: RemoteFunction, *args, **kwargs) -> DAGNode:
    return DAGNode("task", remote_fn, args, kwargs)


class _PipeError:
    """A stage failure traveling the pipeline as data: downstream stages
    pass it through untouched and the driver resolves the item's Future
    with the error (without this, one raising item would wedge the
    channel protocol — the ack must happen no matter what the user fn
    did)."""

    def __init__(self, desc: str):
        self.desc = desc


def _settle_device() -> None:
    """Wait for every stream of this process's current card, when the
    process has touched one: the copies a stage function queued out of a
    channel slot have then read it. A process that never loaded torch or
    never made a CUDA context has nothing to wait for."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _PipeStage:
    """Actor hosting one compiled pipeline stage: executes its function and
    hands the result to the next stage with NO driver hop — through a
    mutable shared-memory channel when the stages share a host (reference:
    ``shared_memory_channel.py:169`` — allocation-free slot rewrite per
    item), falling back to a direct actor push (RPC) for cross-node edges
    and payloads larger than the slot. The last stage queues results for
    the driver."""

    def __init__(self, fn_blob: bytes, const_args: tuple,
                 const_kwargs: dict, arg_template: List[Any]):
        from ray_tpu_torch.core import serialization

        self._fn = serialization.loads_function(fn_blob)
        self._const_args = const_args
        self._const_kwargs = const_kwargs
        self._arg_template = arg_template  # positions: "__dag__" = dataflow
        self._next = None
        self._out_chan = None
        self._in_chan = None
        self._drain = None
        self._stop = threading.Event()
        import queue as q

        self._in_q: "q.Queue" = q.Queue()  # RPC-fallback inbox (channeled)
        self._out: "q.Queue" = q.Queue()

    def set_next(self, next_handle) -> bool:
        self._next = next_handle
        return True

    def node_hex(self) -> str:
        from ray_tpu_torch.core.runtime import get_core_worker

        return get_core_worker().node_id.hex()

    # ------------------------------------------------------------ channels

    def listen_channel(self, path: str, capacity: int,
                       nslots: Optional[int] = None) -> bool:
        """Reader side: create the edge's channel and consume items on a
        drain thread (one consumer — channel items and RPC-fallback pushes
        are serialized through it, so the stage fn never runs twice
        concurrently). ``nslots`` comes from the DRIVER's config so one
        process controls the ring depth of the whole pipeline."""
        from ray_tpu_torch.core.channel import MutableChannel

        self._in_chan = MutableChannel(path, create=True, capacity=capacity,
                                       nslots=nslots)
        self._drain = threading.Thread(target=self._drain_loop,
                                       name="pipe-drain", daemon=True)
        self._drain.start()
        return True

    def attach_out_channel(self, path: str) -> bool:
        """Writer side: open the downstream edge's channel (reader created
        it first)."""
        from ray_tpu_torch.core.channel import MutableChannel

        self._out_chan = MutableChannel(path)
        return True

    def _drain_loop(self) -> None:
        import queue as q

        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.core.channel import ChannelClosed, ChannelTimeout

        while not self._stop.is_set():
            view = None
            try:
                view = self._in_chan.read(timeout=0.05)
            except ChannelTimeout:
                pass
            except (ChannelClosed, ValueError):
                return  # torn down (ValueError: mmap closed mid-read)
            if view is not None:
                # Zero-copy deserialize is safe only when the result is
                # re-serialized synchronously before ack (out-channel
                # write); terminal stages queue the result past the ack,
                # so they take one defensive copy. The ack ALWAYS happens
                # — errors travel the pipeline as _PipeError items.
                #
                # Order on a card: a tensor read from the slot is a CPU
                # view of it, and the stage function may hand that view
                # to a copy onto its card that the card's stream has not
                # run yet (``non_blocking=True``). ``_process`` therefore
                # waits for the card (``_settle_device``) after the
                # function returns and before this ack, so the writer
                # never refills a slot the card is still reading.
                try:
                    zero_copy = self._out_chan is not None
                    frame = view if zero_copy else bytes(view)
                    seq, value = serialization.deserialize(frame)
                    self._process(seq, value, from_slot=zero_copy)
                finally:
                    try:
                        self._in_chan.ack()
                    except (ChannelClosed, ValueError):
                        return
                continue
            try:
                seq, value = self._in_q.get_nowait()
            except q.Empty:
                continue
            self._process(seq, value, from_slot=False)

    def _invoke(self, value):
        args = [value if a == "__dag__" else a for a in self._const_args]
        kwargs = {k: (value if v == "__dag__" else v)
                  for k, v in self._const_kwargs.items()}
        return self._fn(*args, **kwargs)

    def _process(self, seq: int, value, from_slot: bool = False) -> None:
        import traceback

        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.core.channel import ChannelClosed

        if isinstance(value, _PipeError):
            result = value  # failed upstream: pass the error through
        else:
            try:
                result = self._invoke(value)
                if from_slot:
                    _settle_device()
            except BaseException:  # noqa: BLE001 — must reach the driver
                result = _PipeError(traceback.format_exc())
        if self._out_chan is not None:
            # One build_frame serves both outcomes: written into the slot
            # when it fits, or materialized as the detached copy for the
            # RPC fallback (the async push serializes after this frame's
            # ack, so nothing may alias the input slot).
            total, write_fn = serialization.build_frame((seq, result))
            if total <= self._out_chan.capacity:
                try:
                    # Full slot = backpressure from a slow consumer, not
                    # a failure: wait without a deadline (close() breaks
                    # the wait at teardown).
                    self._out_chan.write_frame(total, write_fn,
                                               timeout=None)
                    return
                except ChannelClosed:
                    return  # tearing down; drop the item
            if from_slot:
                buf = bytearray(total)
                write_fn(buf)
                seq, result = serialization.deserialize(buf)
        if self._next is not None:
            self._next.push.remote(seq, result)
        else:
            self._out.put((seq, result))

    def push(self, seq: int, value) -> None:
        if self._drain is not None:
            # Channeled stage: route through the single consumer so the
            # stage fn stays serialized.
            self._in_q.put((seq, value))
            return
        self._process(seq, value)

    def pop(self, timeout: float = 60.0):
        import queue as q

        try:
            return self._out.get(timeout=timeout)
        except q.Empty:
            return None

    def close_channels(self) -> None:
        self._stop.set()
        for chan in (self._in_chan, self._out_chan):
            if chan is not None:
                chan.close()
        if self._in_chan is not None:
            # The reader CREATED the file on ITS host — unlink here, not
            # on the driver (which may be a different machine).
            self._in_chan.unlink()

    def ping(self) -> str:
        return "pong"


class CompiledDAG:
    """Pre-instantiated stage actors + direct dataflow; ``execute`` returns
    a Future resolved by a background collector (reference:
    ``CompiledDAG._execute_until``, ``compiled_dag_node.py:1233``)."""

    def __init__(self, dag: DAGNode, max_in_flight: int = 8):
        from ray_tpu_torch.core import serialization

        chain = dag._linear_chain()
        if not chain:
            raise ValueError("empty DAG")
        stage_cls = ray_tpu_torch.remote(_PipeStage)
        self._stages = []
        for idx, node in enumerate(chain):
            if node.kind != "task":
                raise ValueError(
                    "compiled DAGs currently support function stages "
                    "(bind actor methods via a wrapper function)")
            args = tuple("__dag__" if isinstance(a, DAGNode) else a
                         for a in node.args)
            kwargs = {k: ("__dag__" if isinstance(v, DAGNode) else v)
                      for k, v in node.kwargs.items()}
            if not any(a == "__dag__" for a in args) and \
                    "__dag__" not in kwargs.values():
                args = ("__dag__",) + args  # stage with no explicit input
            options = dict(node.fn._options) if hasattr(node.fn, "_options") \
                else {}
            # Intermediate stages are single-threaded (ordered dataflow);
            # the LAST stage needs one extra slot so the driver's blocking
            # ``pop`` long-poll can't starve incoming pushes.
            options.setdefault("max_concurrency",
                               2 if idx == len(chain) - 1 else 1)
            options["num_cpus"] = options.get("num_cpus", 1)
            blob = serialization.dumps_function(node.fn._fn
                                                if hasattr(node.fn, "_fn")
                                                else node.fn)
            self._stages.append(stage_cls.options(**options).remote(
                blob, args, kwargs, []))
        # Wire stage i -> i+1 (direct pushes — the universal fallback).
        wires = [self._stages[i].set_next.remote(self._stages[i + 1])
                 for i in range(len(self._stages) - 1)]
        ray_tpu_torch.get(wires + [self._stages[-1].ping.remote()],
                          timeout=120.0)
        # Upgrade same-host edges to mutable shm channels (reader creates,
        # then the writer attaches; cross-node edges keep the RPC path).
        self._channel_paths: List[str] = []
        from ray_tpu_torch.core.config import config

        if config.dag_channels_enabled and len(self._stages) > 1:
            import uuid as _uuid

            from ray_tpu_torch.core.channel import channel_path

            nodes = ray_tpu_torch.get(
                [s.node_hex.remote() for s in self._stages], timeout=60.0)
            run_id = _uuid.uuid4().hex[:12]
            for i in range(len(self._stages) - 1):
                if nodes[i] != nodes[i + 1]:
                    continue
                path = channel_path(f"{run_id}-e{i}")
                ray_tpu_torch.get(
                    self._stages[i + 1].listen_channel.remote(
                        path, config.dag_channel_capacity_bytes,
                        config.dag_channel_slots), timeout=60.0)
                ray_tpu_torch.get(
                    self._stages[i].attach_out_channel.remote(path),
                    timeout=60.0)
                self._channel_paths.append(path)

        self._seq = 0
        self._lock = threading.Lock()
        self._futures: Dict[int, Future] = {}
        self._in_flight = threading.Semaphore(max_in_flight)
        self._stop = threading.Event()
        self._collector = threading.Thread(target=self._collect,
                                           name="cdag-collect", daemon=True)
        self._collector.start()

    def execute(self, value) -> Future:
        self._in_flight.acquire()
        with self._lock:
            seq = self._seq
            self._seq += 1
            fut: Future = Future()
            self._futures[seq] = fut
        self._stages[0].push.remote(seq, value)
        return fut

    def _collect(self) -> None:
        while not self._stop.is_set():
            try:
                item = ray_tpu_torch.get(self._stages[-1].pop.remote(10.0),
                                   timeout=30.0)
            except Exception:
                if self._stop.wait(0.5):
                    return
                continue
            if item is None:
                continue
            seq, result = item
            with self._lock:
                fut = self._futures.pop(seq, None)
            self._in_flight.release()
            if fut is not None:
                if isinstance(result, _PipeError):
                    fut.set_exception(ray_tpu_torch.RayTpuError(
                        f"pipeline stage failed:\n{result.desc}"))
                else:
                    fut.set_result(result)

    def teardown(self) -> None:
        self._stop.set()
        close_refs = []
        for stage in self._stages:
            try:
                close_refs.append(stage.close_channels.remote())
            except Exception:  # graftlint: disable=swallowed-exception (best-effort channel close at teardown; kill below is the backstop)
                pass
        # Await the closes (bounded): a kill landing first would skip the
        # reader-side unlink and leak slot files on the stages' hosts.
        try:
            ray_tpu_torch.wait(close_refs, num_returns=len(close_refs),
                         timeout=10.0)
        except Exception:  # graftlint: disable=swallowed-exception (bounded wait at teardown; kill below is the backstop)
            pass
        for stage in self._stages:
            try:
                ray_tpu_torch.kill(stage)
            except Exception:  # graftlint: disable=swallowed-exception (best-effort stage kill at teardown)
                pass
        import os as _os

        for path in getattr(self, "_channel_paths", []):
            try:
                _os.unlink(path)
            except OSError:
                pass


# Patch .bind onto RemoteFunction (the reference exposes .bind on every
# @ray.remote function/actor method).
def _rf_bind(self, *args, **kwargs) -> DAGNode:
    return _bind_function(self, *args, **kwargs)


RemoteFunction.bind = _rf_bind
