"""Multi-node-in-one-machine cluster fixture (copy of
``ray_tpu/cluster_utils.py``).

Analogue of the reference's ``python/ray/cluster_utils.py:135`` ``Cluster`` —
the backbone of all distributed testing (SURVEY §4: "multiple raylets on one
machine emulate multi-node"). Each ``add_node`` starts a real node supervisor
(its own RPC server, worker pool and resource accounting) in this process;
workers are real subprocesses, so scheduling, spillback, object pulls and
node-death paths exercise the same code as a physical cluster.

A node that holds a card is one that ``add_node`` gives a ``GPU`` resource
(``add_node(resources={"GPU": 1}, labels={"gpu_name": ...})``): workers
leased there with a ``GPU`` lease are spawned with the card visible, CPU
workers keep it hidden. A ``Cluster`` detects no card itself (only
``init()`` does), so two such nodes on one machine share its one card.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ray_tpu_torch.core.controller import Controller
from ray_tpu_torch.core.node import Node


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict] = None,
                 controller_kwargs: Optional[Dict] = None):
        self._controller_kwargs = dict(controller_kwargs or {})
        self.controller = Controller(**self._controller_kwargs)
        self.nodes = []
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    def crash_controller(self) -> None:
        """Simulate a head crash: the control-plane process dies without a
        graceful final snapshot (its periodic persist loop may have saved).
        Raylets and workers stay up."""
        self.controller._stopped.set()
        self.controller._server.stop()
        self.controller._clients.close_all()
        # Drain the old persist loop before a replacement can share the
        # snapshot path: _save_lock is per-instance, so without this join
        # two controllers could interleave writes on the same .tmp file.
        persist = getattr(self.controller, "_persist_thread", None)
        if persist is not None:
            persist.join(timeout=10.0)

    def restart_controller(self) -> Controller:
        """Start a replacement controller on the SAME address (head
        fault-tolerance: raylets re-register via heartbeats; persisted
        state — KV, jobs, named actors, actor records — restores from the
        snapshot when ``persist_path`` was configured)."""
        kwargs = dict(self._controller_kwargs)
        host, port = self.controller.address
        kwargs.update(host=host, port=port)
        self.controller = Controller(**kwargs)
        return self.controller

    @property
    def address(self):
        return self.controller.address

    def add_node(self, num_cpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None) -> Node:
        node_resources = dict(resources or {})
        if num_cpus is not None:
            node_resources["CPU"] = float(num_cpus)
        node = Node(self.controller.address, node_resources, labels)
        self.nodes.append(node)
        return node

    def remove_node(self, node: Node) -> None:
        node.stop()
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        want = len(self.nodes)
        while time.monotonic() < deadline:
            alive = [n for n in self.controller.list_nodes() if n["alive"]]
            if len(alive) >= want:
                return
            time.sleep(0.05)
        raise TimeoutError(f"only {len(alive)}/{want} nodes alive")

    def shutdown(self) -> None:
        for node in self.nodes:
            try:
                node.stop()
            except Exception:  # graftlint: disable=swallowed-exception (best-effort fixture teardown)
                pass
        self.nodes.clear()
        self.controller.stop()


class WorkerKiller:
    """Chaos utility: randomly SIGKILLs worker processes while a workload
    runs (reference: ``_ray_start_chaos_cluster`` + ``WorkerKillerActor``,
    ``python/ray/_private/test_utils.py:1562``). Tasks must still complete
    through owner-side retries."""

    def __init__(self, nodes, period_s: float = 0.5, seed: int = 0):
        import random
        import threading

        self._nodes = list(nodes)
        self._period = period_s
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="worker-killer")
        self.kills = 0

    def start(self) -> "WorkerKiller":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            node = self._rng.choice(self._nodes)
            if node.kill_random_pooled_worker(self._rng):
                self.kills += 1

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
