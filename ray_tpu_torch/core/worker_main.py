"""Worker process entrypoint.

Analogue of the reference's ``python/ray/_private/workers/default_worker.py``:
forked by the node supervisor, embeds a CoreWorker, registers its RPC address
back with the node, and then serves pushed tasks until told to shut down or
its node disappears (orphan protection — the reference's workers die with
their raylet too).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def run(node_addr, controller_addr, node_id_hex: str,
        worker_id_hex: str) -> int:
    """Embed a CoreWorker and serve until shutdown. Shared by the spawned
    entrypoint below and by forkserver children (``core/forkserver.py``),
    which skip interpreter+import startup entirely."""
    from ray_tpu_torch.core.ids import NodeID, WorkerID
    from ray_tpu_torch.core.rpc import RpcClient, RpcError
    from ray_tpu_torch.core.runtime import CoreWorker, set_core_worker
    core = CoreWorker(
        mode="worker",
        controller_addr=controller_addr,
        node_addr=node_addr,
        node_id=NodeID.from_hex(node_id_hex),
        worker_id=WorkerID.from_hex(worker_id_hex),
    )
    set_core_worker(core)

    node_client = RpcClient(node_addr)
    reply = node_client.call("register_worker", core.worker_id.binary(),
                             core.addr, os.getpid())
    if "error" in reply:
        print(f"worker registration failed: {reply}", file=sys.stderr)
        return 1

    # Serve until shutdown; exit if the node supervisor disappears OR has
    # forgotten us (orphan protection both ways — a worker missing from the
    # node's table can never be reaped, so it must exit itself).
    # "Disappeared" requires CONSECUTIVE misses: a single slow ping under
    # load (e.g. a 1000-actor storm starving the node's reader threads)
    # must not make healthy workers mass-suicide — that cascaded into
    # dead actors at envelope scale. known=False stays authoritative.
    # The node suggests the cadence (fleet-size adaptive, ~50 pings/s
    # aggregate); jitter spreads the fleet so intervals don't phase-lock
    # into synchronized bursts.
    import random as _random

    misses = 0
    interval = 2.0
    transient = False
    while not core._shutdown.is_set():
        time.sleep(interval * (0.75 + 0.5 * _random.random()))
        try:
            # Long intervals (big fleets) use a transient connection per
            # ping: a persistent socket per worker means a reader THREAD
            # per worker inside the node supervisor — at 5,000 actors
            # that alone exhausts the node's thread/mmap budget.
            if transient:
                client = RpcClient(node_addr)
            else:
                client = node_client
            try:
                reply = client.call(
                    "worker_ping", core.worker_id.binary(),
                    core.tasks_received, core.active_tasks,
                    core._actor_runtime is not None,
                    timeout=max(10.0, interval))
            finally:
                if transient:
                    client.close()
            if not reply.get("known", True):
                break
            interval = float(reply.get("interval", 2.0))
            go_transient = interval > 10.0
            if go_transient and not transient:
                node_client.close()  # free the node-side reader thread
            elif transient and not go_transient:
                # Fleet shrank back: re-dial the persistent connection
                # (the old one was closed when we went transient).
                node_client = RpcClient(node_addr)
            transient = go_transient
            misses = 0
        except (RpcError, TimeoutError):
            misses += 1
            if misses >= 5:
                break
    core.shutdown()
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--node-host", required=True)
    parser.add_argument("--node-port", type=int, required=True)
    parser.add_argument("--controller-host", required=True)
    parser.add_argument("--controller-port", type=int, required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--worker-id", required=True)
    args = parser.parse_args()
    return run((args.node_host, args.node_port),
               (args.controller_host, args.controller_port),
               args.node_id, args.worker_id)


if __name__ == "__main__":
    sys.exit(main())
