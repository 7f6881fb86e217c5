"""Instance lifecycle manager: cloud-instance states reconciled against
desired state.

Analogue of the reference's autoscaler-v2 instance manager
(``autoscaler/v2/instance_manager/`` — per-instance lifecycle records
REQUESTED -> ALLOCATED -> RAY_RUNNING -> TERMINATING reconciled each tick)
plus the v1 updater's retry/backoff node-setup state machine
(``autoscaler/_private/updater.py``). The planner (StandardAutoscaler)
decides HOW MANY nodes to add or remove; this layer owns HOW each one
gets there:

* ``REQUESTED``: allocation attempted against the provider with
  exponential backoff; repeated failure drops the request (and the
  planner re-requests if demand persists).
* ``ALLOCATED``: optional provider ``setup_node`` bootstrap (the SSH/
  startup-script phase on cloud VMs) runs on a background thread with
  bounded retries + backoff; exhausting them terminates and REPLACES the
  instance.
* ``SETTING_UP``/``ALLOCATED``: instances that never register with the
  cluster controller within ``register_timeout_s`` are torn down and
  replaced — a wedged VM must not hold a slot forever.
* ``RUNNING``: provider id seen in cluster membership.

Every transition lands in ``events()`` (bounded ring) for operator
postmortems — the reference keeps the same per-instance history.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
SETTING_UP = "SETTING_UP"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
FAILED = "FAILED"


class Instance:
    def __init__(self, iid: int, resources: Dict[str, float],
                 labels: Dict[str, str]):
        self.iid = iid
        self.resources = dict(resources)
        self.labels = dict(labels)
        self.state = REQUESTED
        self.provider_id: Optional[str] = None
        self.attempts = 0            # allocation OR setup attempts
        self.next_attempt_ts = 0.0   # backoff gate
        self.born_ts = time.monotonic()
        self.allocated_ts = 0.0
        self.error: Optional[str] = None


class InstanceManager:
    def __init__(self, provider, max_attempts: int = 3,
                 backoff_base_s: float = 2.0,
                 backoff_max_s: float = 60.0,
                 register_timeout_s: float = 600.0):
        self._provider = provider
        self._max_attempts = max_attempts
        self._backoff_base_s = backoff_base_s
        self._backoff_max_s = backoff_max_s
        self._register_timeout_s = register_timeout_s
        self._instances: Dict[int, Instance] = {}
        self._next_iid = 0
        # Reentrant: state transitions append events while holding it.
        self._lock = threading.RLock()
        self._events: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- intake

    def request_node(self, resources: Dict[str, float],
                     labels: Dict[str, str]) -> int:
        with self._lock:
            self._next_iid += 1
            inst = Instance(self._next_iid, resources, labels)
            self._instances[inst.iid] = inst
            self._event(inst, "requested")
            return inst.iid

    def terminate(self, provider_id: str) -> None:
        with self._lock:
            inst = next((i for i in self._instances.values()
                         if i.provider_id == provider_id
                         and i.state not in (TERMINATED, FAILED)), None)
            # Under the lock: the setup-failure thread checks state before
            # acting, so marking TERMINATED here prevents it from
            # replacing a node the planner just removed.
            self._terminate_instance(inst, "planner scale-down")
        if inst is None:
            # Foreign instance (pre-manager or manual): still honor it.
            try:
                self._provider.terminate_node(provider_id)
            except Exception:
                # A failed terminate is a VM that keeps BILLING — the
                # reconcile loop retries, but leave the trail.
                log_every("instance.terminate", 30.0, logger,
                          "terminate of foreign instance %s failed",
                          provider_id, exc_info=True)

    # -------------------------------------------------------- reconcile

    def reconcile(self, registered_provider_ids: set) -> None:
        """One pass of the lifecycle state machine. ``registered_provider_
        ids``: provider ids of nodes the cluster controller sees alive."""
        now = time.monotonic()
        # One provider snapshot per pass, taken OUTSIDE the lock (a cloud
        # list call must not stall setup threads' transitions).
        try:
            live_provider_ids = set(self._provider.non_terminated_nodes())
        except Exception:
            live_provider_ids = set()
        with self._lock:
            instances = list(self._instances.values())
            # Prune terminal records past a bounded history (the reference
            # IM garbage-collects them too): a long-lived cluster must not
            # pay per-ever-launched-node reconcile cost forever.
            terminal = [i for i in instances
                        if i.state in (TERMINATED, FAILED)]
            for inst in terminal[:-50]:
                self._instances.pop(inst.iid, None)
        for inst in instances:
            # All transitions happen under the lock and re-check state:
            # the setup thread's failure path races this loop's
            # register-timeout path, and a TERMINATED record must stay
            # terminated (no double replacement, no resurrection).
            with self._lock:
                if inst.state == REQUESTED and now >= inst.next_attempt_ts:
                    self._try_allocate(inst, now)
                elif inst.state in (ALLOCATED, SETTING_UP):
                    if inst.provider_id in registered_provider_ids:
                        inst.state = RUNNING
                        self._event(inst, "running")
                    elif now - inst.allocated_ts > self._register_timeout_s:
                        # Wedged VM: never registered. Tear down + replace.
                        self._event(inst, "register-timeout; replacing")
                        self._terminate_instance(inst, "register timeout")
                        self.request_node(inst.resources, inst.labels)
                    elif (inst.state == ALLOCATED
                            and now >= inst.next_attempt_ts):
                        self._try_setup(inst, now)
                elif inst.state == RUNNING:
                    if (inst.provider_id not in registered_provider_ids
                            and inst.provider_id not in live_provider_ids):
                        inst.state = TERMINATED  # died/externally removed
                        self._event(inst, "gone")

    def _try_allocate(self, inst: Instance, now: float) -> None:
        inst.attempts += 1
        try:
            inst.provider_id = self._provider.create_node(
                inst.resources, dict(inst.labels))
            inst.state = ALLOCATED
            inst.allocated_ts = now
            inst.attempts = 0  # setup gets its own attempt budget
            inst.next_attempt_ts = 0.0
            self._event(inst, "allocated")
        except Exception as e:  # noqa: BLE001 — cloud errors are data here
            inst.error = str(e)
            if inst.attempts >= self._max_attempts:
                inst.state = FAILED
                self._event(inst, f"allocation failed permanently: {e}")
            else:
                inst.next_attempt_ts = now + self._backoff(inst.attempts)
                self._event(inst, f"allocation retry {inst.attempts}: {e}")

    def _try_setup(self, inst: Instance, now: float) -> None:
        setup: Optional[Callable] = getattr(self._provider, "setup_node",
                                            None)
        if setup is None:
            inst.state = SETTING_UP  # nothing to run; wait for register
            return
        inst.state = SETTING_UP

        def run() -> None:
            try:
                setup(inst.provider_id)
                self._event(inst, "setup ok; awaiting register")
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    if inst.state != SETTING_UP:
                        # The reconcile loop already moved on (register
                        # timeout replaced us, or we registered anyway):
                        # acting here would resurrect a terminated record
                        # or double-replace.
                        return
                    inst.attempts += 1
                    inst.error = str(e)
                    if inst.attempts >= self._max_attempts:
                        self._event(inst, f"setup failed permanently: "
                                          f"{e}; replacing")
                        self._terminate_instance(inst, "setup failed")
                        self.request_node(inst.resources, inst.labels)
                    else:
                        inst.state = ALLOCATED  # retried next reconcile
                        inst.next_attempt_ts = (
                            time.monotonic()
                            + self._backoff(inst.attempts))
                        self._event(inst, f"setup retry {inst.attempts}: "
                                          f"{e}")

        threading.Thread(target=run, name=f"node-setup-{inst.iid}",
                         daemon=True).start()

    # ---------------------------------------------------------- plumbing

    def _terminate_instance(self, inst: Optional[Instance],
                            why: str) -> None:
        if inst is None:
            return
        if inst.provider_id is not None:
            try:
                self._provider.terminate_node(inst.provider_id)
            except Exception:
                log_every("instance.terminate", 30.0, logger,
                          "terminate of instance %s failed",
                          inst.provider_id, exc_info=True)
        inst.state = TERMINATED
        self._event(inst, f"terminated: {why}")

    def _backoff(self, attempt: int) -> float:
        return min(self._backoff_max_s,
                   self._backoff_base_s * (2 ** (attempt - 1)))

    def _event(self, inst: Instance, what: str) -> None:
        with self._lock:
            self._events.append({"iid": inst.iid, "state": inst.state,
                                 "provider_id": inst.provider_id,
                                 "what": what, "ts": time.time()})
            del self._events[:-500]

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def summary(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for inst in self._instances.values():
                out[inst.state] = out.get(inst.state, 0) + 1
            return out

    def pending_count(self) -> int:
        """Instances on their way up (count as capacity for the planner)."""
        with self._lock:
            return sum(1 for i in self._instances.values()
                       if i.state in (REQUESTED, ALLOCATED, SETTING_UP))

    def requested_count(self) -> int:
        """Requests not yet visible in the provider's node list."""
        with self._lock:
            return sum(1 for i in self._instances.values()
                       if i.state == REQUESTED)
