"""Job submission: run driver scripts ON the cluster (copy of
``ray_tpu/job_submission.py``).

Analogue of the reference's job subsystem
(``dashboard/modules/job/job_manager.py:56``; ``submit_job`` :422 spawns a
per-job ``JobSupervisor`` actor, ``job_supervisor.py:49``, which runs the
entrypoint as a subprocess on a cluster node, tracks its lifecycle in the
job table, and captures logs). Here the supervisor is a plain actor; job
state rides the controller's job table + pubsub channel, and logs land in
the controller KV — no dashboard process needed.

    client = JobSubmissionClient(cluster_address)
    job_id = client.submit_job(entrypoint="python train.py",
                               runtime_env={"working_dir": "./proj"})
    client.wait_until_finished(job_id)
    print(client.get_job_logs(job_id))
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import uuid
from typing import Any, Dict, Optional

import ray_tpu_torch


class JobSupervisor:
    """Per-job actor: runs the entrypoint subprocess on its node and
    reports status + logs (reference: job_supervisor.py:49)."""

    def __init__(self, job_id: str, entrypoint: str,
                 env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None):
        import threading

        self.job_id = job_id
        self.entrypoint = entrypoint
        self._status = "RUNNING"
        self._log_chunks = []
        self._returncode: Optional[int] = None
        env = dict(os.environ)
        env.update(env_vars or {})
        env["RAY_TPU_JOB_ID"] = job_id
        if working_dir:
            # kv:// packages materialize here (the supervisor may run on a
            # different host than the submitting driver).
            from ray_tpu_torch.core.runtime import get_core_worker
            from ray_tpu_torch.runtime_env import materialize_working_dir

            working_dir = materialize_working_dir(
                working_dir, get_core_worker().controller)
        self._proc = subprocess.Popen(
            entrypoint, shell=True, env=env, cwd=working_dir or None,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._pump = threading.Thread(target=self._pump_logs, daemon=True)
        self._pump.start()

    def _pump_logs(self) -> None:
        for line in self._proc.stdout:
            self._log_chunks.append(line)
        # graftlint: disable=unbounded-blocking-call (the pump lives exactly as long as the child: job entrypoints have no duration bound by design, stdout EOF above already means the process is exiting, and the thread is daemonized so shutdown never waits on it)
        self._returncode = self._proc.wait()
        self._status = ("SUCCEEDED" if self._returncode == 0 else "FAILED")
        self._publish_state()

    def _publish_state(self) -> None:
        from ray_tpu_torch.core.runtime import get_core_worker

        try:
            core = get_core_worker()
            core.controller.call("finish_job", self.job_id, self._status)
            core.controller.call(
                "kv_put", f"__job_logs__/{self.job_id}",
                "".join(self._log_chunks).encode())
        except Exception:
            import logging

            from ray_tpu_torch.util.ratelimit import log_every

            # The job still ran — but its terminal status/logs are now
            # invisible to `job status` callers. Never silent.
            log_every(f"job.publish.{self.job_id}", 10.0,
                      logging.getLogger(__name__),
                      "publishing state of job %s failed", self.job_id,
                      exc_info=True)

    def status(self) -> Dict[str, Any]:
        return {"job_id": self.job_id, "status": self._status,
                "returncode": self._returncode,
                "entrypoint": self.entrypoint}

    def logs(self) -> str:
        return "".join(self._log_chunks)

    def stop(self) -> bool:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._status = "STOPPED"
            self._publish_state()
        return True


class JobSubmissionClient:
    """Reference: ``ray.job_submission.JobSubmissionClient`` (REST replaced
    by the same actor RPC everything else uses)."""

    def __init__(self, address: Optional[Any] = None):
        if not ray_tpu_torch.is_initialized():
            if isinstance(address, str) and ":" in address:
                host, _, port = address.partition(":")
                address = (host, int(port))
            ray_tpu_torch.init(address=address)

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   submission_id: Optional[str] = None) -> str:
        from ray_tpu_torch.core.runtime import get_core_worker

        job_id = submission_id or f"job_{uuid.uuid4().hex[:10]}"
        runtime_env = runtime_env or {}
        working_dir = runtime_env.get("working_dir")
        core = get_core_worker()
        core.controller.call("register_job", job_id, {
            "entrypoint": entrypoint, "type": "submission"})
        supervisor_cls = ray_tpu_torch.remote(JobSupervisor)
        supervisor = supervisor_cls.options(
            name=f"_job_supervisor_{job_id}", num_cpus=0,
            runtime_env=(runtime_env if not working_dir else None),
        ).remote(job_id, entrypoint,
                 runtime_env.get("env_vars"), working_dir)
        ray_tpu_torch.get(supervisor.status.remote(), timeout=60.0)
        return job_id

    def _supervisor(self, job_id: str):
        return ray_tpu_torch.get_actor(f"_job_supervisor_{job_id}")

    def get_job_status(self, job_id: str) -> str:
        try:
            return ray_tpu_torch.get(self._supervisor(job_id).status.remote(),
                               timeout=30.0)["status"]
        except Exception:
            from ray_tpu_torch.core.runtime import get_core_worker

            jobs = get_core_worker().controller.call("list_jobs")
            if job_id in jobs:
                return jobs[job_id]["state"]
            raise

    def get_job_logs(self, job_id: str) -> str:
        try:
            return ray_tpu_torch.get(self._supervisor(job_id).logs.remote(),
                               timeout=30.0)
        except Exception:
            from ray_tpu_torch.core.runtime import get_core_worker

            blob = get_core_worker().controller.call(
                "kv_get", f"__job_logs__/{job_id}")
            return blob.decode() if blob else ""

    def stop_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._supervisor(job_id).stop.remote(),
                           timeout=30.0)

    def list_jobs(self) -> Dict[str, Dict[str, Any]]:
        from ray_tpu_torch.core.runtime import get_core_worker

        return get_core_worker().controller.call("list_jobs")

    def wait_until_finished(self, job_id: str,
                            timeout: float = 600.0) -> str:
        """Push-driven: long-polls the controller's job channel."""
        from ray_tpu_torch.core.runtime import get_core_worker

        core = get_core_worker()
        deadline = time.monotonic() + timeout
        version = 0
        terminal = ("SUCCEEDED", "FAILED", "STOPPED")
        status = self.get_job_status(job_id)
        while status not in terminal:
            step = min(10.0, deadline - time.monotonic())
            if step <= 0:
                raise TimeoutError(f"job {job_id} still {status}")
            update = core.controller.call("psub_poll", "jobs", job_id,
                                          version, step, timeout=step + 15.0)
            if update is None:
                status = self.get_job_status(job_id)
                continue
            version, info = update
            status = info.get("state", status)
        return status
