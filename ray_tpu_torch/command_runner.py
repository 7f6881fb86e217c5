"""Command runners: execute bootstrap/setup commands on cluster nodes.

Analogue of the reference's ``command_runner.py`` (SSHCommandRunner,
DockerCommandRunner) and ``tpu_command_runner.py`` (fan the same command out
to every host of a TPU pod slice) used by the node updater
(``autoscaler/_private/updater.py``) during ``ray up``. The port's copy of
``ray_tpu/command_runner.py``: its pod runner is
:class:`HostGroupCommandRunner`, which fans out over every host of a GPU
node's host group.

Every runner supports ``dry_run``: the exact argv it would execute is
recorded on ``.history`` instead of spawned — this box has zero egress, so
the SSH paths are exercised in tests via dry-run (the reference tests its
command runners the same way: assert on the built command line).
"""

from __future__ import annotations

import shlex
import subprocess
from typing import Dict, List, Optional, Sequence


class CommandFailed(RuntimeError):
    def __init__(self, cmd: Sequence[str], rc: int, output: str):
        self.cmd = list(cmd)
        self.rc = rc
        self.output = output
        super().__init__(f"command {cmd!r} exited {rc}: {output[-500:]}")


class CommandRunner:
    """One target node. ``run`` executes a shell command; ``put`` ships a
    local file to the node."""

    def __init__(self, dry_run: bool = False):
        self.dry_run = dry_run
        self.history: List[List[str]] = []

    def _execute(self, argv: Sequence[str], timeout: float) -> str:
        self.history.append(list(argv))
        if self.dry_run:
            return ""
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise CommandFailed(argv, proc.returncode,
                                proc.stderr or proc.stdout)
        return proc.stdout

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        raise NotImplementedError

    def put(self, src: str, dst: str, timeout: float = 600.0) -> None:
        raise NotImplementedError


class SubprocessCommandRunner(CommandRunner):
    """Local execution (fake/local providers; also the head bootstrapping
    itself)."""

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        return self._execute(["bash", "-lc", cmd], timeout)

    def put(self, src: str, dst: str, timeout: float = 600.0) -> None:
        self._execute(["cp", src, dst], timeout)


class SSHCommandRunner(CommandRunner):
    """SSH to one host (reference: ``command_runner.py`` SSHCommandRunner —
    same knobs: user, key file, strict-host-key off for fresh VMs)."""

    def __init__(self, host: str, user: str = "ray",
                 key_file: Optional[str] = None, dry_run: bool = False,
                 ssh_options: Optional[List[str]] = None):
        super().__init__(dry_run)
        self.host = host
        self.user = user
        self.key_file = key_file
        self._options = list(ssh_options or [
            "-o", "StrictHostKeyChecking=no",
            "-o", "UserKnownHostsFile=/dev/null",
            "-o", "ConnectTimeout=10",
        ])

    def _base(self, prog: str) -> List[str]:
        argv = [prog] + self._options
        if self.key_file:
            argv += ["-i", self.key_file]
        return argv

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        # shlex.quote, not repr: commands routinely mix quote styles
        # (--resources '{"CPU": 4}') and repr's \' is NOT an escape inside
        # POSIX single quotes.
        argv = self._base("ssh") + [f"{self.user}@{self.host}",
                                    f"bash -lc {shlex.quote(cmd)}"]
        return self._execute(argv, timeout)

    def put(self, src: str, dst: str, timeout: float = 600.0) -> None:
        argv = self._base("scp") + [src, f"{self.user}@{self.host}:{dst}"]
        self._execute(argv, timeout)


class HostGroupCommandRunner(CommandRunner):
    """Fan a command out to every host of a GPU node's host group (the
    counterpart of the JAX package's ``TPUPodCommandRunner``; reference:
    ``tpu_command_runner.py`` — one node is N VMs; setup and ray-start must
    run on all of them). Hosts are the instances' internal addresses
    (``gpu_vm_api.GpuVmClient.instance_host``)."""

    def __init__(self, hosts: List[str], user: str = "ray",
                 key_file: Optional[str] = None, dry_run: bool = False):
        super().__init__(dry_run)
        self.workers = [SSHCommandRunner(h, user, key_file, dry_run)
                        for h in hosts]

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        outs = []
        for w in self.workers:
            outs.append(w.run(cmd, timeout))
            self.history.append(w.history[-1])
        return "\n".join(outs)

    def run_per_host(self, cmd_template: str,
                     env_per_host: List[Dict[str, str]],
                     timeout: float = 600.0) -> List[str]:
        """Run a templated command with per-host env (worker index, count —
        how ``start`` gets its rank on each host of the group)."""
        outs = []
        for w, env in zip(self.workers, env_per_host):
            exports = " ".join(f"{k}={v}" for k, v in env.items())
            cmd = f"{exports} {cmd_template}" if exports else cmd_template
            outs.append(w.run(cmd, timeout))
            self.history.append(w.history[-1])
        return outs

    def put(self, src: str, dst: str, timeout: float = 600.0) -> None:
        for w in self.workers:
            w.put(src, dst, timeout)
            self.history.append(w.history[-1])
