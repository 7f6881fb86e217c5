"""Algorithm checkpoint/restore + the RL-under-Tune bridge (port of
``ray_tpu/rl/checkpointing.py``).

* ``Checkpointable`` — a mixin every algorithm inherits. Subclasses
  declare their durable state as attribute names (``_CKPT_ATTRS`` for
  tensor trees / optimizer states / counters, ``_CKPT_KEY_ATTRS`` for
  ``torch.Generator``s, whose states are saved where the JAX package saves
  PRNG key data, ``_CKPT_BUFFER_ATTR`` for a replay buffer whose tail is
  persisted); ``save(path)``/``restore(path)`` move that state — plus
  per-runner connector statistics — through one pickle file of host
  trees (CPU tensors). ``restore`` puts every tensor of the state,
  optimizer state included, back on the algorithm's ``device``. A
  checkpoint written by the JAX package does not load here (it holds
  numpy trees and key data); ``restore`` refuses it.
* ``as_trainable(config)`` — adapts any AlgorithmConfig into a Tune
  function trainable over the port's ``train`` session.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

_STATE_FILE = "algorithm_state.pkl"
_FORMAT = "ray_tpu_torch"


class Checkpointable:
    """save()/restore() over declared state attributes."""

    # Attribute names whose values are trees of tensors (params,
    # optimizer states) or plain counters.
    _CKPT_ATTRS: tuple = ()
    # Attribute names holding torch.Generators (saved as their states).
    _CKPT_KEY_ATTRS: tuple = ()
    # Attribute name of a ReplayBuffer whose tail should persist.
    _CKPT_BUFFER_ATTR: Optional[str] = None
    # How many newest transitions of the buffer to keep (None = all).
    _CKPT_BUFFER_TAIL: Optional[int] = 20_000

    def _state(self) -> Dict[str, Any]:
        from ray_tpu_torch.rl.tree import host

        state: Dict[str, Any] = {
            name: host(getattr(self, name)) for name in self._CKPT_ATTRS}
        for name in self._CKPT_KEY_ATTRS:
            state[name] = getattr(self, name).get_state()
        if self._CKPT_BUFFER_ATTR:
            buf = getattr(self, self._CKPT_BUFFER_ATTR)
            if buf is not None:
                state["__replay__"] = buf.state_dict(self._CKPT_BUFFER_TAIL)
        return state

    def _load_state(self, state: Dict[str, Any]) -> None:
        from ray_tpu_torch.rl.tree import to_device

        for name in self._CKPT_ATTRS:
            setattr(self, name, to_device(state[name], self.device))
        for name in self._CKPT_KEY_ATTRS:
            getattr(self, name).set_state(state[name])
        if self._CKPT_BUFFER_ATTR and "__replay__" in state:
            buf = getattr(self, self._CKPT_BUFFER_ATTR)
            if buf is not None:
                buf.load_state_dict(state["__replay__"])

    # ------------------------------------------------------------- public

    def save(self, path: str) -> str:
        """Persist algorithm state (params, optimizer/target state, step
        counters, replay tail, per-runner connector statistics) into
        ``path`` (a directory). Atomic: readers never see a torn file."""
        os.makedirs(path, exist_ok=True)
        payload = {
            "algorithm": type(self).__name__,
            "format": _FORMAT,
            "state": self._state(),
            "connectors": self._collect_connector_state(),
        }
        target = os.path.join(path, _STATE_FILE)
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, target)
        return path

    def restore(self, path: str) -> None:
        """Load state saved by ``save`` onto the algorithm's device and
        rebroadcast weights (and connector statistics) to the live runner
        fleet."""
        with open(os.path.join(path, _STATE_FILE), "rb") as f:
            payload = pickle.load(f)
        if payload.get("format") != _FORMAT:
            raise ValueError(
                "checkpoint was not written by ray_tpu_torch (a ray_tpu "
                "checkpoint holds numpy trees and PRNG key data, which "
                "the port does not load)")
        if payload["algorithm"] != type(self).__name__:
            raise ValueError(
                f"checkpoint is for {payload['algorithm']}, not "
                f"{type(self).__name__}")
        self._load_state(payload["state"])
        self._push_connector_state(payload.get("connectors"))
        if hasattr(self, "_broadcast_weights"):
            self._broadcast_weights()
        elif hasattr(self, "_push_weights"):  # IMPALA/APPO async pipeline
            self._push_weights()

    # ------------------------------------------------- connector plumbing

    def _collect_connector_state(self):
        """Per-runner connector objects (running normalization statistics
        live inside them)."""
        import ray_tpu_torch

        runners = getattr(self, "runners", None)
        if not runners or not getattr(self.config, "obs_connectors", None):
            return None
        try:
            return ray_tpu_torch.get(
                [r.get_connectors.remote() for r in runners], timeout=30)
        except Exception:
            return None

    def _push_connector_state(self, per_runner) -> None:
        import ray_tpu_torch

        runners = getattr(self, "runners", None)
        if not per_runner or not runners:
            return
        try:
            ray_tpu_torch.get([
                r.set_connectors.remote(per_runner[i % len(per_runner)])
                for i, r in enumerate(runners)], timeout=30)
        except Exception:  # graftlint: disable=swallowed-exception (connector-state push is best-effort; next sync rebuilds it)
            pass


def as_trainable(base_config, stop_iters: int = 10,
                 checkpoint_every: int = 0):
    """Adapt an AlgorithmConfig into a Tune function trainable.

    The returned function builds ``base_config`` with the trial's sampled
    keys applied, resumes from the session checkpoint when one exists
    (PBT exploit / trial restart), trains ``stop_iters`` iterations
    reporting metrics each time, and saves an algorithm checkpoint every
    ``checkpoint_every`` iterations (0 = never)."""
    import copy

    def trainable(tune_cfg):
        from ray_tpu_torch import train

        cfg = copy.deepcopy(base_config)
        for k, v in (tune_cfg or {}).items():
            setattr(cfg, k, v)
        algo = cfg.build()
        try:
            ckpt = train.get_checkpoint()
            if ckpt is not None:
                algo.restore(ckpt.path)
            start = getattr(algo, "_iteration", 0)
            for i in range(start, stop_iters):
                metrics = algo.train()
                if checkpoint_every and ((i + 1) % checkpoint_every == 0
                                         or (i + 1) == stop_iters):
                    d = train.temp_checkpoint_dir()
                    algo.save(d)
                    train.report(
                        metrics,
                        checkpoint=train.Checkpoint.from_directory(d))
                else:
                    train.report(metrics)
        finally:
            algo.stop()

    return trainable
