"""Observation connectors: composable env-to-module preprocessing.

Analogue of the reference's ConnectorV2 env-to-module pipelines
(``rllib/connectors/`` — per-runner transform chains between the env's
raw observations and the policy's inputs). A connector is a callable on
a BATCHED observation array ``(N, ...) -> (N, ...)``; the EnvRunner
applies the chain at reset and after every step, BEFORE both the policy
forward and rollout storage — so the learner trains on exactly what the
policy saw. Connectors are plain picklable objects (they ship to runner
actors inside the config); stateful ones (running normalization) keep
their state per runner, like the reference's per-EnvRunner connector
state.

TPU note: keep outputs static-shaped and float32/uint8 — the policy jit
recompiles on shape or dtype changes.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np


class Connector:
    def __call__(self, obs: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class FlattenObs(Connector):
    """(N, ...) -> (N, prod(...)): MLP policies over structured obs."""

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return np.asarray(obs).reshape(len(obs), -1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return np.clip(obs, self.low, self.high)


class ScaleObs(Connector):
    """Fixed affine transform ((obs - shift) * scale) — e.g. uint8 pixels
    to [0, 1] with shift=0, scale=1/255."""

    def __init__(self, shift: float = 0.0, scale: float = 1.0):
        self.shift, self.scale = shift, scale

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        return ((np.asarray(obs, np.float32) - self.shift)
                * self.scale).astype(np.float32)


class NormalizeObs(Connector):
    """Running mean/std normalization (Welford over batches), the
    MeanStdFilter of the reference's connector set. State is per runner
    and updated on every batch it sees."""

    def __init__(self, eps: float = 1e-8, clip: Optional[float] = 10.0):
        self.eps = eps
        self.clip = clip
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self.mean is None:
            self.mean = np.zeros(obs.shape[1:], np.float32)
            self.m2 = np.zeros(obs.shape[1:], np.float32)
        batch_n = float(len(obs))
        batch_mean = obs.mean(axis=0)
        batch_m2 = ((obs - batch_mean) ** 2).sum(axis=0)
        delta = batch_mean - self.mean
        total = self.count + batch_n
        self.mean = self.mean + delta * batch_n / total
        self.m2 = (self.m2 + batch_m2
                   + delta ** 2 * self.count * batch_n / total)
        self.count = total
        std = np.sqrt(self.m2 / max(1.0, self.count - 1)) + self.eps
        out = (obs - self.mean) / std
        if self.clip is not None:
            out = np.clip(out, -self.clip, self.clip)
        return out.astype(np.float32)


def apply_connectors(connectors: Optional[Sequence[Connector]],
                     obs: np.ndarray) -> np.ndarray:
    if not connectors:
        return obs
    for c in connectors:
        obs = c(obs)
    return obs


# ------------------------------------------------- module-to-env (actions)


class ActionConnector:
    """Module-to-env connector: transforms the POLICY's raw action batch
    ``(N, d)`` into what ``env.step`` expects (reference:
    ``rllib/connectors/module_to_env/`` — unsquash/clip/rescale live here
    so continuous-control support is structural, not per-policy hacks).
    Rollout storage keeps the POLICY actions; only the env sees the
    transformed ones."""

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class UnsquashAction(ActionConnector):
    """[-1, 1]^d (tanh-squashed policies) -> the env's Box bounds."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32).reshape(-1)
        self.high = np.asarray(high, np.float32).reshape(-1)
        if not (np.isfinite(self.low).all() and np.isfinite(self.high).all()):
            raise ValueError(
                f"UnsquashAction needs finite bounds, got {low} / {high}")

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        a = np.clip(np.asarray(actions, np.float32), -1.0, 1.0)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)


class ClipAction(ActionConnector):
    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32).reshape(-1)
        self.high = np.asarray(high, np.float32).reshape(-1)

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        return np.clip(np.asarray(actions, np.float32), self.low, self.high)


class RescaleAction(ActionConnector):
    """Affine map: action * scale + shift (e.g. torque unit changes)."""

    def __init__(self, scale: float = 1.0, shift: float = 0.0):
        self.scale, self.shift = scale, shift

    def __call__(self, actions: np.ndarray) -> np.ndarray:
        return np.asarray(actions, np.float32) * self.scale + self.shift


# ------------------------------------------------------ learner pipeline


class LearnerConnector:
    """Learner-side connector: transforms the assembled train batch (dict
    of arrays) before the update (reference: ``rllib/connectors/learner/``
    — e.g. whole-batch advantage normalization)."""

    def __call__(self, batch: dict) -> dict:
        raise NotImplementedError


class NormalizeAdvantages(LearnerConnector):
    """Zero-mean / unit-std advantages across the WHOLE train batch (the
    reference's GeneralAdvantageEstimation learner connector ends with
    exactly this normalization)."""

    def __init__(self, eps: float = 1e-8):
        self.eps = eps

    def __call__(self, batch: dict) -> dict:
        adv = batch.get("advantages")
        if adv is not None and len(adv):
            batch = dict(batch)
            batch["advantages"] = ((adv - adv.mean())
                                   / (adv.std() + self.eps)).astype(
                np.float32)
        return batch


def apply_learner_connectors(connectors, batch: dict) -> dict:
    for c in connectors or []:
        batch = c(batch)
    return batch


def validate_connectors(connectors: Iterable) -> List[Connector]:
    out = []
    for c in connectors:
        if not callable(c):
            raise ValueError(f"connector {c!r} is not callable")
        out.append(c)
    return out
