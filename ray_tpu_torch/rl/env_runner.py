"""EnvRunner actors: vectorized environment rollout collection (port of
``ray_tpu/rl/env_runner.py``).

Analogue of the reference's ``SingleAgentEnvRunner``: an actor stepping a
gymnasium vector env with the current policy, returning fixed-length
rollout batches plus episode stats. Env runners are CPU workers: the
policy runs on the CPU with the runner's own copy of the weights (which
arrive as a tree of CPU tensors through the object store), its draws from
a ``torch.Generator`` seeded with ``seed``, on one torch thread (batch-4
forwards gain nothing from more, and the learner shares the host).

Correctness detail that matters on gymnasium >= 1.0: vector envs autoreset
on the step AFTER an episode ends (``AutoresetMode.NEXT_STEP``) — that step
ignores the action and returns the reset observation with reward 0. Those
transitions are NOT real experience; each rollout carries a ``valids`` mask
so GAE/V-trace treat them as boundaries and the learner drops them."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def _make_vec_env(env_name: str, num_envs: int, env_config: Dict):
    import gymnasium as gym

    if env_name.startswith("ray_tpu/"):
        from ray_tpu_torch.rl import testing  # noqa: F401 (registers the ids)
    return gym.make_vec(env_name, num_envs=num_envs, **env_config)


class EnvRunner:
    def __init__(self, env_name: str, num_envs: int = 4,
                 rollout_length: int = 128, seed: int = 0,
                 env_config: Optional[Dict] = None,
                 frame_stack: int = 1,
                 policy_mode: str = "categorical",
                 obs_connectors: Optional[list] = None,
                 action_connectors: Optional[list] = None):
        import torch

        from ray_tpu_torch.rl.connectors import apply_connectors

        torch.set_num_threads(1)
        self.envs = _make_vec_env(env_name, num_envs, env_config or {})
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.frame_stack = frame_stack
        # Env-to-module preprocessing chain: applied to every observation
        # BEFORE storage and the policy forward — and before frame
        # stacking, which consumes the transformed frames.
        self._connectors = list(obs_connectors or [])
        self._apply_conn = apply_connectors
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator().manual_seed(seed)
        obs, _ = self.envs.reset(seed=seed)
        obs = self._apply_conn(self._connectors, obs)
        self._raw_shape = tuple(obs.shape[1:])
        self._stack = None
        if frame_stack > 1:
            if len(self._raw_shape) != 3:
                raise ValueError("frame_stack needs (H, W, C) observations")
            h, w, c = self._raw_shape
            self._stack = np.zeros((num_envs, h, w, c * frame_stack),
                                   obs.dtype)
            # Episode starts are [frame]*k everywhere (the same treatment
            # resets get), not zero-padded history.
            self._push_frames(obs, reset_mask=np.ones(num_envs, bool))
            self.obs = self._stack.copy()
        else:
            self.obs = obs
        self._prev_done = np.zeros(num_envs, dtype=bool)
        self._episode_returns = np.zeros(num_envs)
        self._episode_lengths = np.zeros(num_envs, dtype=np.int64)
        self._completed: list = []
        self._params = None
        self._weights_version = -1
        self._receiver = None  # pubsub weight sync (enable_weight_sync)

        from ray_tpu_torch.rl.models import (
            build_policy,
            build_squashed_gaussian_actor,
            make_continuous_sample_fn,
            make_egreedy_sample_fn,
            make_sample_fn,
        )

        space = self.envs.single_action_space
        self._policy_mode = policy_mode
        self._epsilon = 1.0
        self._action_dim = None
        self._action_connectors = list(action_connectors or [])
        if policy_mode == "continuous":
            # Box actions: the policy emits [-1, 1]^d; a module-to-env
            # connector chain maps that to the env's action space. No
            # chain given = the default unsquash to the env's bounds,
            # which then must be finite.
            self._action_dim = int(np.prod(space.shape))
            self._action_shape = tuple(space.shape)
            if not self._action_connectors:
                from ray_tpu_torch.rl.connectors import UnsquashAction

                try:
                    self._action_connectors = [UnsquashAction(
                        np.asarray(space.low).reshape(-1),
                        np.asarray(space.high).reshape(-1))]
                except ValueError as e:
                    raise ValueError(
                        f"continuous policy_mode needs finite action "
                        f"bounds (or explicit action_connectors); "
                        f"{e}") from None
            _init, actor_forward = build_squashed_gaussian_actor(
                int(np.prod(self.obs.shape[1:])), self._action_dim)
            self._sample_fn = make_continuous_sample_fn(actor_forward)
        else:
            n_actions = int(space.n)
            _unused_init, forward = build_policy(self.obs.shape[1:],
                                                 n_actions)
            if policy_mode == "epsilon_greedy":
                self._sample_fn = make_egreedy_sample_fn(forward)
            else:
                self._sample_fn = make_sample_fn(forward)

    def set_epsilon(self, eps: float) -> None:
        """Exploration rate for epsilon_greedy mode (DQN)."""
        self._epsilon = float(eps)

    def get_connectors(self) -> list:
        """Connector objects WITH their state (running normalization
        statistics) — collected into algorithm checkpoints."""
        return self._connectors

    def set_connectors(self, connectors) -> None:
        self._connectors = list(connectors or [])

    @property
    def obs_shape(self):
        return self.obs.shape[1:]

    def _push_frames(self, obs: np.ndarray,
                     reset_mask: Optional[np.ndarray] = None) -> None:
        c = self._raw_shape[-1]
        if reset_mask is not None and reset_mask.any():
            # Reset envs restart their stack from the fresh frame (tile, not
            # repeat: repeat interleaves channels for c > 1).
            self._stack[reset_mask] = np.tile(
                obs[reset_mask], (1, 1, 1, self.frame_stack))
        self._stack = np.roll(self._stack, -c, axis=-1)
        self._stack[..., -c:] = obs

    def set_weights(self, params, version: int = 0) -> None:
        from ray_tpu_torch.rl.tree import own

        self._params = own(params)
        self._weights_version = version

    def weights_version(self) -> int:
        return self._weights_version

    def enable_weight_sync(self, key: str, channel: str = None) -> None:
        """Switch weight intake to the pubsub fan-out path: every
        ``sample()`` begins with a cheap freshness poll against the
        cluster hub and pulls the object-plane ref only when the learner
        published a NEWER version. The first sample blocks until an
        initial version exists."""
        from ray_tpu_torch.rl.distributed.fanout import (WEIGHTS_CHANNEL,
                                                         WeightReceiver)

        self._receiver = WeightReceiver(key, channel or WEIGHTS_CHANNEL)

    def _sync_weights(self) -> None:
        if self._receiver is None:
            return
        if self._params is None:
            got = self._receiver.wait_initial()
        else:
            got = self._receiver.poll(0.0)
        if got is not None:
            version, params, extras = got
            self.set_weights(params, version)
            if "epsilon" in extras:
                self._epsilon = float(extras["epsilon"])

    def _policy_step(self, obs, generator):
        """One policy forward for a (N, ...) observation batch ->
        (action, logp, value) as numpy arrays."""
        import torch

        assert self._params is not None, "set_weights first"
        x = torch.from_numpy(np.ascontiguousarray(obs))
        with torch.no_grad():
            if self._policy_mode == "epsilon_greedy":
                out = self._sample_fn(self._params, x, generator,
                                      self._epsilon)
            else:
                out = self._sample_fn(self._params, x, generator)
        return tuple(t.numpy() for t in out)

    def sample(self) -> Dict[str, np.ndarray]:
        """Collect one fixed-length rollout (T, N, ...) with bootstrap
        values and an autoreset-aware ``valids`` mask."""
        self._sync_weights()
        T, N = self.rollout_length, self.num_envs
        obs_dtype = self.obs.dtype
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], obs_dtype)
        if self._action_dim is not None:
            act_buf = np.zeros((T, N, self._action_dim), np.float32)
        else:
            act_buf = np.zeros((T, N), np.int64)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        term_buf = np.zeros((T, N), np.float32)  # terminated only, no trunc
        valid_buf = np.ones((T, N), np.float32)

        for t in range(T):
            action, logp, value = self._policy_step(self.obs, self._gen)
            obs_buf[t] = self.obs
            act_buf[t] = action
            logp_buf[t] = logp
            val_buf[t] = value
            valid_buf[t] = 1.0 - self._prev_done.astype(np.float32)
            env_action = self._apply_conn(self._action_connectors, action) \
                if self._action_connectors else action
            if self._action_dim is not None:
                # The env wants its native action shape back.
                env_action = np.asarray(env_action).reshape(
                    (len(action),) + self._action_shape)
            obs, reward, terminated, truncated, _ = self.envs.step(
                env_action)
            obs = self._apply_conn(self._connectors, obs)
            done = np.logical_or(terminated, truncated)
            if self._stack is not None:
                self._push_frames(obs, reset_mask=self._prev_done)
                self.obs = self._stack.copy()
            else:
                self.obs = obs
            # The step following a done is the autoreset step: its recorded
            # transition is synthetic (action ignored, reward 0).
            rew_buf[t] = np.where(self._prev_done, 0.0, reward)
            done_buf[t] = done
            # Truncation is not termination: off-policy targets must keep
            # bootstrapping through time-limit cuts.
            term_buf[t] = terminated
            live = ~self._prev_done
            self._episode_returns[live] += reward[live]
            self._episode_lengths[live] += 1
            for i in np.nonzero(done & live)[0]:
                self._completed.append(
                    (float(self._episode_returns[i]),
                     int(self._episode_lengths[i])))
                self._episode_returns[i] = 0.0
                self._episode_lengths[i] = 0
            self._prev_done = done

        # Bootstrap value for the final observation.
        _, _, last_value = self._policy_step(self.obs, self._gen)
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "terminateds": term_buf, "valids": valid_buf,
            "last_value": np.asarray(last_value, np.float32),
            # Off-policy consumers build next_obs[T-1] from this.
            "last_obs": self.obs.copy(),
            "weights_version": self._weights_version,
        }

    def episode_stats(self) -> Dict[str, Any]:
        completed, self._completed = self._completed, []
        if not completed:
            return {"episodes": 0}
        returns = [c[0] for c in completed]
        lengths = [c[1] for c in completed]
        return {
            "episodes": len(completed),
            "episode_return_mean": float(np.mean(returns)),
            "episode_return_max": float(np.max(returns)),
            "episode_len_mean": float(np.mean(lengths)),
        }
