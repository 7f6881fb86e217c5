"""Test environments (registered under the ``ray_tpu/`` namespace).

The image has no ALE/Atari ROMs, so the CNN/pixel path (the PPO-Atari
north-star pipeline: uint8 frames, frame stacking, Nature-DQN torso) is
exercised on MiniCatch — a small falling-block catch game with pixel
observations that a CNN policy learns in a few thousand steps."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import gymnasium as gym
import numpy as np


class MiniCatchEnv(gym.Env):
    """Catch the falling block: 24x24 uint8 frames, 3 actions
    (left/stay/right). Reward +1 on catch, -1 on miss; episode = one drop."""

    metadata = {"render_modes": []}

    def __init__(self, size: int = 24):
        self.size = size
        self.observation_space = gym.spaces.Box(
            0, 255, shape=(size, size, 1), dtype=np.uint8)
        self.action_space = gym.spaces.Discrete(3)
        self._rng = np.random.default_rng(0)

    def _frame(self) -> np.ndarray:
        frame = np.zeros((self.size, self.size, 1), np.uint8)
        frame[self.ball_y, self.ball_x, 0] = 255
        frame[self.size - 1,
              max(0, self.paddle - 1):self.paddle + 2, 0] = 128
        return frame

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Dict] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.ball_x = int(self._rng.integers(0, self.size))
        self.ball_y = 0
        self.paddle = self.size // 2
        return self._frame(), {}

    def step(self, action: int):
        self.paddle = int(np.clip(self.paddle + (int(action) - 1), 1,
                                  self.size - 2))
        self.ball_y += 1
        terminated = self.ball_y >= self.size - 1
        # Dense shaping (tracking the ball pays a little every step) keeps
        # the test's sample budget small; the terminal catch reward
        # dominates the return.
        reward = -0.02 * (abs(self.ball_x - self.paddle) > 1)
        if terminated:
            reward = 1.0 if abs(self.ball_x - self.paddle) <= 1 else -1.0
            self.ball_y = self.size - 1
        return self._frame(), float(reward), terminated, False, {}


try:
    gym.register("ray_tpu/MiniCatch-v0", entry_point=MiniCatchEnv)
except gym.error.Error:  # already registered in this process
    pass
