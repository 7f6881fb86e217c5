"""RL policy/value networks in PyTorch (port of ``ray_tpu/rl/models.py``).

Analogue of the reference's ``RLModule`` + model catalog: one functional
module producing action logits and value estimates. Params are dict trees
of tensors under the JAX keys (``layers``, ``pi``, ``vf``, ``convs``,
``fc``, ``net``, ``q1``, ``q2``; lists where the JAX trees have lists);
forwards are plain functions on tensors, so the same tree runs on CPU
env-runners (inference) and on the card's learner (training).

``build_policy`` picks the architecture from the observation shape — a
shared-torso MLP for vector observations, a Nature-DQN convolutional torso
for (H, W, C) pixel observations (the PPO-Atari north-star path) — and
returns ``(init_fn, forward_fn)``; ``init_fn`` takes a ``torch.Generator``
and makes the params on the generator's device.

Layouts: observations stay NHWC as in JAX; conv weights are OIHW (JAX:
HWIO) and the conv output is flattened in (h, w, c) order before ``fc``,
so ``fc``'s rows are the JAX ones. ``params_from_numpy`` carries a JAX
params tree across. Random draws enter as tensors or generators: the
squashed-Gaussian noise is an argument of :func:`squashed_sample`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.core.device import resolve_device

# Nature-DQN conv stack: (filters, kernel, stride) — for 84x84-class
# inputs; small frames (tests, toy pixel envs) get a shallower stack.
_CNN_SPEC = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
_CNN_SPEC_SMALL = ((16, 3, 2), (32, 3, 2))


def _cnn_spec_for(h: int, w: int):
    return _CNN_SPEC if min(h, w) >= 60 else _CNN_SPEC_SMALL


PolicyFns = Tuple[Callable[[torch.Generator], Dict[str, Any]],
                  Callable[[Dict[str, Any], torch.Tensor],
                           Tuple[torch.Tensor, torch.Tensor]]]


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _zeros(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.zeros((n,), device=gen.device)


def build_policy(obs_shape: Sequence[int], num_actions: int,
                 hidden: Sequence[int] = (64, 64)) -> PolicyFns:
    if len(obs_shape) == 3:
        return _build_cnn(tuple(obs_shape), num_actions)
    return _build_mlp(int(np.prod(obs_shape)), num_actions, tuple(hidden))


def _build_mlp(obs_dim: int, num_actions: int, hidden) -> PolicyFns:
    def init(gen: torch.Generator) -> Dict[str, Any]:
        params: Dict[str, Any] = {"layers": []}
        sizes = [obs_dim, *hidden]
        for i in range(len(hidden)):
            params["layers"].append({
                "w": _normal(gen, (sizes[i], sizes[i + 1]),
                             math.sqrt(2.0 / sizes[i])),
                "b": _zeros(gen, sizes[i + 1]),
            })
        params["pi"] = {"w": _normal(gen, (sizes[-1], num_actions), 0.01),
                        "b": _zeros(gen, num_actions)}
        params["vf"] = {"w": _normal(gen, (sizes[-1], 1), 1.0),
                        "b": _zeros(gen, 1)}
        return params

    def forward(params, obs):
        x = obs.reshape(obs.shape[0], -1).to(torch.float32)
        for layer in params["layers"]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
        logits = x @ params["pi"]["w"] + params["pi"]["b"]
        value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
        return logits, value

    return init, forward


def _build_cnn(obs_shape: Tuple[int, int, int], num_actions: int,
               fc_dim: int = 512) -> PolicyFns:
    h0, w0, c0 = obs_shape
    spec = _cnn_spec_for(h0, w0)
    # Static output-shape bookkeeping for the fc layer.
    h, w, in_ch = h0, w0, c0
    for out_ch, ksize, stride in spec:
        h = (h - ksize) // stride + 1
        w = (w - ksize) // stride + 1
        in_ch = out_ch
    flat = h * w * in_ch

    def init(gen: torch.Generator) -> Dict[str, Any]:
        params: Dict[str, Any] = {"convs": []}
        ch = c0
        for out_ch, ksize, _stride in spec:
            fan_in = ksize * ksize * ch
            params["convs"].append({
                "w": _normal(gen, (out_ch, ch, ksize, ksize),
                             math.sqrt(2.0 / fan_in)),
                "b": _zeros(gen, out_ch),
            })
            ch = out_ch
        params["fc"] = {"w": _normal(gen, (flat, fc_dim),
                                     math.sqrt(2.0 / flat)),
                        "b": _zeros(gen, fc_dim)}
        params["pi"] = {"w": _normal(gen, (fc_dim, num_actions), 0.01),
                        "b": _zeros(gen, num_actions)}
        params["vf"] = {"w": _normal(gen, (fc_dim, 1), 1.0),
                        "b": _zeros(gen, 1)}
        return params

    def forward(params, obs):
        # uint8 frames travel as uint8 and are cast where they land.
        x = obs.to(torch.float32)
        if obs.dtype == torch.uint8:
            x = x / 255.0
        x = x.permute(0, 3, 1, 2)            # NHWC as NCHW (channels-last)
        for conv, (_f, _k, stride) in zip(params["convs"], spec):
            x = F.relu(F.conv2d(x, conv["w"], conv["b"], stride=stride))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c)
        x = F.relu(x @ params["fc"]["w"] + params["fc"]["b"])
        logits = x @ params["pi"]["w"] + params["pi"]["b"]
        value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
        return logits, value

    return init, forward


def take_logp(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(logp_all, actions[..., None], -1)[..., 0]``."""
    return logp_all.gather(-1, actions[..., None].long())[..., 0]


def make_sample_fn(forward):
    def sample_action(params, obs, generator):
        logits, value = forward(params, obs)
        action = torch.multinomial(torch.softmax(logits, -1), 1,
                                   generator=generator)[:, 0]
        logp = take_logp(torch.log_softmax(logits, -1), action)
        return action, logp, value

    return sample_action


def make_egreedy_sample_fn(forward):
    """Epsilon-greedy over the network's action scores (Q-values for DQN;
    the policy head doubles as the Q head)."""

    def sample_action(params, obs, generator, eps):
        q, _value = forward(params, obs)
        greedy = torch.argmax(q, dim=-1)
        rand = torch.randint(0, q.shape[-1], greedy.shape,
                             generator=generator, device=q.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < eps
        action = torch.where(explore, rand, greedy)
        value = q.max(dim=-1).values  # greedy value, for stats/bootstraps
        return action, torch.zeros_like(value), value

    return sample_action


# ------------------------------------------------ continuous control (SAC)


def _mlp_init(gen: torch.Generator, sizes):
    return [{"w": _normal(gen, (sizes[i], sizes[i + 1]),
                          math.sqrt(2.0 / sizes[i])),
             "b": _zeros(gen, sizes[i + 1])}
            for i in range(len(sizes) - 1)]


def _mlp_apply(layers, x, final_linear=True):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or not final_linear:
            x = F.relu(x)
    return x


LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


def build_squashed_gaussian_actor(obs_dim: int, action_dim: int,
                                  hidden: Sequence[int] = (256, 256)):
    """Tanh-squashed diagonal Gaussian policy (SAC actor). ``forward``
    returns (mean, log_std); sampling and the tanh-corrected log-prob live
    in :func:`squashed_sample`."""

    def init(gen: torch.Generator):
        return {"net": _mlp_init(gen, [obs_dim, *hidden, 2 * action_dim])}

    def forward(params, obs):
        out = _mlp_apply(params["net"],
                         obs.reshape(obs.shape[0], -1).to(torch.float32))
        mean, log_std = out.chunk(2, dim=-1)
        return mean, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)

    return init, forward


def squashed_sample(mean, log_std, noise):
    """A tanh-squashed Gaussian action and its log-prob (with the
    change-of-variables correction, numerically stable form) for standard
    normal ``noise`` of ``mean``'s shape (the JAX function draws it from a
    key; here the caller draws it)."""
    std = torch.exp(log_std)
    pre_tanh = mean + std * noise
    action = torch.tanh(pre_tanh)
    logp_gauss = -0.5 * (noise ** 2 + 2 * log_std
                         + math.log(2 * math.pi)).sum(-1)
    # log(1 - tanh(x)^2) = 2 * (log 2 - x - softplus(-2x))
    correction = (2.0 * (math.log(2.0) - pre_tanh
                         - F.softplus(-2.0 * pre_tanh))).sum(-1)
    return action, logp_gauss - correction


def build_twin_q(obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256)):
    """Two independent Q(s, a) heads in one tree (clipped double-Q)."""

    def init(gen: torch.Generator):
        sizes = [obs_dim + action_dim, *hidden, 1]
        q1 = _mlp_init(gen, sizes)
        return {"q1": q1, "q2": _mlp_init(gen, sizes)}

    def forward(params, obs, action):
        x = torch.cat(
            [obs.reshape(obs.shape[0], -1).to(torch.float32), action],
            dim=-1)
        return (_mlp_apply(params["q1"], x)[..., 0],
                _mlp_apply(params["q2"], x)[..., 0])

    return init, forward


def make_continuous_sample_fn(actor_forward):
    """EnvRunner-facing sampler for continuous policies: (action in
    [-1, 1]^d, logp, value placeholder)."""

    def sample(params, obs, generator):
        mean, log_std = actor_forward(params, obs)
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device)
        action, logp = squashed_sample(mean, log_std, noise)
        return action, logp, torch.zeros(action.shape[0],
                                         device=action.device)

    return sample


# ---------------------------------------------------- weights carried across


def params_from_numpy(tree: Dict[str, Any], init_fn, device=None):
    """Carry a JAX params tree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), into the port under the same
    key paths, in float32. ``init_fn`` is the port's init of the same
    family and sizes (``build_policy``, ``build_squashed_gaussian_actor``
    or ``build_twin_q``); every key, list length and shape must be its.
    Conv weights go from HWIO to OIHW."""
    dev = resolve_device(device)
    template = init_fn(torch.Generator().manual_seed(0))

    def conv(spec, arr, path):
        if isinstance(spec, dict):
            keys = sorted(arr) if isinstance(arr, dict) else None
            if keys != sorted(spec):
                raise ValueError(f"params at {path or '/'} have keys {keys}, "
                                 f"expected {sorted(spec)}")
            return {k: conv(spec[k], arr[k], f"{path}/{k}") for k in spec}
        if isinstance(spec, list):
            if not isinstance(arr, (list, tuple)) or len(arr) != len(spec):
                raise ValueError(f"params at {path} are not a list of "
                                 f"{len(spec)}")
            return [conv(s, a, f"{path}/{i}")
                    for i, (s, a) in enumerate(zip(spec, arr))]
        a = np.array(arr, dtype=np.float32)
        if a.ndim == 4 and path.startswith("/convs/"):
            a = a.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        if a.shape != tuple(spec.shape):
            raise ValueError(f"param {path} has shape {a.shape}, expected "
                             f"{tuple(spec.shape)} for this net")
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return conv(template, tree, "")


# ------------------------------------------------- backward-compat surface

def init_mlp_policy(generator: torch.Generator, obs_dim: int,
                    num_actions: int,
                    hidden: Sequence[int] = (64, 64)) -> Dict[str, Any]:
    init, _ = _build_mlp(obs_dim, num_actions, tuple(hidden))
    return init(generator)


def mlp_forward(params: Dict[str, Any], obs: torch.Tensor):
    x = obs.to(torch.float32)
    for layer in params["layers"]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def sample_action(params, obs, generator):
    return make_sample_fn(mlp_forward)(params, obs, generator)
