"""The port's RL plane (``ray_tpu_torch.rl``) held against ``ray_tpu.rl``
on the CPU: the same numpy inputs, params made by the JAX package's own
inits and carried across by ``rl.models.params_from_numpy``.

Tolerances (float32 on both sides):
- forwards and samplers: max |port - JAX| / max |JAX| <= 1e-5 per output;
- ``compute_gae`` (a numpy copy), the replay buffer and the sum tree:
  equal; ``vtrace``: rtol 1e-5, atol 1e-6;
- one update of each algorithm: loss and every aux value at rtol 1e-5
  (atol 1e-6), every gradient leaf at relative 1e-5 in norm
  (||g_port - g_jax|| / ||g_jax||). The gradients are read by a recording
  SGD in each side's optimizer slot (lr 1e-2, so a staged update — SAC's
  actor after its critic — sees the same updated net on both sides), and
  the params after the update within 1e-6;
- the slice's rollout -> GAE -> PPO-with-Adam loop: losses at rtol 1e-4,
  params within 3 x lr x updates (Adam's first steps are near sign(g), so
  an entry with a gradient near zero may step either way in two correct
  programs);
- greedy EnvRunners: obs, actions, rewards, dones, terminateds, valids and
  last_obs equal; values and last_value at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import models as jm
from ray_tpu_torch.rl import models as tm
from ray_tpu_torch.rl.tree import tree_leaves
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = 1e-2
GRAD_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(jtree, init_fn):
    return tm.params_from_numpy(_np(jtree), init_fn, device="cpu")


def _t(batch):
    """A numpy batch as CPU tensors (float64 as float32, as JAX lands it)."""
    from ray_tpu_torch.rl.tree import batch_to

    return batch_to(batch, "cpu")


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_grads(port_tree, jax_tree, init_fn):
    want = tree_leaves(_carry(jax_tree, init_fn))
    got = tree_leaves(port_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        num = float(torch.linalg.vector_norm(g - w))
        den = float(torch.linalg.vector_norm(w))
        assert num <= GRAD_TOL * max(den, 1e-12), (num, den)


def _assert_params(port_tree, jax_tree, init_fn, atol):
    for g, w in zip(tree_leaves(port_tree),
                    tree_leaves(_carry(jax_tree, init_fn))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol)


def _assert_aux(got: dict, want: dict, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_sgd(lr, log):
    """optax.sgd(lr) that records each gradient tree it is handed."""
    def init(params):
        return optax.EmptyState()

    def update(grads, state, params=None):
        log.append(_np(grads))
        return jax.tree.map(lambda g: -lr * g, grads), state

    return optax.GradientTransformation(init, update)


class _TorchSGD:
    """The port's optimizer slot: SGD(lr) recording each gradient tree."""

    def __init__(self, lr):
        self.lr, self.log = lr, []

    def init(self, params):
        return ()

    @torch.no_grad()
    def update(self, grads, state, params):
        self.log.append(jax.tree.map(lambda g: g.clone(), grads))
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.sub_(self.lr * g)
        return state


# --------------------------------------------------------------- families

POLICY_FAMILIES = {
    "mlp": ((4,), 2, np.float32),
    "mlp_2d_obs": ((3, 2), 3, np.float32),
    "small_cnn": ((16, 16, 2), 3, np.uint8),
    "nature_cnn": ((84, 84, 4), 6, np.uint8),
}


def _obs(shape, dtype, n, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n,) + shape).astype(np.uint8)
    return rng.normal(size=(n,) + shape).astype(np.float32)


def _policy_pair(shape, n_actions, hidden=(64, 64), seed=0):
    jinit, jfwd = jm.build_policy(shape, n_actions, hidden)
    tinit, tfwd = tm.build_policy(shape, n_actions, hidden)
    jp = jinit(jax.random.key(seed))
    return jp, jfwd, _carry(jp, tinit), tfwd, tinit


@pytest.mark.parametrize("family", sorted(POLICY_FAMILIES))
def test_policy_forward_matches(family):
    shape, n_actions, dtype = POLICY_FAMILIES[family]
    jp, jfwd, tp, tfwd, _ = _policy_pair(shape, n_actions)
    obs = _obs(shape, dtype, 5)
    jl, jv = jfwd(jp, jnp.asarray(obs))
    tl, tv = tfwd(tp, torch.from_numpy(obs))
    assert tl.shape == (5, n_actions) and tv.shape == (5,)
    assert _max_rel(tl, jl) <= 1e-5
    assert _max_rel(tv, jv) <= 1e-5


def test_params_from_numpy_checks_keys_and_shapes():
    jinit, _ = jm.build_policy((16, 16, 2), 3)
    tinit, _ = tm.build_policy((16, 16, 2), 3)
    tree = _np(jinit(jax.random.key(0)))
    out = tm.params_from_numpy(tree, tinit, device="cpu")
    # Conv weights go HWIO -> OIHW; fc keeps the JAX rows.
    np.testing.assert_array_equal(out["convs"][0]["w"].numpy(),
                                  tree["convs"][0]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(out["fc"]["w"].numpy(), tree["fc"]["w"])
    bad = dict(tree, pi=dict(tree["pi"], w=tree["pi"]["w"][:, :2]))
    with pytest.raises(ValueError, match="shape"):
        tm.params_from_numpy(bad, tinit, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        tm.params_from_numpy({k: v for k, v in tree.items() if k != "vf"},
                             tinit, device="cpu")
    with pytest.raises(ValueError, match="list"):
        tm.params_from_numpy(dict(tree, convs=tree["convs"][:1]), tinit,
                             device="cpu")


def _continuous_pair(obs_dim=3, act_dim=1, hidden=(256, 256), seed=0):
    jai, jaf = jm.build_squashed_gaussian_actor(obs_dim, act_dim, hidden)
    tai, taf = tm.build_squashed_gaussian_actor(obs_dim, act_dim, hidden)
    jci, jcf = jm.build_twin_q(obs_dim, act_dim, hidden)
    tci, tcf = tm.build_twin_q(obs_dim, act_dim, hidden)
    ja, jc = jai(jax.random.key(seed)), jci(jax.random.key(seed + 1))
    return dict(ja=ja, jaf=jaf, jc=jc, jcf=jcf, ta=_carry(ja, tai),
                taf=taf, tc=_carry(jc, tci), tcf=tcf, tai=tai, tci=tci)


def test_actor_critic_forwards_and_squashed_sample_match():
    n = _continuous_pair(obs_dim=3, act_dim=2)
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(7, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, (7, 2)).astype(np.float32)
    jmean, jls = n["jaf"](n["ja"], jnp.asarray(obs))
    tmean, tls = n["taf"](n["ta"], torch.from_numpy(obs))
    assert _max_rel(tmean, jmean) <= 1e-5 and _max_rel(tls, jls) <= 1e-5
    jq = n["jcf"](n["jc"], jnp.asarray(obs), jnp.asarray(act))
    tq = n["tcf"](n["tc"], torch.from_numpy(obs), torch.from_numpy(act))
    for a, b in zip(tq, jq):
        assert _max_rel(a, b) <= 1e-5
    # squashed_sample on the JAX package's own draw (models.py:218).
    key = jax.random.key(3)
    ja, jlogp = jm.squashed_sample(jmean, jls, key)
    noise = np.array(jax.random.normal(key, jmean.shape))
    ta, tlogp = tm.squashed_sample(tmean, tls, torch.from_numpy(noise))
    assert _max_rel(ta, ja) <= 1e-5 and _max_rel(tlogp, jlogp) <= 1e-5


def test_egreedy_and_categorical_samplers():
    jp, jfwd, tp, tfwd, _ = _policy_pair((4,), 3)
    obs = _obs((4,), np.float32, 9)
    g = torch.Generator().manual_seed(0)
    ja, _, jv = jm.make_egreedy_sample_fn(jfwd)(
        jp, jnp.asarray(obs), jax.random.key(0), 0.0)
    ta, tlogp, tv = tm.make_egreedy_sample_fn(tfwd)(
        tp, torch.from_numpy(obs), g, 0.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert _max_rel(tv, jv) <= 1e-5 and not tlogp.any()
    # eps = 1: every action is a uniform draw in range.
    ta, _, _ = tm.make_egreedy_sample_fn(tfwd)(
        tp, torch.from_numpy(np.repeat(obs, 50, 0)), g, 1.0)
    assert set(ta.tolist()) == {0, 1, 2}
    # Categorical: the log-prob is the JAX log-softmax at the drawn action.
    ta, tlogp, tv = tm.make_sample_fn(tfwd)(tp, torch.from_numpy(obs), g)
    jl, _ = jfwd(jp, jnp.asarray(obs))
    want = np.asarray(jax.nn.log_softmax(jl))[np.arange(9), ta.numpy()]
    np.testing.assert_allclose(tlogp.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ advantage math


def _rollout(T=12, N=3, seed=0):
    rng = np.random.default_rng(seed)
    dones = np.zeros((T, N), np.float32)
    dones[T // 4, 0] = dones[T // 2 + 1, 1] = dones[T - 2, 2] = 1.0
    valids = np.ones((T, N), np.float32)
    # The autoreset rows after those dones.
    valids[T // 4 + 1, 0] = valids[T // 2 + 2, 1] = valids[T - 1, 2] = 0.0
    return {
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "dones": dones, "valids": valids,
        "last_value": rng.normal(size=(N,)).astype(np.float32),
        "logp": rng.normal(-0.7, 0.1, (T, N)).astype(np.float32),
        "target_logp": rng.normal(-0.7, 0.3, (T, N)).astype(np.float32),
    }


def test_compute_gae_matches():
    from ray_tpu.rl.ppo import compute_gae as jgae
    from ray_tpu_torch.rl.ppo import compute_gae as tgae

    ro = _rollout()
    for valids in (True, False):
        r = ro if valids else {k: v for k, v in ro.items() if k != "valids"}
        want, got = jgae(r, 0.97, 0.9), tgae(r, 0.97, 0.9)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_vtrace_matches():
    from ray_tpu.rl.impala import vtrace as jv
    from ray_tpu_torch.rl.impala import vtrace as tv

    ro = _rollout(T=16, N=4, seed=2)
    keys = ("logp", "target_logp", "rewards", "values", "dones",
            "last_value", "valids")
    jvs, jadv = jv(*(jnp.asarray(ro[k]) for k in keys), gamma=0.95,
                   rho_clip=1.0, c_clip=0.9)
    tvs, tadv = tv(*(torch.from_numpy(ro[k]) for k in keys), gamma=0.95,
                   rho_clip=1.0, c_clip=0.9)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), rtol=1e-5,
                               atol=1e-6)
    assert not tadv.numpy()[ro["valids"] == 0].any()


# ------------------------------------------------------------- updates


def _ppo_batch(shape, dtype, n_actions, n=48, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": _obs(shape, dtype, n, seed),
            "actions": rng.integers(0, n_actions, n).astype(np.int64),
            "logp": rng.normal(-1.0, 0.2, n).astype(np.float32),
            "advantages": rng.normal(0.5, 2.0, n).astype(np.float32),
            "returns": rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("family", ["mlp", "small_cnn"])
def test_ppo_update_matches(family):
    from ray_tpu.rl.ppo import make_ppo_update as jmake
    from ray_tpu_torch.rl.ppo import make_ppo_update as tmake

    shape, n_actions, dtype = POLICY_FAMILIES[family]
    jp, jfwd, tp, tfwd, tinit = _policy_pair(shape, n_actions)
    batch = _ppo_batch(shape, dtype, n_actions)
    jlog, topt = [], _TorchSGD(LR)
    jopt = _jax_sgd(LR, jlog)
    jp2, _, jaux = jmake(jfwd, jopt, 0.2, 0.5, 0.01)(
        jp, jopt.init(jp), jax.tree.map(jnp.asarray, batch))
    tp2, _, taux = tmake(tfwd, topt, 0.2, 0.5, 0.01)(
        tp, topt.init(tp), _t(batch))
    _assert_aux(taux, jaux)
    _assert_grads(topt.log[0], jlog[0], tinit)
    _assert_params(tp2, jp2, tinit, atol=1e-6)


def _impala_batch(T=8, N=4, n_actions=2, seed=0):
    ro = _rollout(T, N, seed)
    rng = np.random.default_rng(seed + 10)
    return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
            "actions": rng.integers(0, n_actions, (T, N)).astype(np.int64),
            **{k: ro[k] for k in ("logp", "rewards", "dones", "valids",
                                  "last_value")}}


def test_impala_update_matches():
    from ray_tpu.rl.impala import IMPALAConfig as JCfg
    from ray_tpu.rl.impala import make_impala_update as jmake
    from ray_tpu_torch.rl.impala import IMPALAConfig as TCfg
    from ray_tpu_torch.rl.impala import make_impala_update as tmake

    jp, jfwd, tp, tfwd, tinit = _policy_pair((4,), 2)
    batch = _impala_batch()
    jlog, topt = [], _TorchSGD(LR)
    jopt = _jax_sgd(LR, jlog)
    jp2, _, jaux = jmake(jfwd, jopt, JCfg(c_clip=0.9))(
        jp, jopt.init(jp), jax.tree.map(jnp.asarray, batch))
    tp2, _, taux = tmake(tfwd, topt, TCfg(c_clip=0.9))(
        tp, topt.init(tp), _t(batch))
    _assert_aux(taux, jaux)
    _assert_grads(topt.log[0], jlog[0], tinit)
    _assert_params(tp2, jp2, tinit, atol=1e-6)


def _jax_closure(cls, **attrs):
    """A JAX algorithm object with only what its ``_make_update`` reads
    (no env probe, no runners)."""
    obj = cls.__new__(cls)
    for k, v in attrs.items():
        setattr(obj, k, v)
    return obj._make_update()


def test_appo_update_matches_across_a_target_sync():
    from ray_tpu.rl.appo import APPO as JAPPO
    from ray_tpu.rl.appo import APPOConfig as JCfg
    from ray_tpu_torch.rl.appo import APPOConfig as TCfg
    from ray_tpu_torch.rl.appo import make_appo_update
    from ray_tpu_torch.rl.tree import clone

    jp, jfwd, tp, tfwd, tinit = _policy_pair((4,), 2)
    jlog, topt = [], _TorchSGD(LR)
    jopt = _jax_sgd(LR, jlog)
    jupd = _jax_closure(JAPPO, config=JCfg(target_update_interval=2),
                        _forward=jfwd, optimizer=jopt)
    tupd = make_appo_update(tfwd, topt, TCfg(target_update_interval=2))
    jb = (jopt.init(jp), jax.tree.map(lambda x: x, jp),
          jnp.zeros((), jnp.int32))
    tb = (topt.init(tp), clone(tp), 0)
    for step in range(3):
        batch = _impala_batch(seed=step)
        jp, jb, jaux = jupd(jp, jb, jax.tree.map(jnp.asarray, batch))
        tp, tb, taux = tupd(tp, tb, _t(batch))
        _assert_aux(taux, jaux)
        _assert_grads(topt.log[step], jlog[step], tinit)
        assert tb[2] == int(jb[2]) == (step + 1) % 2
        _assert_params(tb[1], jb[1], tinit, atol=1e-6)
    # The sync after update 2 copied the params; update 3 moved on.
    _assert_params(tp, jp, tinit, atol=1e-6)


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches(double_q):
    from ray_tpu.rl.dqn import make_dqn_update as jmake
    from ray_tpu_torch.rl.dqn import make_dqn_update as tmake

    jp, jfwd, tp, tfwd, tinit = _policy_pair((4,), 3)
    jt, _, tt, _, _ = _policy_pair((4,), 3, seed=1)
    rng = np.random.default_rng(4)
    n = 40
    batch = {"obs": _obs((4,), np.float32, n, 1),
             "actions": rng.integers(0, 3, n).astype(np.int32),
             "rewards": rng.normal(size=n).astype(np.float32),
             "next_obs": _obs((4,), np.float32, n, 2),
             "dones": (rng.random(n) < 0.2).astype(np.float32),
             "weights": rng.uniform(0.2, 1.0, n).astype(np.float32)}
    # Large TD errors on some rows exercise the Huber loss's linear part.
    batch["rewards"][:5] *= 20
    jlog, topt = [], _TorchSGD(LR)
    jopt = _jax_sgd(LR, jlog)
    jp2, _, jloss, jaux = jmake(jfwd, jopt, 0.99, double_q)(
        jp, jt, jopt.init(jp), jax.tree.map(jnp.asarray, batch))
    tp2, _, tloss, taux = tmake(tfwd, topt, 0.99, double_q)(
        tp, tt, topt.init(tp), _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_aux(taux, jaux, ["q_mean"])
    np.testing.assert_allclose(taux["td_abs"].numpy(),
                               np.asarray(jaux["td_abs"]), rtol=1e-5,
                               atol=1e-6)
    _assert_grads(topt.log[0], jlog[0], tinit)
    _assert_params(tp2, jp2, tinit, atol=1e-6)


@pytest.mark.parametrize("family", ["mlp", "small_cnn"])
def test_bc_update_matches(family):
    from ray_tpu.rl.bc import BC as JBC
    from ray_tpu_torch.rl.bc import make_bc_update

    shape, n_actions, dtype = POLICY_FAMILIES[family]
    jp, jfwd, tp, tfwd, tinit = _policy_pair(shape, n_actions)
    rng = np.random.default_rng(5)
    batch = {"obs": _obs(shape, dtype, 33, 3),
             "actions": rng.integers(0, n_actions, 33).astype(np.int64)}
    jlog, topt = [], _TorchSGD(LR)
    jopt = _jax_sgd(LR, jlog)
    jupd = _jax_closure(JBC, _forward=jfwd, optimizer=jopt)
    jp2, _, jloss, jacc = jupd(jp, jopt.init(jp),
                               jax.tree.map(jnp.asarray, batch))
    tp2, _, tloss, tacc = make_bc_update(tfwd, topt)(
        tp, topt.init(tp), _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tacc) == float(jacc)
    _assert_grads(topt.log[0], jlog[0], tinit)
    _assert_params(tp2, jp2, tinit, atol=1e-6)


def _transitions(n, obs_dim, act_dim, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "terminateds": (rng.random(n) < 0.1).astype(np.float32)}


def _staged_opts():
    logs = {k: [] for k in ("actor", "critic", "alpha")}
    jopts = {k: _jax_sgd(LR, logs[k]) for k in logs}
    topts = {k: _TorchSGD(LR) for k in logs}
    return logs, jopts, topts


def _check_staged(n, jout, tout, logs, topts):
    """Critic, actor and temperature gradients, then every tree after."""
    _assert_grads(topts["critic"].log[0], logs["critic"][0], n["tci"])
    _assert_grads(topts["actor"].log[0], logs["actor"][0], n["tai"])
    np.testing.assert_allclose(float(topts["alpha"].log[0]),
                               float(logs["alpha"][0]), rtol=1e-5)
    _assert_params(tout[0], jout[0], n["tai"], atol=1e-6)
    _assert_params(tout[1], jout[1], n["tci"], atol=1e-6)
    _assert_params(tout[2], jout[2], n["tci"], atol=1e-6)
    np.testing.assert_allclose(float(tout[3]), float(jout[3]), rtol=1e-6)


def test_sac_update_matches_on_the_jax_draws():
    from ray_tpu.rl.sac import SAC as JSAC
    from ray_tpu.rl.sac import SACConfig as JCfg
    from ray_tpu_torch.rl.sac import make_sac_update

    n = _continuous_pair(obs_dim=3, act_dim=1, hidden=(64, 64))
    B = 32
    batch = _transitions(B, 3, 1, 6)
    logs, jopts, topts = _staged_opts()
    jupd = _jax_closure(JSAC, config=JCfg(), _actor_fwd=n["jaf"],
                        _critic_fwd=n["jcf"], _actor_opt=jopts["actor"],
                        _critic_opt=jopts["critic"],
                        _alpha_opt=jopts["alpha"], _target_entropy=-1.0)
    tupd = make_sac_update(n["taf"], n["tcf"], topts["actor"],
                           topts["critic"], topts["alpha"], 0.99, 0.005,
                           -1.0)
    key = jax.random.key(11)
    # The JAX update's draws (sac.py:134, models.py:218).
    k1, k2 = jax.random.split(key)
    draws = {"critic": np.asarray(jax.random.normal(k1, (B, 1))),
             "actor": np.asarray(jax.random.normal(k2, (B, 1)))}
    log_alpha = 0.1
    jc_target = jax.tree.map(lambda x: x + 0.01, n["jc"])
    tc_target = _carry(jc_target, n["tci"])
    jout = jupd(n["ja"], n["jc"], jc_target, jnp.float32(log_alpha),
                (optax.EmptyState(),) * 3,
                jax.tree.map(jnp.asarray, batch), key)
    tout = tupd(n["ta"], n["tc"], tc_target,
                torch.tensor(log_alpha, dtype=torch.float32), ((),) * 3,
                _t(batch), {k: torch.from_numpy(v) for k, v in
                            draws.items()})
    _assert_aux(tout[5], jout[5])
    _check_staged(n, jout, tout, logs, topts)


@pytest.mark.parametrize("bc", [True, False])
def test_cql_update_matches_on_the_jax_draws(bc):
    from ray_tpu.rl.cql import CQL as JCQL
    from ray_tpu.rl.cql import CQLConfig as JCfg
    from ray_tpu_torch.rl.cql import CQLConfig as TCfg
    from ray_tpu_torch.rl.cql import make_cql_update

    n = _continuous_pair(obs_dim=3, act_dim=2, hidden=(64, 64))
    B, K, A = 24, 3, 2
    batch = _transitions(B, 3, A, 7)
    logs, jopts, topts = _staged_opts()
    jcfg, tcfg = JCfg(cql_n_actions=K, cql_alpha=2.0), TCfg(
        cql_n_actions=K, cql_alpha=2.0)
    jupd = _jax_closure(JCQL, config=jcfg, _actor_fwd=n["jaf"],
                        _critic_fwd=n["jcf"], _actor_opt=jopts["actor"],
                        _critic_opt=jopts["critic"],
                        _alpha_opt=jopts["alpha"], _target_entropy=-2.0)
    tupd = make_cql_update(n["taf"], n["tcf"], topts["actor"],
                           topts["critic"], topts["alpha"], tcfg, -2.0)
    key = jax.random.key(12)
    # The JAX update's key schedule (cql.py:149, :205; models.py:218).
    k1, k2 = jax.random.split(key)
    k_next, k_rand, k_pi, k_npi = jax.random.split(k1, 4)
    draws = {"next": jax.random.normal(k_next, (B, A)),
             "rand": jax.random.uniform(k_rand, (B, K, A), minval=-1.0,
                                        maxval=1.0),
             "pi": jax.random.normal(k_pi, (B * K, A)),
             "npi": jax.random.normal(k_npi, (B * K, A)),
             "actor": jax.random.normal(k2, (B, A))}
    jc_target = jax.tree.map(lambda x: x * 0.9, n["jc"])
    jout = jupd(n["ja"], n["jc"], jc_target, jnp.float32(np.log(0.2)),
                (optax.EmptyState(),) * 3,
                jax.tree.map(jnp.asarray, batch), key, bc)
    tout = tupd(n["ta"], n["tc"], _carry(jc_target, n["tci"]),
                torch.tensor(np.log(0.2), dtype=torch.float32), ((),) * 3,
                _t(batch), {k: torch.from_numpy(np.asarray(v))
                            for k, v in draws.items()}, bc)
    _assert_aux(tout[5], jout[5])
    _check_staged(n, jout, tout, logs, topts)


# ------------------------------------------------------- replay buffers


def test_replay_buffer_and_sum_tree_match():
    from ray_tpu.rl.replay import ReplayBuffer as JBuf
    from ray_tpu.rl.replay import SumTree as JTree
    from ray_tpu_torch.rl.replay import ReplayBuffer as TBuf
    from ray_tpu_torch.rl.replay import SumTree as TTree

    jt, tt = JTree(16), TTree(16)
    for tree in (jt, tt):
        tree.set(np.arange(10), np.linspace(0.1, 3.0, 10))
    assert tt.total == jt.total
    np.testing.assert_array_equal(tt.sample(64, np.random.default_rng(3)),
                                  jt.sample(64, np.random.default_rng(3)))
    for prioritized in (False, True):
        jb = JBuf(32, prioritized=prioritized, seed=5)
        tb = TBuf(32, prioritized=prioritized, seed=5)
        rng = np.random.default_rng(0)
        for _ in range(5):
            add = {"x": rng.normal(size=(9, 2)).astype(np.float32),
                   "a": rng.integers(0, 4, 9)}
            jb.add(add)
            tb.add(add)
        for _ in range(3):
            (jbatch, jidx, jw), (tbatch, tidx, tw) = jb.sample(20), \
                tb.sample(20)
            np.testing.assert_array_equal(tidx, jidx)
            np.testing.assert_array_equal(tw, jw)
            for k in jbatch:
                np.testing.assert_array_equal(tbatch[k], jbatch[k])
            td = rng.normal(size=20)
            jb.update_priorities(jidx, td)
            tb.update_priorities(tidx, td)
        js, ts = jb.state_dict(17), tb.state_dict(17)
        for k in js["batch"]:
            np.testing.assert_array_equal(ts["batch"][k], js["batch"][k])


# ------------------------------------------------------------ env runners


RUNNER_CASES = {
    "cartpole": ("CartPole-v1", {}, 1, (4,), 2),
    "minicatch_fs2": ("ray_tpu/MiniCatch-v0", {"size": 16}, 2, (16, 16, 2),
                      3),
}


def _runner_pair(case, num_envs=3, T=40):
    from ray_tpu.rl.env_runner import EnvRunner as JRunner
    from ray_tpu_torch.rl.env_runner import EnvRunner as TRunner

    env, env_config, fs, shape, n_actions = RUNNER_CASES[case]
    jp, _, tp, _, _ = _policy_pair(shape, n_actions, seed=4)
    runners = []
    for cls, params in ((JRunner, jp), (TRunner, tp)):
        r = cls(env, num_envs=num_envs, rollout_length=T, seed=3,
                env_config=env_config, frame_stack=fs,
                policy_mode="epsilon_greedy")
        r.set_weights(params, 1)
        r.set_epsilon(0.0)
        runners.append(r)
    return runners


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_greedy_env_runner_rollouts_match(case):
    jr, tr = _runner_pair(case)
    for _ in range(2):
        want, got = jr.sample(), tr.sample()
        assert set(got) == set(want)
        for k in ("obs", "actions", "rewards", "dones", "terminateds",
                  "valids", "last_obs", "weights_version", "logp"):
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        for k in ("values", "last_value"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert (want["valids"] == 0).any() or case == "cartpole"
    assert tr.episode_stats() == jr.episode_stats()


def test_rollout_gae_ppo_loop_matches():
    """The slice end to end on one rollout: greedy rollouts equal, then
    GAE and two epochs of minibatched PPO with Adam on both sides from the
    same params and permutations."""
    from ray_tpu.rl.ppo import compute_gae
    from ray_tpu.rl.ppo import make_ppo_update as jmake
    from ray_tpu_torch.rl.ppo import make_ppo_update as tmake
    from ray_tpu_torch.rl.tree import adam

    jr, tr = _runner_pair("cartpole", num_envs=4, T=32)
    ro, tro = jr.sample(), tr.sample()
    np.testing.assert_array_equal(tro["actions"], ro["actions"])
    jp, jfwd, tp, tfwd, tinit = _policy_pair((4,), 2, seed=4)
    gae = compute_gae(ro, 0.99, 0.95)
    T, N = ro["rewards"].shape
    logits, _ = jfwd(jp, jnp.asarray(ro["obs"].reshape(T * N, 4)))
    logp = np.asarray(jax.nn.log_softmax(logits))[
        np.arange(T * N), ro["actions"].reshape(-1)]
    keep = ro["valids"].reshape(-1) > 0.5
    batch = {"obs": ro["obs"].reshape(T * N, 4)[keep],
             "actions": ro["actions"].reshape(-1)[keep],
             "logp": logp[keep].astype(np.float32),
             "advantages": gae["advantages"].reshape(-1)[keep],
             "returns": gae["returns"].reshape(-1)[keep]}
    lr, mb = 3e-4, 32
    jopt, topt = optax.adam(lr), adam(lr)
    jupd = jax.jit(jmake(jfwd, jopt, 0.2, 0.5, 0.01))
    tupd = tmake(tfwd, topt, 0.2, 0.5, 0.01)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(0)
    n, updates = len(batch["actions"]), 0
    for _ in range(2):
        perm = rng.permutation(n)
        for start in range(0, n - mb + 1, mb):
            mbatch = {k: v[perm[start:start + mb]] for k, v in batch.items()}
            jp, js, jaux = jupd(jp, js, jax.tree.map(jnp.asarray, mbatch))
            tp, ts, taux = tupd(tp, ts, _t(mbatch))
            np.testing.assert_allclose(float(taux["total_loss"]),
                                       float(jaux["total_loss"]), rtol=1e-4)
            updates += 1
    assert updates >= 4
    _assert_params(tp, jp, tinit, atol=3 * lr * updates)
