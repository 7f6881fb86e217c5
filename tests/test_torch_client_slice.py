"""The slice against the JAX package on the CPU: on each package a two-node
cluster, a ``ClientServer``, a thin client, and an actor the client creates
on the node holding ``GPU: 1`` with a ``runtime_env`` (a marker variable,
a working_dir whose module the actor imports). The actor runs
``tiny_pair``'s tiny Llama (one numpy tree of weights, both packages)
through a prefill and greedy decode (``tests/torch_cluster_program.py``).

The logits compare at float32's tolerance of the port's decode parity
tests (rtol = atol = 1e-5, ``tests/test_torch_decode.py``) up to the first
token where the two sides' greedy picks differ, and the tokens under
``assert_greedy_agrees``' margin rule with its tolerance there (1e-4)."""

import numpy as np
import pytest

import torch_cluster_program as prog
from torch_parity import TINY, assert_greedy_agrees, tiny_pair

RUNS = ("ray_tpu", "ray_tpu_torch")
TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN_TOL = 1e-4
PROMPT = [5, 17, 3, 42, 8, 29, 11, 60, 2, 33, 19, 7]
NEW = 10


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    wd = tmp_path_factory.mktemp("slice_env")
    (wd / "slice_env_mod.py").write_text("VALUE = 'from-working-dir'\n")
    _jcfg, jp, _tcfg, _tp = tiny_pair("f32")
    params_np = jax.tree.map(np.asarray, jp)
    return {pkg: prog.client_slice(pkg, params_np, dict(TINY), PROMPT, NEW,
                                   str(wd))
            for pkg in RUNS}


@pytest.mark.parametrize("pkg", RUNS)
def test_actor_runs_where_and_how_the_client_asked(results, pkg):
    got = results[pkg]
    where = got["where"]
    assert got["client_class"] == "ClientActorHandle"
    assert where["node"] == got["model_node"]
    assert where["marker"] == pkg
    assert where["module"] == "from-working-dir"
    assert where["cwd"] == where["module_file"]


def test_logits_and_greedy_tokens_match_jax(results):
    want, got = results["ray_tpu"], results["ray_tpu_torch"]
    top2 = np.sort(want["logits"], axis=-1)[:, -2:]
    margins = (top2[:, 1] - top2[:, 0]).tolist()
    assert_greedy_agrees(got["tokens"], want["tokens"], margins, MARGIN_TOL)
    same = next((i for i, (a, b) in enumerate(zip(got["tokens"],
                                                  want["tokens"])) if a != b),
                NEW - 1)
    np.testing.assert_allclose(got["logits"][:same + 1],
                               want["logits"][:same + 1], **TOL)
    assert got["logits"].shape == (NEW, TINY["vocab_size"])
