"""GPU leases name their cards (``ray_tpu_torch/core/node.py``): a node
that declares ``GPU: 2`` (more than this machine has, so its indices reach
the environment unchanged) hands each whole-card lease a card of its own,
packs fractional leases onto one card, leases a freed card again, reuses a
pooled GPU task worker only for a lease on the same card, and starts every
GPU worker with ``CUDA_VISIBLE_DEVICES`` narrowed to its cards; CPU workers
still see it empty. A two-worker ``TorchTrainer`` gang holds two cards."""

import os
import time

import pytest

import ray_tpu_torch as rt


@pytest.fixture(scope="module")
def gpu2():
    saved = os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    rt.init(num_cpus=4, resources={"GPU": 2})
    yield
    rt.shutdown()
    if saved is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = saved


@rt.remote
class Holder:
    def cards(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
def seen():
    return os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()


def _gpu_free(want: float, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while rt.available_resources().get("GPU", 0.0) != want:
        assert time.monotonic() < deadline, rt.available_resources()
        time.sleep(0.1)


def _kill(*actors) -> None:
    for a in actors:
        rt.kill(a)
    _gpu_free(2.0)


def test_two_one_card_actors_get_different_cards(gpu2):
    a, b = (Holder.options(num_gpus=1).remote() for _ in range(2))
    try:
        got = rt.get([a.cards.remote(), b.cards.remote()], timeout=60)
        assert sorted(got) == ["0", "1"]
    finally:
        _kill(a, b)


def test_fractional_leases_share_one_card(gpu2):
    halves = [Holder.options(num_gpus=0.5).remote() for _ in range(2)]
    whole = Holder.options(num_gpus=1).remote()
    try:
        got = rt.get([h.cards.remote() for h in halves], timeout=60)
        assert got[0] == got[1] and got[0] in ("0", "1")
        # The halves packed onto one card, so a whole card is still free.
        other = rt.get(whole.cards.remote(), timeout=60)
        assert {other, got[0]} == {"0", "1"}
    finally:
        _kill(*halves, whole)


def test_a_freed_card_is_leased_again(gpu2):
    a, b = (Holder.options(num_gpus=1).remote() for _ in range(2))
    try:
        first = dict(zip("ab", rt.get([a.cards.remote(), b.cards.remote()],
                                      timeout=60)))
        rt.kill(a)
        _gpu_free(1.0)
        c = Holder.options(num_gpus=1).remote()
        assert rt.get(c.cards.remote(), timeout=60) == first["a"]
    finally:
        _kill(b, c)


def test_pooled_gpu_task_workers_keep_their_card(gpu2):
    card, pid = rt.get(seen.options(num_gpus=1).remote(), timeout=60)
    assert card == "0"
    assert rt.get(seen.options(num_gpus=1).remote(), timeout=60) == (
        card, pid)  # the pooled worker on card 0, reused
    a = Holder.options(num_gpus=1).remote()
    try:
        assert rt.get(a.cards.remote(), timeout=60) == "0"
        card2, pid2 = rt.get(seen.options(num_gpus=1).remote(), timeout=60)
        assert card2 == "1" and pid2 != pid
    finally:
        _kill(a)


def test_cpu_workers_see_no_card(gpu2):
    got = rt.get([seen.remote() for _ in range(3)], timeout=60)
    assert {c for c, _ in got} == {""}
    a = Holder.remote()
    try:
        assert rt.get(a.cards.remote(), timeout=60) == ""
    finally:
        rt.kill(a)


def _cards_loop(config):
    import os

    from ray_tpu_torch.train import session

    rank = session.get_world_rank()
    with open(os.path.join(config["dir"], f"rank{rank}"), "w") as f:
        f.write(os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>"))
    session.report({"rank": rank})


def test_two_worker_gang_holds_two_cards(gpu2, tmp_path):
    from ray_tpu_torch import train

    trainer = train.TorchTrainer(
        _cards_loop, train_loop_config={"dir": str(tmp_path)},
        scaling_config=train.ScalingConfig(num_workers=2, use_gpu=True))
    result = trainer.fit()
    assert result.error is None, result.error
    cards = sorted((tmp_path / f"rank{r}").read_text() for r in (0, 1))
    assert cards == ["0", "1"]
    _gpu_free(2.0)
