"""The device ingest prefetch and the ViT on a card.

Every test here is marked ``cuda`` and skips where no NVIDIA GPU is
present (the pinned ring, the side stream and its events exist only
there). The file imports no JAX, so it also runs on a machine with a card
and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_ingest_cuda.py

Batches compare exactly (a copy moves the same bits). The ViT on the card
against the ViT on the CPU in float32 with TF32 off: logits and each
gradient's max |error| within 1e-4 of the CPU's max |value| (the same
math, fp32 sums in another order)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from ray_tpu_torch.data import device_prefetch
from ray_tpu_torch.models import vit
from ray_tpu_torch.ops.optim import tree_leaves, tree_map
from ray_tpu_torch.parallel.train_step import value_and_grad


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned host buffers, CUDA streams "
                    "and events)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _host(n, shape=(8, 32, 32, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal(shape, dtype=np.float32),
             "labels": rng.integers(0, 1000, shape[0]),
             "scale": rng.standard_normal(shape[0])}       # float64
            for _ in range(n)]


@pytest.mark.cuda
def test_prefetch_pinned_ring_and_side_stream(cuda_device):
    host = _host(5) + _host(2, shape=(4, 32, 32, 3), seed=1)
    it = device_prefetch(iter(host), prefetch=2)
    got = []
    for b in it:
        # Read on the consumer's stream right away: the wait on the copy's
        # event orders this after the copy.
        got.append({k: v.clone() for k, v in b.items()})
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert g["images"].device.type == "cuda"
        assert g["labels"].dtype == torch.int64
        assert g["scale"].dtype == torch.float32
        np.testing.assert_array_equal(g["images"].cpu().numpy(), h["images"])
        np.testing.assert_array_equal(g["labels"].cpu().numpy(), h["labels"])
        np.testing.assert_array_equal(g["scale"].cpu().numpy(),
                                      h["scale"].astype(np.float32))
    s = it.stats()
    assert s["pinned"] and s["side_stream"]
    # Two sets of three buffers, then both sets again for the new shape.
    assert s["pinned_allocs"] == 2 * 3 + 2 * 3
    assert s["copy_bytes"][0] == 8 * 32 * 32 * 3 * 4 + 8 * 8 + 8 * 4
    assert all(ms > 0 for ms in s["copy_ms"])
    assert s["h2d_gb_per_s"] > 0


@pytest.mark.cuda
def test_prefetch_surfaces_the_host_error_on_card(cuda_device):
    def host():
        yield from _host(2)
        raise ValueError("host reader broke")

    seen = 0
    with pytest.raises(ValueError, match="host reader broke"):
        for _ in device_prefetch(host()):
            seen += 1
    assert seen == 2


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [None, 32])
def test_vit_on_card_matches_cpu(cuda_device, pad):
    cfg = replace(vit.PRESETS["debug"], dtype=torch.float32,
                  pad_tokens_to=pad)
    params = vit.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    params["head"].normal_(std=0.3, generator=torch.Generator().manual_seed(1))
    host = _host(1, shape=(4, 16, 16, 3))[0]
    batch = {"images": torch.from_numpy(host["images"]),
             "labels": torch.from_numpy(host["labels"] % 10)}

    def loss(p, b):
        return vit.loss_fn(p, b, cfg)[0]

    with torch.no_grad():
        want = vit.forward(params, batch["images"], cfg)
    want_loss, want_g = value_and_grad(loss, params, batch)
    params = tree_map(lambda t: t.to(cuda_device), params)
    batch = tree_map(lambda t: t.to(cuda_device), batch)
    with torch.no_grad():
        got = vit.forward(params, batch["images"], cfg)
    got_loss, got_g = value_and_grad(loss, params, batch)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for a, b in zip(tree_leaves(got_g), tree_leaves(want_g)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
