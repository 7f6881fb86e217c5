"""One user program for the pipeline plane, run on ``ray_tpu`` and then on
``ray_tpu_torch`` by ``tests/test_torch_pipeline_plane.py``.

Every function takes the package's name and imports it, so the same code
drives both planes (the JAX package's stage actors on JAX arrays, the
port's on CPU tensors). Weights arrive as numpy arrays (the JAX package's
``init_params`` at key 0, as the reference tests use) and microbatches as
``microbatches`` makes them, so both runs start from the same state. This
module imports neither package, nor JAX, nor torch at import.
"""

from __future__ import annotations

import importlib

# The reference's ``_tiny_cfg`` (``tests/test_pipeline_plane.py``): bf16
# compute over fp32 masters, the packages' default dtype.
TINY = dict(vocab_size=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
            mlp_dim=64, max_seq_len=64)


def config(pkg: str):
    return importlib.import_module(f"{pkg}.models.llama").LlamaConfig(**TINY)


def params(pkg: str, weights, cfg):
    """The package's fp32 master params from the numpy ``weights``."""
    if pkg == "ray_tpu":
        import jax
        import jax.numpy as jnp

        return jax.tree.map(jnp.asarray, weights)
    import torch

    llama = importlib.import_module(f"{pkg}.models.llama")
    return llama.params_from_numpy(weights, cfg, device="cpu",
                                   dtype=torch.float32)


def plane_kw(pkg: str) -> dict:
    """What the port's plane takes beyond the JAX one's arguments: the CPU
    (the card is its default)."""
    return {} if pkg == "ray_tpu" else {"device": "cpu"}


def two_stage_curve(pkg: str, weights, steps, name: str = "parity-pipe"
                    ) -> dict:
    """Two stages, window 2, one ``train_step`` per entry of ``steps``:
    the losses, the ledger after the run, ``stop()``'s report and the
    controller's record afterwards."""
    plane_mod = importlib.import_module(f"{pkg}.train.pipeline_plane")
    cfg = config(pkg)
    plane = plane_mod.PipelinePlane(
        cfg, params(pkg, weights, cfg), n_stages=2, n_microbatches=4,
        lr=1e-2, window=2, name=name, **plane_kw(pkg)).start()
    try:
        losses = plane.run(steps)
        st = plane.stats()
    finally:
        report = plane.stop()
    return {"losses": losses, "ledger_refs": st["ledger_refs"],
            "inflight": st["inflight_microbatches"], "step": st["step"],
            "report": report, "record_after": plane.registry_state()}
