"""The user program of ``tests/test_torch_client_slice.py``: a tiny Llama
served by an actor that a thin client creates on a two-node cluster, run on
``ray_tpu`` and on ``ray_tpu_torch`` (the package name is an argument).

The module imports neither package at import time: the actor's worker
imports it to find ``TinyDecoder``."""

from __future__ import annotations

import importlib
import os

import numpy as np

CAPACITY = 32


class TinyDecoder:
    """One prompt through prefill and greedy decode on the CPU, float32,
    on weights handed over as a numpy tree (the JAX package's layout)."""

    def __init__(self, pkg: str, cfg_kw: dict, params_np: dict):
        self.pkg = pkg
        if pkg == "ray_tpu":
            import jax
            import jax.numpy as jnp

            from ray_tpu.models import llama

            self.cfg = llama.LlamaConfig(dtype=jnp.float32, **cfg_kw)
            self.params = jax.tree.map(jnp.asarray, params_np)
        else:
            import torch

            from ray_tpu_torch.models import llama

            torch.set_num_threads(1)
            self.cfg = llama.LlamaConfig(dtype=torch.float32, **cfg_kw)
            self.params = llama.params_from_numpy(params_np, self.cfg,
                                                  device="cpu")

    def where(self) -> dict:
        import slice_env_mod  # from the runtime_env's working_dir

        core = importlib.import_module(f"{self.pkg}.core.runtime")
        return {"node": core.get_core_worker().node_id.hex(),
                "pid": os.getpid(), "cwd": os.getcwd(),
                "marker": os.environ.get("SLICE_MARKER"),
                "module": slice_env_mod.VALUE,
                "module_file": os.path.dirname(slice_env_mod.__file__)}

    def generate(self, prompt, max_new: int) -> dict:
        """Greedy tokens and the fp32 logits behind each (prefill's last
        position, then each decode step's), as numpy."""
        dec = importlib.import_module(f"{self.pkg}.models.llama_decode")
        if self.pkg == "ray_tpu":
            import jax.numpy as jnp

            toks = jnp.asarray(np.asarray(prompt, np.int32)[None])
            cache = dec.init_cache(self.cfg, 1, CAPACITY)
            logits, cache = dec.prefill(self.params, toks, cache, self.cfg)
            step = lambda c, t: dec.decode_step(  # noqa: E731
                self.params, c, jnp.asarray([t], jnp.int32), self.cfg)
            host = lambda x: np.asarray(x[0], np.float32)  # noqa: E731
        else:
            import torch

            toks = torch.as_tensor(np.asarray(prompt, np.int64))[None]
            cache = dec.init_cache(self.cfg, 1, CAPACITY, device="cpu")
            logits, cache = dec.prefill(self.params, toks, cache, self.cfg)
            step = lambda c, t: dec.decode_step(  # noqa: E731
                self.params, c, torch.tensor([t], dtype=torch.int32),
                self.cfg)
            host = lambda x: x[0].float().numpy()  # noqa: E731
        out_logits, tokens = [], []
        for _ in range(max_new):
            row = host(logits)
            out_logits.append(row)
            tokens.append(int(np.argmax(row)))
            logits, cache = step(cache, tokens[-1])
        return {"tokens": tokens, "logits": np.stack(out_logits)}


def client_slice(pkg: str, params_np: dict, cfg_kw: dict, prompt,
                 max_new: int, working_dir: str) -> dict:
    """A two-node cluster (a CPU node and a node holding ``GPU: 1``), a
    ``ClientServer`` in this process and a thin client connected to it; the
    client creates ``TinyDecoder`` as a named actor holding the ``GPU``
    resource, with a ``runtime_env`` (a marker variable and a working_dir),
    then asks it for one generation. Everything is torn down before the
    return."""
    rt = importlib.import_module(pkg)
    cluster_utils = importlib.import_module(f"{pkg}.cluster_utils")
    client_mod = importlib.import_module(f"{pkg}.client")
    cluster = cluster_utils.Cluster(initialize_head=False)
    server = client = None
    try:
        cluster.add_node(num_cpus=2)
        model_node = cluster.add_node(num_cpus=2, resources={"GPU": 1})
        cluster.wait_for_nodes(30)
        rt.init(address=cluster.address)
        server = client_mod.ClientServer(host="127.0.0.1")
        client = rt.init(address=f"ray-tpu://{server.address[0]}:"
                                 f"{server.address[1]}")
        decoder = rt.remote(TinyDecoder).options(
            name="tiny-decoder", num_cpus=1, resources={"GPU": 1},
            runtime_env={"env_vars": {"SLICE_MARKER": pkg},
                         "working_dir": working_dir},
        ).remote(pkg, cfg_kw, params_np)
        out = rt.get(decoder.generate.remote(list(prompt), max_new),
                     timeout=180)
        out["where"] = rt.get(decoder.where.remote(), timeout=60)
        out["client_class"] = type(decoder).__name__
        out["model_node"] = model_node.node_id.hex()
        rt.kill(decoder)
        return out
    finally:
        if client is not None:
            client.disconnect()
        if server is not None:
            server.stop()
        if rt.is_initialized():
            rt.shutdown()
        cluster.shutdown()
