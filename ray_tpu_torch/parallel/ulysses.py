"""Ulysses sequence parallelism: all-to-all head scattering (port of
``ray_tpu/parallel/ulysses.py``).

With the sequence sharded over the ``seq`` mesh axis, two all-to-alls
turn sequence sharding into head sharding for the attention op and back:

    (B, S/p, H, D) --all_to_all--> (B, S, H/p, D)   heads scattered
        full-sequence attention on H/p local heads
    (B, S, H/p, D) --all_to_all--> (B, S/p, H, D)   back to seq-sharded

The all-to-alls are the functional collectives' differentiable
``all_to_all_single_autograd``. The local attention is the flash kernel on a
card with ``impl="flash"`` (the JAX rule: flash on the accelerator) and
the plain ``ops.attention.attention`` otherwise.
"""

from __future__ import annotations

from functools import partial

import torch

from ray_tpu_torch.parallel.mesh import axis_sizes
from ray_tpu_torch.parallel.sharding import shard_map


def _attention_local(q, k, v, causal: bool, q_offset: int, impl: str):
    if impl == "flash" and q.device.type == "cuda":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    from ray_tpu_torch.ops.attention import attention

    return attention(q, k, v, causal=causal, q_offset=q_offset)


def _all_to_all(x: torch.Tensor, group, p: int, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """The tiled ``lax.all_to_all``: chunk j of ``split_axis`` goes to rank
    j, and the chunks received are concatenated on ``concat_axis`` in rank
    order."""
    from torch.distributed import _functional_collectives as funcol

    send = torch.stack(x.chunk(p, dim=split_axis))
    recv = funcol.wait_tensor(
        funcol.all_to_all_single_autograd(send, None, None, group))
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _ulysses_local(q, k, v, group, p: int, causal: bool, impl: str):
    a2a = partial(_all_to_all, group=group, p=p)
    qg, kg, vg = (a2a(t, split_axis=2, concat_axis=1) for t in (q, k, v))
    out = _attention_local(qg, kg, vg, causal, 0, impl)
    return a2a(out, split_axis=1, concat_axis=2)


def ulysses_attention(q, k, v, mesh, seq_axis: str = "seq",
                      causal: bool = True, impl: str = "flash"):
    """Exact attention over (B, S, H, D) tensors whose sequence is sharded
    over ``seq_axis`` (DTensors on ``mesh``, or plain tensors holding the
    full value on every rank), by head scattering."""
    p = axis_sizes(mesh).get(seq_axis, 1)
    spec = (None, seq_axis)
    if p == 1:
        local = partial(_attention_local, causal=causal, q_offset=0,
                        impl=impl)
        if not hasattr(q, "device_mesh"):
            return local(q, k, v)
        return shard_map(local, mesh, (spec, spec, spec), spec)(q, k, v)
    n_heads, n_kv = q.shape[2], k.shape[2]
    if n_heads % p or n_kv % p:
        raise ValueError(
            f"ulysses needs heads divisible by the seq axis: "
            f"{n_heads}/{n_kv} heads over {p} shards")
    local = partial(_ulysses_local, group=mesh.get_group(seq_axis), p=p,
                    causal=causal, impl=impl)
    return shard_map(local, mesh, (spec, spec, spec), spec)(q, k, v)
