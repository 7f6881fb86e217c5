"""Checkpoints: directory handles + model state IO (port of
``ray_tpu/train/checkpoint.py``).

``Checkpoint`` is a directory handle, as in the JAX package and the
reference's ``ray.train.Checkpoint``; ``save_pytree`` writes ``state/``
and ``metadata.json`` (``{"step": ..., **extra}``) into it. Orbax's
on-disk format is not carried. The payload layer here:

* a tree of plain tensors (the params and AdamW state of a single-card
  step) goes through ``torch.save`` as one list of ``(key path, leaf)``
  pairs in ``state/tree.pt``, each card tensor staged to the host;
* a tree holding DTensors (a mesh step's) goes through
  ``torch.distributed.checkpoint``: every rank writes its own shards into
  ``state/`` (collective: every rank of the default group calls it), and
  the non-tensor leaves (the optimizer's step count) go to
  ``state/objects.pt``.

``restore_pytree(ckpt, target)`` lands each leaf on the target leaf's
device, dtype and placements. Without a target a plain checkpoint comes
back as nested dicts (a NamedTuple's fields by name); a sharded one needs
its target.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch

TREE_FILE = "tree.pt"
OBJECTS_FILE = "objects.pt"
DCP_METADATA = ".metadata"

KeyPath = Tuple[Any, ...]


class Checkpoint:
    """A handle to a checkpoint directory."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


# ------------------------------------------------------------- key paths

def _is_dtensor(t) -> bool:
    return isinstance(t, torch.Tensor) and hasattr(t, "device_mesh")


def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) pairs of a container (dicts by sorted key, NamedTuples
    by field name, lists and tuples by index), or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix: KeyPath = ()) -> List[Tuple[KeyPath, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for k, v in kids for item in _flatten(v, prefix + (k,))]


def _rebuild(tree, fn, prefix: KeyPath = ()):
    """``tree`` with each leaf replaced by ``fn(key path, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [_rebuild(v, fn, prefix + (k,)) for k, v in kids]
    if isinstance(tree, dict):
        return {k: v for (k, _), v in zip(kids, vals)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _unflatten(pairs: List[Tuple[KeyPath, Any]]):
    """Nested dicts (lists where every key of a level is an index) from
    ``(key path, leaf)`` pairs."""
    if len(pairs) == 1 and pairs[0][0] == ():
        return pairs[0][1]
    groups: Dict[Any, list] = {}
    for path, leaf in pairs:
        groups.setdefault(path[0], []).append((path[1:], leaf))
    out = {k: _unflatten(v) for k, v in groups.items()}
    if all(isinstance(k, int) for k in out):
        return [out[k] for k in sorted(out)]
    return out


def _key(path: KeyPath) -> str:
    return "/".join(str(k) for k in path)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


# ---------------------------------------------------------------- save

def save_pytree(path: str, tree: Any, extra_metadata: Optional[Dict] = None,
                step: int = 0) -> Checkpoint:
    """Save a tree of tensors (plain, or DTensors: then every rank of the
    default process group must call this) into ``path``; an existing
    ``state/`` is replaced."""
    path = os.path.abspath(path)
    state = os.path.join(path, "state")
    leaves = _flatten(tree)
    sharded = any(_is_dtensor(v) for _, v in leaves)
    if sharded:
        _save_sharded(state, leaves)
    else:
        if os.path.exists(state):
            shutil.rmtree(state)
        os.makedirs(state)
        torch.save([(p, v.detach().cpu() if isinstance(v, torch.Tensor)
                     else v) for p, v in leaves],
                   os.path.join(state, TREE_FILE))
    if not sharded or _rank() == 0:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump({"step": step, **(extra_metadata or {})}, f)
    return Checkpoint(path)


def _save_sharded(state: str, leaves) -> None:
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    if _rank() == 0:
        if os.path.exists(state):
            shutil.rmtree(state)
        os.makedirs(state)
    dist.barrier()
    dcp.save({_key(p): v for p, v in leaves if isinstance(v, torch.Tensor)},
             checkpoint_id=state)
    if _rank() == 0:
        torch.save([(p, v) for p, v in leaves
                     if not isinstance(v, torch.Tensor)],
                   os.path.join(state, OBJECTS_FILE))
    dist.barrier()


# ------------------------------------------------------------- restore

def _land(value, like, path: KeyPath):
    """``value`` on ``like``'s device and dtype (a fresh tensor), or
    ``value`` itself for a non-tensor leaf."""
    if not isinstance(like, torch.Tensor):
        return value
    if tuple(value.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {_key(path)!r} has shape "
                         f"{tuple(value.shape)}, the target "
                         f"{tuple(like.shape)}")
    return value.to(device=like.device, dtype=like.dtype, copy=True)


def restore_pytree(checkpoint: Checkpoint, target: Any = None
                   ) -> Tuple[Any, Dict]:
    """Restore a tree; ``target`` (a tree of tensors or DTensors) gives
    each leaf its device, dtype and placements."""
    state = os.path.join(checkpoint.path, "state")
    if os.path.exists(os.path.join(state, DCP_METADATA)):
        if target is None:
            raise ValueError("a sharded checkpoint restores onto a target "
                             "tree with the placements to land on")
        tree = _restore_sharded(state, target)
    else:
        pairs = torch.load(os.path.join(state, TREE_FILE),
                           map_location="cpu", mmap=True, weights_only=True)
        if target is None:
            tree = _unflatten([(tuple(p), v) for p, v in pairs])
        else:
            saved = {tuple(p): v for p, v in pairs}
            tree = _rebuild(target, lambda p, t: _land(saved[p], t, p))
    meta_path = os.path.join(checkpoint.path, "metadata.json")
    metadata: Dict = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return tree, metadata


def _restore_sharded(state: str, target):
    import torch.distributed.checkpoint as dcp

    fresh = {_key(p): torch.empty_like(t) for p, t in _flatten(target)
             if isinstance(t, torch.Tensor)}
    dcp.load(fresh, checkpoint_id=state)
    objects = {tuple(p): v for p, v in torch.load(
        os.path.join(state, OBJECTS_FILE), weights_only=True)}
    return _rebuild(target, lambda p, t: fresh[_key(p)]
                    if isinstance(t, torch.Tensor) else objects[p])


def temp_checkpoint_dir() -> str:
    return tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
