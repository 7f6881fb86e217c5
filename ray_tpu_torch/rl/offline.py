"""Offline-RL data pipeline: experience <-> the Data engine.

Analogue of the reference's ``rllib/offline/`` (output writers recording
env-runner experience, input readers feeding learners from logged data):
transitions live in a :class:`ray_tpu_torch.data.Dataset` with the canonical
columns ``obs / actions / rewards / next_obs / terminateds``, so they
round-trip through every Data sink/source (parquet on any pyarrow fs,
numpy, arrow) and feed any off-policy learner through a ReplayBuffer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

TRANSITION_COLUMNS = ("obs", "actions", "rewards", "next_obs",
                      "terminateds")


def rollouts_to_dataset(algo, num_rollouts: int = 4,
                        num_blocks: int = 8):
    """Record full transitions from an algorithm's live EnvRunners into a
    Dataset (reference: offline output writers). Works with any algo that
    exposes ``runners`` sampling (T, N)-shaped rollouts."""
    import ray_tpu_torch
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.rl.common import rollout_to_transitions

    cols: Dict[str, list] = {c: [] for c in TRANSITION_COLUMNS}
    for _ in range(num_rollouts):
        for ro in ray_tpu_torch.get([r.sample.remote() for r in algo.runners]):
            done_key = ("terminateds" if "terminateds" in ro else "dones")
            batch = rollout_to_transitions(ro, done_key=done_key)
            if not len(batch["rewards"]):
                continue
            for c in TRANSITION_COLUMNS:
                cols[c].append(np.asarray(batch[c]))
    if not cols["rewards"]:
        raise ValueError("no transitions collected")
    arrays = {c: np.concatenate(v) for c, v in cols.items()}
    # Flatten n-dim obs for tabular storage; shape restores on load via
    # the tensor-shape metadata the Data engine keeps on arrow blocks.
    return rdata.from_numpy(arrays, num_blocks=num_blocks)


def dataset_to_buffer(ds, capacity: Optional[int] = None, seed: int = 0):
    """Materialize a transitions Dataset into a ReplayBuffer an off-policy
    learner (DQN/SAC/CQL) samples from (reference: offline input
    readers feeding the replay path)."""
    from ray_tpu_torch.rl.replay import ReplayBuffer

    batches = list(ds.iter_batches(batch_size=4096))
    n = sum(len(b["rewards"]) for b in batches)
    buf = ReplayBuffer(capacity or max(1, n), seed=seed)
    for batch in batches:
        missing = [c for c in TRANSITION_COLUMNS if c not in batch]
        if missing:
            raise ValueError(f"dataset lacks transition columns {missing}")
        buf.add({c: np.asarray(batch[c]) for c in TRANSITION_COLUMNS})
    return buf


def save_transitions(ds, path: str) -> Any:
    """Persist a transitions Dataset as parquet (local path or any
    pyarrow-fs URI)."""
    return ds.write_parquet(path)


def load_transitions(paths):
    """Load a transitions Dataset written by :func:`save_transitions`."""
    from ray_tpu_torch import data as rdata

    return rdata.read_parquet(paths)
