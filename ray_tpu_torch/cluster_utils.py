"""Several nodes on one machine: not ported yet (ROADMAP.md queue 1,
item 4).

``ray_tpu/cluster_utils.py``'s ``Cluster`` starts a controller and
several node supervisors in one process, the fixture of cross-node tests;
until it is ported the name raises.
"""

from __future__ import annotations

from ray_tpu_torch.core.errors import not_ported


class Cluster:
    def __init__(self, *args, **kwargs):
        raise not_ported("cluster_utils.Cluster",
                         "item 4, cluster_utils.Cluster")
