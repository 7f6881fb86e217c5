"""Multi-host gangs: not ported yet (ROADMAP.md queue 1, item 4).

``ray_tpu/core/multihost.py``'s ``HostGroup`` (one worker actor per host of
a sub-slice reservation, epochs, barriers) and the controller's gang
registry come with the train plane; until then the name raises.
"""

from __future__ import annotations

from ray_tpu_torch.core.errors import not_ported


class HostGroup:
    def __init__(self, *args, **kwargs):
        raise not_ported("HostGroup", "item 4, HostGroup and the gang "
                         "registry")
