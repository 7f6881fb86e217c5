"""The state CLI (``python -m ray_tpu``'s counterpart): not ported yet
(ROADMAP.md queue 1, item 4)."""

import sys

from ray_tpu_torch.core.errors import not_ported

if __name__ == "__main__":
    print(not_ported("the CLI (python -m ray_tpu_torch)",
                     "item 4, the CLI, dashboard and doctor"),
          file=sys.stderr)
    sys.exit(2)
