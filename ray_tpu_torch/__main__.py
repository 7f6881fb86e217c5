import sys

from ray_tpu_torch.scripts import main

if __name__ == "__main__":
    sys.exit(main())
