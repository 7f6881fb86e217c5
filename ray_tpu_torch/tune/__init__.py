"""ray_tpu_torch.tune: hyperparameter optimization (port of
``ray_tpu.tune``; reference: Ray Tune)."""

from ray_tpu_torch.train.session import report, get_checkpoint  # noqa: F401  (tune.report == train.report)
from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (  # noqa: F401
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tpe import TPESearcher  # noqa: F401
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner  # noqa: F401
