"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The package mirrors ``ray_tpu``'s layout (``ops/``, ``models/``,
``serve/``, ``core/``) and imports ``torch``, ``numpy`` and the standard
library only. Plain tensor code is PyTorch; every TPU kernel on a ported
path is a kernel written by hand for ``sm_90a`` under ``ops/csrc/``, built
at first use into ``ray_tpu_torch/_build/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

The core API mirrors ``ray_tpu``'s (``init``, ``remote``, ``get``,
``put``, ``wait``, ``free``, ``kill``, ``get_actor``, placement groups):
tasks, actors and objects on the shared-memory store, with cards leased as
the ``GPU`` resource. The train and tune planes (``ray_tpu_torch.train``:
``TorchTrainer``, one ``torch.distributed`` group per gang;
``ray_tpu_torch.tune``: ``Tuner``) and the Dataset API
(``ray_tpu_torch.data``) run on it, and so does ``HostGroup``, a gang of
one actor per host of a reserved sub-slice (its members' process group
through the same ``torch.distributed`` bootstrap). ``cluster_utils``
runs several nodes in one process, ``init("ray-tpu://host:port")``
attaches a thin client to a ``client.ClientServer``, tasks and actors
take a ``runtime_env``, and ``job_submission`` runs driver scripts on the
cluster. Importing the package starts nothing; ``init()`` does.
"""

from ray_tpu_torch._version import version as __version__  # noqa: F401
from ray_tpu_torch.core.api import (  # noqa: F401
    available_resources,
    cluster_resources,
    free,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.core.errors import (  # noqa: F401
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    OutOfMemoryError,
    RayTpuError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch.core.runtime import ObjectRefGenerator  # noqa: F401
from ray_tpu_torch.core.placement import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroup,
    PlacementGroupSchedulingStrategy,
    SubSliceReservation,
    cluster_topology,
    placement_group,
    remove_placement_group,
    reserve_subslice,
)
from ray_tpu_torch.core.multihost import HostGroup  # noqa: F401
