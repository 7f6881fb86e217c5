"""The fixtures of ``tests/conftest.py`` for the port: the same names
(``ray_start_regular``, ``ray_start_cluster``) over ``ray_tpu_torch``, so
a reference case carried onto the port keeps its signature. A test file
imports them, and its module-level names take the place of the
conftest's for that file."""

import pytest


@pytest.fixture
def ray_start_regular():
    import ray_tpu_torch

    core = ray_tpu_torch.init(num_cpus=4)
    yield core
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=False)
    yield cluster
    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    cluster.shutdown()
