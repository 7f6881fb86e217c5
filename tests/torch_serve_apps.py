"""Deployment classes of ``tests/test_torch_serve_runtime.py`` that the
port's replica workers import: they import torch and the port, never JAX.
"""

from __future__ import annotations

import threading

from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.decode import DecodeEngine, LlamaDecodeDeployment


class NumpyWeightsLlama(LlamaDecodeDeployment):
    """``LlamaDecodeDeployment`` serving the weights it is bound with
    (numpy arrays of the JAX package's ``init_params``, carried across
    with ``llama.params_from_numpy``) instead of its seed's."""

    def __init__(self, np_params, config, slots: int, capacity: int,
                 device: str = "cpu"):
        super().__init__(config=config, slots=slots, capacity=capacity,
                         device=device)
        self.shutdown()
        params = llama.params_from_numpy(np_params, config, device=device)
        self.engine = DecodeEngine(params, config, slots=slots,
                                   capacity=capacity, device=device)
        self._thread = threading.Thread(target=self.engine.serve_forever,
                                        name="decode-loop", daemon=True)
        self._thread.start()


class MeshEcho:
    """A plain deployment that takes the ``mesh_shape`` the controller
    binds into a mesh deployment's init kwargs, and echoes it."""

    def __init__(self, mesh_shape=None):
        self.mesh_shape = mesh_shape

    def __call__(self, payload):
        return {"mesh_shape": list(self.mesh_shape), "x": payload["x"]}
