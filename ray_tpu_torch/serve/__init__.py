"""ray_tpu_torch.serve: model serving on actors (copy of
``ray_tpu/serve/__init__.py``; reference: Ray Serve).

Deployments default to the colocated posture (every replica prefills and
decodes). Pass ``role="prefill"`` / ``role="decode"`` to
``serve.deployment`` to split the two phases onto separate fleets with KV
pages handed off over the object plane; the router splices the two halves.
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    delete,
    get_deployment_handle,
    http_addresses,
    proxy_status,
    run,
    shutdown,
    start_http,
    status,
    stop_http,
    timelines,
)
from ray_tpu_torch.serve.metrics import slo_summary  # noqa: F401
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.decode import (  # noqa: F401
    DecodeEngine,
    LlamaDecodeDeployment,
)
from ray_tpu_torch.serve.build import deploy_config  # noqa: F401
from ray_tpu_torch.serve.prefix_cache import (  # noqa: F401
    PrefixCache,
    candidate_hashes,
    prefix_hash,
)
from ray_tpu_torch.serve.deployment import (  # noqa: F401
    AutoscalingConfig,
    Deployment,
    DeploymentHandle,
    deployment,
)
from ray_tpu_torch.serve.replica import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
    request_deadline_s,
)
from ray_tpu_torch.core.errors import (  # noqa: F401 — request-lifecycle outcomes
    DeadlineExceededError,
    OverloadedError,
    RequestCancelledError,
)
