"""ray_tpu_torch.serve: model serving on replica actors.

Role-equivalent of ray: python/ray/serve/.  Controller reconciles
deployments to replica actors; handles route via power-of-two-choices;
an aiohttp proxy exposes HTTP.

The control plane (controller, proxies, handles) imports no torch: its
actors run on leases without a card.  The LLM engine and its deployment
(``serve/llm.py``, which imports torch) are imported from their module;
``weights.py`` imports nothing heavy at module level.
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    delete,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.deployment import (  # noqa: F401
    Application,
    AutoscalingConfig,
    Deployment,
    deployment,
)
from ray_tpu_torch.serve.handle import (  # noqa: F401
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve.asgi import ingress  # noqa: F401
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.grpc_proxy import start_grpc_proxy  # noqa: F401
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
)
from ray_tpu_torch.serve.schema import (  # noqa: F401
    deploy_config,
    deploy_config_file,
)

from ray_tpu_torch.serve.weights import (  # noqa: F401
    push_deployment_weights,
    push_weights,
)
