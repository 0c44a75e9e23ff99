"""serve.traffic: the SLO-aware traffic plane between proxies and
replicas.

Four pieces (see docs/architecture.md "Serve traffic plane"):

- ``RequestScheduler`` (scheduler.py) — per-deployment EDF dispatch
  over the batched task plane, per-tick accumulation like the rpc
  accumulator, bounded central queue with full in-flight knowledge.
- ``AdmissionController`` (admission.py) — depth- and predicted-delay
  based load shedding with Retry-After hints.
- queue-depth-driven replica autoscaling — the controller side
  (serve/controller.py) consumes the schedulers' stats pushes and
  drains replicas before stopping them.
- the LLM slot admitter (serve/llm.py) consumes the per-request
  deadline this package smuggles to replicas.

Activation is per deployment: set ``traffic_config`` on
``@serve.deployment`` and every proxy/handle route to it gains
admission control and SLO-ordered dispatch; deployments without one
keep the direct pow-2 path, bit-for-bit.
"""

from ray_tpu_torch.serve.traffic.admission import AdmissionController  # noqa: F401
from ray_tpu_torch.serve.traffic.config import (  # noqa: F401
    DEADLINE_KWARG,
    RequestShedError,
    TrafficConfig,
    get_request_deadline,
    set_request_deadline,
)
from ray_tpu_torch.serve.traffic.scheduler import RequestScheduler  # noqa: F401
