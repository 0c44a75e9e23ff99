"""ray_tpu_torch.tune: experiment execution and hyperparameter search
(port of ``ray_tpu/tune/``; JAX-free there, copied with the runtime and
Train seams changed).

Role-equivalent of ray: python/ray/tune/.  Trials are single-actor
training loops sharing the Train session API (report/get_checkpoint);
Tuner resolves a param space into trials, runs them through the
TuneController with an optional scheduler (ASHA), and returns a
ResultGrid.
"""

from ray_tpu_torch.train.session import get_checkpoint, report  # noqa: F401
from ray_tpu_torch.tune.schedulers import (
    HyperBandForBOHB,  # noqa: F401
    ASHAScheduler,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator,
    Searcher,
    TPESearcher,
    TuneBOHB,
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.tuner import (  # noqa: F401
    ResultGrid,
    TuneConfig,
    Tuner,
    with_resources,
)
