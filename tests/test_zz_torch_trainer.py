"""The port's Train library through a gang restart, on the CPU.

Marked slow: each test starts more than one gang (a worker that kills its
own process, then the restarted gang), each worker with a torch import of
its own, more than the port's tier-1 tests may spend.  Run with
``python -m pytest tests/test_zz_torch_trainer.py -m slow``.  The loop and
the cluster are ``tests/test_torch_trainer.py``'s.
"""

import os

import numpy as np
import pytest

import test_torch_trainer as base
from ray_tpu_torch import train
from ray_tpu_torch.train.backend_executor import TrainWorkerGroupError

pytestmark = pytest.mark.slow
STEPS, CKPT_AT, DIE_AFTER = 6, 2, 3


@pytest.fixture(scope="module")
def cluster():
    with base.port_cluster(base):
        yield


def _fit(tmp_path, name, max_failures, **kw):
    return train.TorchTrainer(
        base.gpt2_loop,
        train_loop_config=base.loop_config(base.draw_params(), base.draw_tokens(), STEPS,
                                           ckpt_at=CKPT_AT, **kw),
        run_config=base.run_config(tmp_path, name,
                                   failure_config=train.FailureConfig(max_failures=max_failures)),
    ).fit()


@pytest.mark.usefixtures("cluster")
class TestGangRestart:
    def test_restart_resumes_on_the_same_losses(self, tmp_path):
        """The worker reports a checkpoint (model, AdamW state, step) after
        step 2 and kills its own process after step 3's report has reached
        the driver (step 4's may or may not).  The gang restarts from that
        checkpoint and resumes at step 3: every loss of the run, the
        resumed ones included, equals the uninterrupted run's bit for bit,
        and the run ends without an error."""
        straight = _fit(tmp_path, "straight", 0)
        assert straight.error is None
        want = {m["step"]: m["loss"] for m in straight.metrics_dataframe}
        assert sorted(want) == list(range(STEPS))

        result = _fit(tmp_path, "restarted", 1, die_after=DIE_AFTER)
        assert result.error is None
        assert os.path.exists(os.path.join(result.path, "killed"))
        steps = [m["step"] for m in result.metrics_dataframe]
        first, resumed = list(range(DIE_AFTER + 1)), list(range(CKPT_AT + 1, STEPS))
        assert steps in (first + resumed, first + [DIE_AFTER + 1] + resumed), result.metrics_dataframe
        for m in result.metrics_dataframe:
            assert m["loss"] == want[m["step"]], m
        assert result.metrics["step"] == STEPS - 1
        assert result.checkpoint.to_state_dict()["step"] == CKPT_AT
        np.testing.assert_array_less(result.metrics["loss"], result.metrics_dataframe[0]["loss"])

    def test_failure_budget_spent_returns_the_error(self, tmp_path):
        """With max_failures=0 the worker's death ends the run: fit()
        returns the gang error beside the checkpoint persisted before it."""
        result = _fit(tmp_path, "spent", 0, die_after=DIE_AFTER)
        assert isinstance(result.error, TrainWorkerGroupError)
        assert [m["step"] for m in result.metrics_dataframe] in (list(range(DIE_AFTER + 1)),
                                                                 list(range(DIE_AFTER + 2)))
        assert result.checkpoint.to_state_dict()["step"] == CKPT_AT
