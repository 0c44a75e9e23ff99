"""The port's Tune library on its runtime: the cases that restart trials or
queue many of them (slow).

One cluster for the module, ``init(num_cpus=4, num_gpus=1)``: one GPU is
declared and none exists, so ``{"GPU": 1}`` trials queue on the one card
through the lease, as they do on the card's machine.  Trainables travel
by value.
"""

import os
import sys
import time

import pytest

import ray_tpu_torch as rt
import test_torch_tune as base
from ray_tpu.tune import schedulers as ref_schedulers
from ray_tpu_torch import train, tune
from test_torch_runtime import runtime_defaults
from test_torch_tune import _synthetic_loss

pytestmark = pytest.mark.slow

QUEUE_LRS = [3e-4, 1e-3, 3e-3, 1e-2, 2e-3, 5e-4]
QUEUE_ASHA = dict(max_t=6, grace_period=2, reduction_factor=2)


@pytest.fixture(scope="module")
def cluster():
    with runtime_defaults():
        rt.init(num_cpus=4, num_gpus=1, log_to_driver=False)
        try:
            with base._functions_by_value(sys.modules[__name__]), base._functions_by_value(base):
                yield
        finally:
            rt.shutdown()


def _queued_trainable(config):
    from ray_tpu_torch import tune as port_tune

    t_loop = time.time()
    for i in range(QUEUE_ASHA["max_t"]):
        port_tune.report({"loss": _synthetic_loss(config["lr"], i), "lr": config["lr"], "loop_entry": t_loop,
                          "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid()})
        time.sleep(0.05)


def _crashing_trainable(config):
    """Counts to 6 with a checkpoint a step; the first attempt kills its
    own process once the report of step 3 returns (the driver asks for it
    only after it has received step 2's, so step 3's may be lost)."""
    from ray_tpu_torch import train as tr

    ck = tr.get_checkpoint()
    start = 0 if ck is None else ck.to_dict()["it"] + 1
    marker = os.path.join(config["dir"], "crashed")
    for i in range(start, 6):
        tr.report({"it": i, "resumed": ck is not None, "pid": os.getpid()},
                  checkpoint=tr.Checkpoint.from_dict({"it": i}))
        if i == 3 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)


@pytest.mark.usefixtures("cluster")
class TestOnOneCard:
    def test_gpu_trials_queue_on_one_card(self, tmp_path):
        """Six {"GPU": 1} trials under ASHA on one declared card run one at
        a time: each is bound card 0; a trial's loop starts after the trial
        before it last reported (a stopped trial's card came back before the
        next lease); each ran as many iterations as the reference's ASHA
        decides on the same results."""
        grid = tune.Tuner(
            tune.with_resources(_queued_trainable, {"GPU": 1}),
            param_space={"lr": tune.grid_search(QUEUE_LRS)},
            tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=tune.ASHAScheduler(**QUEUE_ASHA)),
            run_config=train.RunConfig(name="queue", storage_path=str(tmp_path)),
        ).fit()
        assert not grid.errors and len(grid) == len(QUEUE_LRS)
        hists = [r.metrics_dataframe for r in grid]
        assert all(m["visible"] == "0" for h in hists for m in h)
        order = sorted(hists, key=lambda h: h[0]["loop_entry"])
        for prev, nxt in zip(order, order[1:]):
            assert nxt[0]["loop_entry"] > prev[-1]["_timestamp"], (prev[-1], nxt[0])
        ran = {h[0]["lr"]: len(h) for h in hists}
        replay = base._replayed_iterations(ref_schedulers.ASHAScheduler(metric="loss", mode="min", **QUEUE_ASHA),
                                           [(m["lr"], m) for h in hists for m in h])
        assert ran == replay
        assert min(ran.values()) < QUEUE_ASHA["max_t"], ran  # some trials were stopped (killed)

    @pytest.mark.parametrize("max_failures", [1, 0])
    def test_failure_config_restores_a_crashed_trial(self, tmp_path, max_failures):
        """A trial whose process dies mid-run is relaunched from the latest
        checkpoint the driver saw (FailureConfig(max_failures=1)) and counts
        on from there in a new process; with no failures allowed it ends in
        error."""
        grid = tune.Tuner(
            _crashing_trainable,
            param_space={"dir": str(tmp_path)},
            run_config=train.RunConfig(name="crash", storage_path=str(tmp_path),
                                       failure_config=train.FailureConfig(max_failures=max_failures)),
        ).fit()
        hist = grid[0].metrics_dataframe
        first = [m for m in hist if not m["resumed"]]
        assert [m["it"] for m in first] in ([0, 1, 2], [0, 1, 2, 3])
        if max_failures == 0:
            assert len(grid.errors) == 1 and len(hist) == len(first)
            return
        assert not grid.errors
        resumed = hist[len(first):]
        assert resumed and all(m["resumed"] for m in resumed)
        assert [m["it"] for m in resumed] == list(range(first[-1]["it"] + 1, 6))
        assert {m["pid"] for m in resumed}.isdisjoint({m["pid"] for m in first})
        assert grid[0].checkpoint.to_dict()["it"] == 5
