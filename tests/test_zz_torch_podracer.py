"""The port's Podracer plane on its runtime, on the CPU: every test of
``tests/test_zz_podracer.py``, with the learner actor on ``device="cpu"``
(``PodracerConfig.learner_device``; the default, ``"cuda"``, leases a card
this box has not got).

Named past the tier-1 window (``test_zz_*``) and marked ``slow`` where a
cluster runs: env runners step CartPole (gymnasium) in their own
processes.  Pins: a seeded bit-reproducible rollout stream, the staleness
bound (no fragment older than K policy versions trains), a runner kill
mid-run recovering with zero learner-step failures, the learner's
checkpoint hooks, quantized weight fan-outs leaving replicas bit-identical,
and IMPALA with ``throughput_mode`` unset staying on the in-driver loop.
"""

import functools
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib.algorithm import build_module_config, probe_env_spaces
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.impala import IMPALAConfig, IMPALALearner, impala_batch_from_fragments
from ray_tpu_torch.rllib.podracer import (
    FragmentMeta,
    PodracerConfig,
    PodracerLearnerActor,
    PodracerRunner,
    StalenessHistogram,
)
from test_torch_runtime import runtime_defaults

OBS_DIM, NUM_ACTIONS = 4, 2  # CartPole-v1


# ---- pure unit tests (no cluster) -------------------------------------


class TestFragmentTypes:
    def test_meta_roundtrip(self):
        m = FragmentMeta(runner_index=3, seq=17, policy_version=5,
                         env_steps=64, suspect=True, incarnation=2)
        assert FragmentMeta.from_dict(m.to_dict()) == m

    def test_histogram(self):
        h = StalenessHistogram()
        for lag in (0, 0, 1, 3, 1, 0):
            h.add(lag)
        assert h.snapshot() == {0: 3, 1: 2, 3: 1}
        assert h.max_lag == 3 and h.total == 6
        h2 = StalenessHistogram()
        h2.restore(h.state())
        assert h2.snapshot() == h.snapshot()

    def test_histogram_empty(self):
        h = StalenessHistogram()
        assert h.max_lag == 0 and h.total == 0 and h.snapshot() == {}


class TestBatchAssembly:
    def test_fragments_stack_along_env_axis(self):
        rng = np.random.default_rng(0)
        T = 4

        def frag(B):
            return {
                "obs": rng.normal(size=(T, B, OBS_DIM)).astype(np.float32),
                "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
                "logp": rng.normal(size=(T, B)).astype(np.float32),
                "rewards": np.ones((T, B), np.float32),
                "dones": np.zeros((T, B), np.float32),
                "final_obs": rng.normal(size=(B, OBS_DIM)).astype(np.float32),
            }

        a, b = frag(2), frag(3)
        batch = impala_batch_from_fragments([a, b])
        assert batch["obs"].shape == (T, 5, OBS_DIM)
        assert batch["actions"].shape == (T, 5)
        assert batch["last_obs"].shape == (5, OBS_DIM)
        np.testing.assert_array_equal(batch["obs"][:, :2], a["obs"])
        np.testing.assert_array_equal(batch["obs"][:, 2:], b["obs"])
        np.testing.assert_array_equal(batch["last_obs"][2:], b["final_obs"])


# ---- cluster-backed tests ---------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    threads = torch.get_num_threads()
    with runtime_defaults():
        rt.init(num_cpus=4, log_to_driver=False)
        try:
            yield
        finally:
            rt.shutdown()
            cloudpickle.unregister_pickle_by_value(module)
            torch.set_num_threads(threads)


def _impala_config(num_runners=2, num_envs=2, frag_len=8, **training):
    return (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(
            num_env_runners=num_runners,
            num_envs_per_env_runner=num_envs,
            rollout_fragment_length=frag_len,
        )
        .training(**training)
        .learners(0, device="cpu")
    )


def _module_config(config):
    return build_module_config(
        config, probe_env_spaces(config.env, config.env_to_module)
    )


def _podracer_config(**kw):
    return PodracerConfig(learner_device="cpu", **kw)


def _make_podracer(config, pr_cfg, *, train=True, keep_refs=False, seed=0):
    mc = _module_config(config)
    group = EnvRunnerGroup(
        config.env, mc,
        num_runners=config.num_env_runners,
        num_envs_per_runner=config.num_envs_per_runner,
        seed=seed,
    )
    pr = PodracerRunner(
        group,
        functools.partial(IMPALALearner, config, mc),
        impala_batch_from_fragments,
        pr_cfg,
        train=train,
        keep_fragment_refs=keep_refs,
    )
    return group, pr


def _fake_frag(rng, T=4, B=2):
    return {
        "obs": rng.normal(size=(T, B, OBS_DIM)).astype(np.float32),
        "actions": rng.integers(0, NUM_ACTIONS, (T, B)).astype(np.int32),
        "logp": np.full((T, B), -0.69, np.float32),
        "rewards": np.ones((T, B), np.float32),
        "dones": np.zeros((T, B), np.float32),
        "final_obs": rng.normal(size=(B, OBS_DIM)).astype(np.float32),
        "episode_returns": np.asarray([], np.float64),
    }


def _meta(seq, version, suspect=False, env_steps=8):
    return {
        "runner_index": 0, "seq": seq, "policy_version": version,
        "env_steps": env_steps, "suspect": suspect, "incarnation": 0,
    }


def _leaves(state):
    """A state dict's tensors as numpy arrays, in its order."""
    return [v.numpy() for v in state.values()]


@pytest.mark.slow
class TestRolloutReproducibility:
    def test_seeded_stream_bitwise_identical(self, cluster):
        """Two fleets from the same seed must emit bit-identical
        fragment payloads per (runner, seq) — the podracer plane adds
        concurrency, not nondeterminism, to the rollout stream."""
        config = _impala_config(num_runners=2, num_envs=2, frag_len=8)
        pr_cfg = _podracer_config(rollout_fragment_length=8)
        streams = []
        for _ in range(2):
            group, pr = _make_podracer(
                config, pr_cfg, train=False, keep_refs=True, seed=7,
            )
            try:
                pr.run(min_fragments=6)
                stream = {}
                for idx, meta, ref in pr.fragment_log:
                    stream[(idx, meta["seq"])] = rt.get(ref, timeout=60.0)
                streams.append(stream)
            finally:
                pr.stop()
                group.stop()
        common = sorted(set(streams[0]) & set(streams[1]))
        # every runner contributes at least one comparable fragment
        assert {idx for idx, _ in common} == {0, 1}, common
        assert len(common) >= 4
        for key in common:
            a, b = streams[0][key], streams[1][key]
            assert sorted(a) == sorted(b)
            for field in a:
                np.testing.assert_array_equal(
                    a[field], b[field], err_msg=f"{key}:{field}"
                )


@pytest.mark.slow
class TestStalenessBounds:
    def test_stale_fragment_never_trains(self, cluster):
        """Fragments older than K policy versions are dropped at ingest
        AND at batch-assembly time; the staleness histogram over trained
        fragments never exceeds K."""
        config = _impala_config(num_runners=1)
        mc = _module_config(config)
        K = 1
        learner = PodracerLearnerActor.remote(
            functools.partial(IMPALALearner, config, mc),
            impala_batch_from_fragments, 2, K, True,
        )
        try:
            rng = np.random.default_rng(0)
            # fragment A queues alone (no batch yet)
            res = rt.get(learner.ingest.remote(_fake_frag(rng), _meta(0, 0)), timeout=120.0)
            assert res["train"] is None
            # advance the policy WITHOUT consuming A (a weight restore /
            # external push bumps the version): A is now lag 2 > K=1
            w = rt.get(learner.get_weights.remote(), timeout=60.0)
            for _ in range(2):
                rt.get(learner.set_weights.remote(w, True), timeout=60.0)
            # assembly-time drop: fragment B is fresh, but its only
            # partner A went stale while QUEUED — the recheck must drop
            # A instead of training it, and no update happens
            res = rt.get(learner.ingest.remote(_fake_frag(rng), _meta(1, 2)), timeout=60.0)
            assert res["train"] is None
            stats = rt.get(learner.stats.remote(), timeout=60.0)
            assert stats["policy_version"] == 2
            assert stats["dropped_stale"] == 1  # A, at assembly time
            assert stats["queue_depth"] == 1  # B, put back
            # ingest-time drop: a fragment arriving already past the bound
            res = rt.get(learner.ingest.remote(_fake_frag(rng), _meta(2, 0)), timeout=60.0)
            assert res["train"] is None
            stats = rt.get(learner.stats.remote(), timeout=60.0)
            assert stats["dropped_stale"] == 2
            # a fresh partner completes the batch: only fresh trains
            res = rt.get(learner.ingest.remote(_fake_frag(rng), _meta(3, 2)), timeout=60.0)
            assert res["train"] is not None
            stats = rt.get(learner.stats.remote(), timeout=60.0)
            assert stats["policy_version"] == 3
            assert stats["queue_depth"] == 0
            assert stats["max_trained_lag"] <= K
            assert sum(stats["staleness_hist"].values()) == 2
        finally:
            rt.kill(learner)

    def test_suspect_fragments_deprioritized(self, cluster):
        """SUSPECT-runner fragments land in the low-priority queue and
        are shed FIRST under backpressure."""
        config = _impala_config(num_runners=1)
        mc = _module_config(config)
        learner = PodracerLearnerActor.remote(
            functools.partial(IMPALALearner, config, mc),
            impala_batch_from_fragments, 2, 4, False, 2,
        )
        try:
            rng = np.random.default_rng(1)
            rt.get(learner.ingest.remote(_fake_frag(rng), _meta(0, 0, suspect=True)), timeout=120.0)
            rt.get(learner.ingest.remote(_fake_frag(rng), _meta(1, 0)), timeout=60.0)
            stats = rt.get(learner.stats.remote(), timeout=60.0)
            assert stats["queue_depth"] == 2
            assert stats["suspect_queue_depth"] == 1
            # cap is 2: the third fragment must shed the SUSPECT one,
            # not a fresh-node one
            rt.get(learner.ingest.remote(_fake_frag(rng), _meta(2, 0)), timeout=60.0)
            stats = rt.get(learner.stats.remote(), timeout=60.0)
            assert stats["queue_depth"] == 2
            assert stats["suspect_queue_depth"] == 0
            assert stats["dropped_overflow"] == 1
        finally:
            rt.kill(learner)


@pytest.mark.slow
class TestFailureRecovery:
    def test_runner_kill_mid_run_zero_learner_failures(self, cluster):
        """A seeded env-runner kill mid-run costs fragments, never
        learner steps: the dead runner is replaced, the collective group
        re-formed, and every requested update completes."""
        config = _impala_config(num_runners=2, num_envs=2, frag_len=8)
        pr_cfg = _podracer_config(
            rollout_fragment_length=8, batch_fragments=2,
            max_policy_lag=4, weight_sync_period=1,
        )
        group, pr = _make_podracer(config, pr_cfg, seed=3)
        try:
            out = pr.run(min_updates=2)
            assert out["updates"] == 2
            rt.kill(group.runners[0])
            # every requested update completes (zero learner-step
            # failures); the learner drains the surviving runner's
            # fragments while the dead one is noticed and replaced
            total = 0
            for _ in range(10):
                out = pr.run(min_updates=1)
                total += out["updates"]
                if out["replaced_runners"] >= 1:
                    break
            assert out["replaced_runners"] >= 1
            assert total >= 1
            stats = pr.learner_stats()
            assert stats["policy_version"] >= 2 + total
            assert stats["max_trained_lag"] <= pr_cfg.max_policy_lag
            # the replacement is live and carries the learner's weights
            w_learner = pr.get_weights()
            w_new = rt.get(group.runners[0].get_weights.remote(), timeout=60.0)
            for a, b in zip(_leaves(w_learner), _leaves(w_new)):
                assert a.shape == b.shape
        finally:
            pr.stop()
            group.stop()

    def test_learner_checkpoint_restore_roundtrip(self, cluster):
        """The drain plane's checkpoint hooks carry the full learner
        state: params, optimizer state and the policy-version counter
        survive a migration; queued fragments (droppable) do not."""
        config = _impala_config(num_runners=1)
        mc = _module_config(config)
        factory = functools.partial(IMPALALearner, config, mc)
        learner = PodracerLearnerActor.remote(
            factory, impala_batch_from_fragments, 2, 4, True,
        )
        try:
            rng = np.random.default_rng(2)
            for seq in range(4):
                rt.get(learner.ingest.remote(_fake_frag(rng), _meta(seq, 0)), timeout=120.0)
            snap = rt.get(learner._apply(lambda inst: inst.__rt_checkpoint__()), timeout=60.0)
            assert snap["policy_version"] == 2
            w_before = rt.get(learner.get_weights.remote(), timeout=60.0)
        finally:
            rt.kill(learner)
        fresh = PodracerLearnerActor.remote(
            factory, impala_batch_from_fragments, 2, 4, True,
        )
        try:
            rt.get(fresh._apply(lambda inst, s: inst.__rt_restore__(s), snap), timeout=120.0)
            stats = rt.get(fresh.stats.remote(), timeout=60.0)
            assert stats["policy_version"] == 2
            assert stats["trained_fragments"] == 4
            assert stats["queue_depth"] == 0  # droppable: not migrated
            w_after = rt.get(fresh.get_weights.remote(), timeout=60.0)
            for a, b in zip(_leaves(w_before), _leaves(w_after)):
                np.testing.assert_array_equal(a, b)
        finally:
            rt.kill(fresh)


@pytest.mark.slow
class TestQuantizedFanout:
    def test_int8_fanout_replicas_bit_identical(self, cluster):
        """After an int8 weight broadcast, the learner and every runner
        hold byte-identical params (the root adopts its own decode), and
        the decode differs from the pre-broadcast fp32 weights (the wire
        really was quantized)."""
        config = _impala_config(num_runners=2)
        pr_cfg = _podracer_config(weight_wire_dtype="int8")
        group, pr = _make_podracer(config, pr_cfg, train=False)
        try:
            before = _leaves(pr.get_weights())
            ms = pr.broadcast_weights("int8")
            assert ms > 0.0
            w_learner = _leaves(pr.get_weights())
            runner_ws = [
                _leaves(rt.get(r.get_weights.remote(), timeout=60.0))
                for r in group.runners
            ]
            for w in runner_ws:
                for a, b in zip(w_learner, w):
                    np.testing.assert_array_equal(a, b)
            assert any(
                not np.array_equal(a, b)
                for a, b in zip(before, w_learner)
            ), "int8 wire produced no quantization at all"
        finally:
            pr.stop()
            group.stop()

    def test_fp32_fanout_exact(self, cluster):
        config = _impala_config(num_runners=2)
        group, pr = _make_podracer(config, _podracer_config(), train=False)
        try:
            before = _leaves(pr.get_weights())
            pr.broadcast_weights(None)
            for r in group.runners:
                w = _leaves(rt.get(r.get_weights.remote(), timeout=60.0))
                for a, b in zip(before, w):
                    np.testing.assert_array_equal(a, b)
        finally:
            pr.stop()
            group.stop()


@pytest.mark.slow
class TestSyncWeightsCollective:
    def test_group_sync_weights_routes_collective_and_bit_identical(self, cluster):
        """EnvRunnerGroup.sync_weights rides broadcast_tree (one put + one
        collective, not N puts) and leaves all replicas bit-identical —
        fp32 exact, int8 quantized-but-equal."""
        config = _impala_config(num_runners=2)
        mc = _module_config(config)
        params = IMPALALearner(config, mc).get_weights()
        for wire, exact in ((None, True), ("int8", False)):
            group = EnvRunnerGroup(
                "CartPole-v1", mc, num_runners=2, num_envs_per_runner=2,
                seed=11, weight_wire_dtype=wire,
            )
            try:
                group.sync_weights(params)
                assert group._sync_group is not None  # collective path
                assert not group._col_broken
                ws = [
                    _leaves(rt.get(r.get_weights.remote(), timeout=60.0))
                    for r in group.runners
                ]
                for a, b in zip(*ws):
                    np.testing.assert_array_equal(a, b)
                if exact:
                    for a, b in zip(_leaves(params), ws[0]):
                        np.testing.assert_array_equal(a, b)
                else:
                    assert any(not np.array_equal(a, b) for a, b in zip(_leaves(params), ws[0]))
            finally:
                group.stop()

    def test_single_runner_uses_put_path(self, cluster):
        config = _impala_config(num_runners=1)
        mc = _module_config(config)
        params = IMPALALearner(config, mc).get_weights()
        group = EnvRunnerGroup(
            "CartPole-v1", mc, num_runners=1, num_envs_per_runner=2,
            seed=12,
        )
        try:
            group.sync_weights(params)
            assert group._sync_group is None  # no group for world=1
            w = _leaves(rt.get(group.runners[0].get_weights.remote(), timeout=60.0))
            for a, b in zip(_leaves(params), w):
                np.testing.assert_array_equal(a, b)
        finally:
            group.stop()


@pytest.mark.slow
class TestImpalaPodracerMode:
    def test_flag_off_is_legacy_loop(self, cluster):
        """Parity pin: throughput_mode unset -> no podracer objects, the
        in-driver loop, and a bit-reproducible seeded run (two identical
        runs end with byte-identical params)."""
        assert IMPALAConfig().throughput_mode is None

        def run_once():
            algo = (
                _impala_config(num_runners=1, num_envs=2, frag_len=8)
                .training(updates_per_iteration=2)
                .build()
            )
            try:
                assert algo._podracer is None
                assert algo.learner is not None
                for _ in range(2):
                    res = algo.train()
                assert res["fragments_consumed"] == 2
                return _leaves(algo.learner.get_weights())
            finally:
                algo.stop()

        a, b = run_once(), run_once()
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def test_podracer_mode_trains(self, cluster):
        algo = (
            _impala_config(num_runners=2, num_envs=2, frag_len=8)
            .training(
                throughput_mode="podracer", updates_per_iteration=2,
                podracer_max_policy_lag=4,
            )
            .build()
        )
        try:
            assert algo._podracer is not None
            assert algo.learner is None
            for i in range(2):
                res = algo.train()
            assert res["updates"] == 2
            stats = algo._podracer.learner_stats()
            # in-flight ingests landing after run() returns may add
            # uncounted updates, so >= the 4 counted ones
            assert stats["policy_version"] >= 4
            assert stats["max_trained_lag"] <= 4
            assert sum(stats["staleness_hist"].values()) == stats["trained_fragments"]
            # checkpoint roundtrip through the podracer learner
            w = _leaves(algo._eval_weights())
            state = algo.get_state()
            algo.set_state(state)
            w2 = _leaves(algo._eval_weights())
            for a, b in zip(w, w2):
                np.testing.assert_array_equal(a, b)
        finally:
            algo.stop()

    def test_appo_inherits_podracer_mode(self, cluster):
        """APPO rides the plane through ``learner_cls`` — the podracer
        learner actor must be built from the clipped-surrogate learner,
        not IMPALA's."""
        from ray_tpu_torch.rllib.appo import APPOConfig

        algo = (
            APPOConfig()
            .environment("CartPole-v1")
            .env_runners(
                num_env_runners=2, num_envs_per_env_runner=2,
                rollout_fragment_length=8,
            )
            .training(
                throughput_mode="podracer", updates_per_iteration=2,
                lr=1e-3, seed=3,
            )
            .learners(0, device="cpu")
            .build()
        )
        try:
            assert algo._podracer is not None
            res = algo.train()
            assert res["updates"] == 2
            # the APPO loss publishes mean_ratio; IMPALA's does not —
            # its presence proves which learner ran in the actor
            assert "mean_ratio" in res
        finally:
            algo.stop()
