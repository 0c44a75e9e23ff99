"""The port's Podracer plane (``ray_tpu_torch.rllib.podracer``) against the
JAX package's, on the CPU, with no cluster: the learner actor's class runs
in process (``PodracerLearnerActor._cls``) in both packages.

One seeded sequence of IMPALA fragments (T = 8, 2 envs, CartPole's shapes,
an MLP of (16, 16)) is ingested by both learners, from the reference's
seeded weights carried across with ``models.convert.rl_state_from_jax``.
Its metas make fragments drop stale at ingest and go stale while queued,
come from SUSPECT runners, and overflow the queue; between ingests the
policy version is bumped as a weight push would.  A queue that can train
never overflows (it holds fewer fragments than a batch after every
ingest), so the last part of the sequence goes to a second pair of
learners that only queue (``train=False``, a cap of 2), as the
reference's own overflow test does.

- ``stats()`` after every ingest: equal exactly;
- each update's metrics and the parameters after the last one: within
  ``tests/test_torch_rllib.py``'s bound (its module docstring: optax's f32
  Adam bias corrections against torch's f64 ones);
- the batch assembler and the fragment types: bit for bit.

The cluster-backed tests (the fleet, the fan-outs, the runner kill, IMPALA
and APPO in podracer mode on CartPole) are in
``tests/test_zz_torch_podracer.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rllib import core as jax_core
from ray_tpu.rllib import impala as jax_impala
from ray_tpu.rllib import podracer as jax_podracer
from ray_tpu_torch.models.convert import rl_state_from_jax
from ray_tpu_torch.rllib import core, impala, podracer
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from test_torch_rllib import STEP_REL, _assert_learned_alike, _state

OBS_DIM, NUM_ACTIONS, T, B = 4, 2, 8, 2
HIDDEN = (16, 16)
K = 1  # max_policy_lag of the training learners
# (seq, policy_version, suspect) of each ingest, or "bump": a weight push
# that advances the learner's version without training.
TRAIN_SEQUENCE = [
    (0, 0, False),   # queued alone
    (1, 0, True),    # suspect; trains with 0: update 1 (version 1)
    (2, 1, False),   # queued
    "bump",          # version 2: 2 is at lag 1
    "bump",          # version 3: 2 went stale while queued
    (3, 1, False),   # lag 2 > K: stale at ingest
    (4, 3, False),   # drops 2 at assembly, queued alone
    (5, 2, True),    # suspect; trains with 4: update 2 (version 4)
    (6, 0, False),   # lag 4: stale at ingest
    (7, 4, False),
    (8, 3, False),   # trains with 7: update 3 (version 5)
]
# The queue-only learners (cap 2): the third fragment sheds the suspect one.
QUEUE_SEQUENCE = [(9, 0, True), (10, 0, False), (11, 0, False)]


def fragment(rng):
    return {
        "obs": rng.normal(size=(T, B, OBS_DIM)).astype(np.float32),
        "actions": rng.integers(0, NUM_ACTIONS, (T, B)).astype(np.int32),
        "logp": (np.log(0.5) + 0.2 * rng.normal(size=(T, B))).astype(np.float32),
        "rewards": rng.normal(size=(T, B)).astype(np.float32),
        "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
        "final_obs": rng.normal(size=(B, OBS_DIM)).astype(np.float32),
        "episode_returns": rng.uniform(5, 50, size=1),
    }


def meta(seq, version, suspect):
    return {"runner_index": seq % 2, "seq": seq, "policy_version": version,
            "env_steps": T * B, "suspect": suspect, "incarnation": 0}


@pytest.fixture
def one_thread():
    """The learner actor takes one intra-op thread for its process."""
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def learner_pair(train, cap=None):
    """The reference's and the port's learner actors, in process, from the
    reference's seeded weights."""
    jcfg = jax_impala.IMPALAConfig(hidden=HIDDEN)
    cfg = impala.IMPALAConfig(hidden=HIDDEN).learners(0, device="cpu")
    ref = jax_podracer.PodracerLearnerActor._cls(
        functools.partial(jax_impala.IMPALALearner, jcfg, jax_core.MLPModuleConfig(OBS_DIM, NUM_ACTIONS, HIDDEN)),
        jax_impala.impala_batch_from_fragments, 2, K, train, cap)
    port = podracer.PodracerLearnerActor._cls(
        functools.partial(impala.IMPALALearner, cfg, core.MLPModuleConfig(OBS_DIM, NUM_ACTIONS, HIDDEN)),
        impala.impala_batch_from_fragments, 2, K, train, cap)
    port.learner.set_weights(rl_state_from_jax(jax.tree.map(np.asarray, ref.learner.params)))
    return ref, port


def run_sequence(ref, port, sequence, rng):
    """Each step into both learners; stats equal after every one.  Returns
    how many ingests trained."""
    trained = 0
    for step in sequence:
        if step == "bump":
            w = port.get_weights()
            assert port.set_weights(w, True) == ref.set_weights(ref.get_weights(), True)
        else:
            frag, m = fragment(rng), meta(*step)
            want, got = ref.ingest(frag, dict(m)), port.ingest(frag, dict(m))
            assert got["episode_returns"] == want["episode_returns"]
            assert got["version"] == want["version"]
            assert (got["train"] is None) == (want["train"] is None), step
            if want["train"] is not None:
                trained += 1
                assert set(got["train"]) == set(want["train"])
                for k, v in want["train"].items():
                    np.testing.assert_allclose(got["train"][k], v, rtol=STEP_REL, atol=STEP_REL * 1e-2, err_msg=k)
        assert port.stats() == ref.stats(), step
    return trained


def test_fragment_types_match():
    m = dict(runner_index=3, seq=17, policy_version=5, env_steps=64, suspect=True, incarnation=2)
    got, want = podracer.FragmentMeta(**m), jax_podracer.FragmentMeta(**m)
    assert got.to_dict() == want.to_dict()
    assert podracer.FragmentMeta.from_dict(got.to_dict()) == got
    h, r = podracer.StalenessHistogram(), jax_podracer.StalenessHistogram()
    assert (h.max_lag, h.total, h.snapshot()) == (r.max_lag, r.total, r.snapshot()) == (0, 0, {})
    for lag in (0, 0, 1, 3, 1, 0):
        h.add(lag)
        r.add(lag)
    assert h.snapshot() == r.snapshot() == {0: 3, 1: 2, 3: 1}
    assert (h.max_lag, h.total) == (r.max_lag, r.total) == (3, 6)
    h2 = podracer.StalenessHistogram()
    h2.restore(r.state())
    assert h2.snapshot() == h.snapshot()


def test_fragments_stack_alike():
    rng = np.random.default_rng(0)
    frags = [fragment(rng) for _ in range(3)]
    frags[1] = {k: v[:, :1] if v.ndim == 3 or k in ("actions", "logp", "rewards", "dones") else v
                for k, v in frags[1].items()}
    frags[1]["final_obs"] = frags[1]["final_obs"][:1]
    got = impala.impala_batch_from_fragments(frags)
    want = jax_impala.impala_batch_from_fragments(frags)
    assert set(got) == set(want)
    assert got["obs"].shape == (T, 2 * B + 1, OBS_DIM) and got["last_obs"].shape == (2 * B + 1, OBS_DIM)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_seeded_sequence_matches_reference(one_thread):
    rng = np.random.default_rng(7)
    ref, port = learner_pair(train=True)
    w0 = _state(port.learner.module)
    assert run_sequence(ref, port, TRAIN_SEQUENCE, rng) == 3
    s = port.stats()
    assert s["policy_version"] == 5 and s["trained_fragments"] == 6
    assert s["dropped_stale"] == 3  # two at ingest, one while queued
    assert s["queue_depth"] == 0 and s["max_trained_lag"] <= K
    assert s["staleness_hist"] == {0: 4, 1: 2}
    _assert_learned_alike(w0, port.learner.module, ref.learner.params)

    ref, port = learner_pair(train=False, cap=2)
    run_sequence(ref, port, QUEUE_SEQUENCE, rng)
    s = port.stats()
    assert s["dropped_overflow"] == 1 and s["queue_depth"] == 2 and s["suspect_queue_depth"] == 0
    assert sum(m[2] for m in TRAIN_SEQUENCE + QUEUE_SEQUENCE if m != "bump") == 3


def test_checkpoint_hooks_round_trip(one_thread):
    """``__rt_checkpoint__`` holds CPU copies of the parameters and Adam's
    state; ``__rt_restore__`` puts them into a fresh learner, whose next
    update is then the original's, bit for bit."""
    rng = np.random.default_rng(2)
    _, port = learner_pair(train=True)
    for seq in range(4):
        port.ingest(fragment(rng), meta(seq, 0, False))
    snap = port.__rt_checkpoint__()
    assert snap["policy_version"] == 2 and snap["opt_state"]["state"]
    assert all(t.device.type == "cpu" for t in snap["params"].values())
    _, fresh = learner_pair(train=True)
    fresh.__rt_restore__(snap)
    assert fresh.stats() == {**port.stats(), "queue_depth": 0, "suspect_queue_depth": 0}
    last = [fragment(rng), fragment(rng)]
    for p in (port, fresh):
        for i, f in enumerate(last):
            p.ingest({k: v.copy() for k, v in f.items()}, meta(4 + i, 2, False))
    for k, v in port.get_weights().items():
        assert torch.equal(fresh.get_weights()[k], v), k


def test_card_learner_refused_without_card(monkeypatch):
    """A podracer learner on "cuda" is refused where the run is made,
    naming the card wanted and none there (IMPALA and APPO in podracer
    mode: ``tests/test_torch_rllib.py::test_podracer_mode_raises``)."""
    from ray_tpu_torch.common import config as port_config

    monkeypatch.setenv("RT_GPU_COUNT_OVERRIDE", "0")
    port_config.cfg.reset()
    try:
        with pytest.raises(RuntimeError, match=r"a podracer learner on 'cuda' wants 1 GPU\(s\).*the node has 0"):
            podracer.PodracerRunner(EnvRunnerGroup.__new__(EnvRunnerGroup), lambda: None,
                                    impala.impala_batch_from_fragments, podracer.PodracerConfig())
    finally:
        monkeypatch.delenv("RT_GPU_COUNT_OVERRIDE")
        port_config.cfg.reset()
