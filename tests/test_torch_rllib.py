"""The port's RLlib (``ray_tpu_torch.rllib``, ``models/catalog.py``) against
the JAX package's, on the CPU.

Inputs come from seeded numpy; weights are the reference's own seeded init,
carried across with ``models.convert.rl_params_from_jax``; the port runs
with ``learners(0, device="cpu")``.  Tolerances, all f32:

- forward passes 1e-5; GAE and V-trace 1e-6 (absolute and relative);
- each loss and its gradients against ``jax.value_and_grad`` of the
  reference's own loss: 1e-5;
- whole algorithms fed the same fragments or the same JSONL file, at
  each config's own lr: each parameter's move from the common start,
  ``Δ = w_after - w0``, after 3 ``training_step``s, elementwise within
  ``STEP_REL * max|Δ_ref| + STEP_ULPS * eps_f32 * |w|`` of its tensor.
  STEP_REL = 1e-4 holds the one systematic difference with room: optax
  takes Adam's bias corrections ``1 - b**t`` in f32 (``1 - f32(0.999)`` is
  1.3e-5 off), torch in f64, so every Δ differs by about 7e-6 of itself.
  The second term is w's own f32 rounding over 3 to 9 updates and polyak
  averages.  The bound is some 1e-3 of the smallest tensor's move, so a
  learner that does not update, or updates in another direction, fails
  (each test checks that no update would).  The Adam sign-flip bound: an
  element whose gradient is zero up to rounding would move by up to lr an
  update in a direction set by rounding, so the two packages could end
  up to ``2 * updates * lr`` apart there (1.8e-2 for DQN's 9 updates at
  1e-3); no element of these cases has one (a dead ReLU unit's gradient is
  exactly zero in both, an unused head's none), so none is exempt;
- replay buffers, connectors and conversions bit for bit; greedy episode
  returns equal.

Sampling cannot reproduce ``jax.random``: sampled actions are held by their
distribution and by repeating for a seed.  Learning on CartPole, the
LearnerGroup over actors, multi-agent PPO, the offline algorithms on a
cluster and the dry run's pass 8 are in ``test_zz_torch_rllib.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import catalog as jax_catalog
from ray_tpu.rllib import appo as jax_appo
from ray_tpu.rllib import connectors as jax_connectors
from ray_tpu.rllib import core as jax_core
from ray_tpu.rllib import cql as jax_cql
from ray_tpu.rllib import dqn as jax_dqn
from ray_tpu.rllib import env_runner as jax_env_runner
from ray_tpu.rllib import impala as jax_impala
from ray_tpu.rllib import marwil as jax_marwil
from ray_tpu.rllib import offline as jax_offline
from ray_tpu.rllib import ppo as jax_ppo
from ray_tpu.rllib import sac as jax_sac
from ray_tpu_torch.common import config as port_config
from ray_tpu_torch.models import catalog
from ray_tpu_torch.models.convert import rl_params_from_jax, rl_params_to_jax, rl_state_from_jax
from ray_tpu_torch.rllib import appo, connectors, core, cql, dqn, env_runner, impala, marwil, offline, ppo, sac
from ray_tpu_torch.rllib.learner_group import LearnerGroup, clip_by_global_norm_, to_tensors

FWD_TOL = 1e-5
EST_TOL = 1e-6
LOSS_TOL = 1e-5
STEP_REL = 1e-4
STEP_ULPS = 4

MLP = (jax_core.MLPModuleConfig(4, 2, (16, 16)), core.MLPModuleConfig(4, 2, (16, 16)))
# Non-square, and 3 channels against filters of 4 and 6: a flatten in
# another order than the reference's NHWC cannot pass.
CNN_ARGS = ((10, 12, 3), 5, ((4, 3, 2), (6, 2, 1)), (16,))
CNN = (jax_catalog.CNNModuleConfig(*CNN_ARGS), catalog.CNNModuleConfig(*CNN_ARGS))
FAMILIES = {"mlp": MLP, "cnn": CNN}


def ref_params(jax_cfg, seed=0):
    return jax.tree.map(np.asarray, jax_core.module_init(jax.random.key(seed), jax_cfg))


def obs_of(jax_cfg, n, rng):
    dim = int(np.prod(jax_cfg.obs_shape)) if hasattr(jax_cfg, "obs_shape") else jax_cfg.obs_dim
    return rng.normal(size=(n, dim)).astype(np.float32)


def t(x):
    return to_tensors({"x": x}, "cpu")["x"]


def assert_grads(module, jax_grads, tol=LOSS_TOL):
    """The port's ``.grad`` of every parameter (zeros where autograd left
    None: an unused head) against the reference's gradient pytree."""
    want = rl_state_from_jax(jax_grads)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), atol=tol, rtol=tol, err_msg=n)


def assert_metrics(got, want, tol=LOSS_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=tol, rtol=tol, err_msg=k)


# -- modules ------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_jax(family):
    jax_cfg, cfg = FAMILIES[family]
    params = ref_params(jax_cfg)
    module = rl_params_from_jax(params, cfg, "cpu")
    obs = obs_of(jax_cfg, 7, np.random.default_rng(1))
    want_logits, want_value = jax.jit(jax_core.get_forward(jax_cfg))(params, obs)
    with torch.no_grad():
        logits, value = module(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), atol=FWD_TOL, rtol=FWD_TOL)


def test_cnn_flatten_order_matters():
    """The same converted weights with an NCHW flatten give other values:
    the (10, 12, 3) case can tell the two orders apart."""
    jax_cfg, cfg = CNN
    params = ref_params(jax_cfg)
    module = rl_params_from_jax(params, cfg, "cpu")
    obs = torch.from_numpy(obs_of(jax_cfg, 3, np.random.default_rng(2)))
    H, W, C = cfg.obs_shape
    with torch.no_grad():
        x = obs.reshape(-1, H, W, C).permute(0, 3, 1, 2)
        for conv in module.conv:
            x = torch.relu(conv(x))
        wrong = core.heads(module, x.reshape(x.shape[0], -1))[0]
        right = module(obs)[0]
    assert (wrong - right).abs().max() > 1e-3


def test_module_config_dispatch():
    for shape, acts, mc in [((4,), 2, None), ((84, 84, 4), 6, None), ((8, 8, 1), 3, {"hidden": (16,)}),
                            ((16, 16, 3), 4, {"conv_filters": ((8, 4, 2),), "hidden": (32,)}),
                            ((2, 3), 2, {"hidden": (8,)})]:
        want = jax_catalog.get_module_config(shape, acts, mc)
        got = catalog.get_module_config(shape, acts, mc)
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(catalog.get_module_config((84, 84, 4), 6), catalog.CNNModuleConfig)
    assert isinstance(core.module_init(CNN[1], None, "cpu"), catalog.CNNModule)
    # Mnih et al. 2013's network: 9x9x32 features, ~678k parameters
    atari = core.module_init(catalog.get_module_config((84, 84, 4), 6), None, "cpu")
    assert atari.layers[0].w.shape == (9 * 9 * 32, 256)
    assert sum(p.numel() for p in atari.parameters()) == 677_943


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_conversion_round_trip_bit_for_bit(family):
    params = ref_params(FAMILIES[family][0], seed=3)
    back = rl_params_to_jax(rl_params_from_jax(params, FAMILIES[family][1], "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_sac_composite_round_trip_bit_for_bit():
    learner = jax_sac.SACLearner(jax_sac.SACConfig(hidden=(16, 16)), MLP[0])
    params = jax.tree.map(np.asarray, learner.params)
    module = rl_params_from_jax(params, MLP[1], "cpu")
    assert isinstance(module, sac.SACModules)
    back = rl_params_to_jax(module)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert np.array_equal(a, b)


# -- sampling -----------------------------------------------------------------

def test_logp_of_given_actions():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(32, 5)).astype(np.float32) * 3
    actions = rng.integers(0, 5, 32).astype(np.int32)
    want = jnp.take_along_axis(jax.nn.log_softmax(logits), actions[:, None], axis=1)[:, 0]
    _, got = ppo.logp_of(torch.from_numpy(logits), t(actions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)


def _fixed_head(logits):
    """A module whose logits are ``logits`` for every row."""
    class Head(torch.nn.Module):
        def forward(self, obs):
            return logits.expand(obs.shape[0], -1), logits.sum() + obs[:, 0]
    return Head()


def test_categorical_sampling_distribution_and_seed():
    logits = torch.tensor([[0.5, -1.0, 1.5]])
    obs = torch.zeros((20_000, 1))
    a1, logp, _ = core.sample_actions(_fixed_head(logits), obs, torch.Generator().manual_seed(5))
    freq = np.bincount(a1.numpy(), minlength=3) / len(a1)
    np.testing.assert_allclose(freq, torch.softmax(logits, -1)[0].numpy(), atol=0.015)
    np.testing.assert_allclose(logp.numpy(), torch.log_softmax(logits, -1)[0, a1].numpy(), rtol=1e-6)
    a2, _, _ = core.sample_actions(_fixed_head(logits), obs, torch.Generator().manual_seed(5))
    assert torch.equal(a1, a2)


def test_epsilon_greedy_at_zero_and_one():
    rng = np.random.default_rng(6)
    params = ref_params(MLP[0])
    module = rl_params_from_jax(params, MLP[1], "cpu")
    obs = rng.normal(size=(4000, 4)).astype(np.float32)
    with torch.no_grad():
        a0, logp0, v0 = core.sample_actions_epsilon(module, torch.from_numpy(obs),
                                                    torch.Generator().manual_seed(7), 0.0)
        a1, logp1, v1 = core.sample_actions_epsilon(module, torch.from_numpy(obs),
                                                    torch.Generator().manual_seed(7), 1.0)
    ref_a, ref_logp, ref_v = jax_core.sample_actions_epsilon(params, obs, jax.random.key(7), 0.0)
    assert np.array_equal(a0.numpy(), np.asarray(ref_a))  # ε = 0 is the greedy readout
    np.testing.assert_allclose(v0.numpy(), np.asarray(ref_v), atol=FWD_TOL, rtol=FWD_TOL)
    assert not logp0.any() and not logp1.any()
    assert torch.equal(v0, v1)
    # ε = 1: uniform over the actions, whatever the Q-values say
    np.testing.assert_allclose(np.bincount(a1.numpy(), minlength=2) / len(a1), [0.5, 0.5], atol=0.03)


# -- estimators ---------------------------------------------------------------

def test_compute_gae_matches_reference():
    rng = np.random.default_rng(8)
    T, B = 17, 5
    rew, val = rng.normal(size=(T, B)).astype(np.float32), rng.normal(size=(T, B)).astype(np.float32)
    dones = (rng.random((T, B)) < 0.2).astype(np.float32)
    last = rng.normal(size=B).astype(np.float32)
    want = jax_ppo.compute_gae(rew, val, dones, last, 0.99, 0.95)
    got = ppo.compute_gae(rew, val, dones, last, 0.99, 0.95)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=EST_TOL, rtol=EST_TOL)


@pytest.mark.parametrize("clips", [(1.0, 1.0), (2.0, 0.5), (100.0, 100.0)])
def test_vtrace_matches_reference(clips):
    rng = np.random.default_rng(9)
    T, B = 11, 4
    args = [rng.normal(size=(T, B)).astype(np.float32) - 1.0,  # behavior logp
            rng.normal(size=(T, B)).astype(np.float32) - 1.0,  # target logp
            rng.normal(size=(T, B)).astype(np.float32),  # rewards
            rng.normal(size=(T, B)).astype(np.float32),  # values
            (rng.random((T, B)) < 0.2).astype(np.float32),  # dones
            rng.normal(size=B).astype(np.float32)]  # last values
    want = jax_impala.vtrace(*map(jnp.asarray, args), 0.9, *clips)
    got = impala.vtrace(*map(torch.from_numpy, args), 0.9, *clips)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=EST_TOL, rtol=EST_TOL)


# -- losses and gradients ---------------------------------------------------

def _transitions(rng, jax_cfg, n):
    return {"obs": obs_of(jax_cfg, n, rng), "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": rng.normal(size=n).astype(np.float32), "next_obs": obs_of(jax_cfg, n, rng),
            "dones": (rng.random(n) < 0.2).astype(np.float32)}


def _value_and_grad(loss, params, batch):
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, batch)
    return metrics, grads


def _port_loss(loss_fn, module, batch, *args):
    module.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(module, to_tensors(batch, "cpu"), *args)
    loss.backward()
    return {k: v.detach() for k, v in metrics.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ppo_loss_and_grads(family):
    jax_cfg, cfg = FAMILIES[family]
    rng = np.random.default_rng(10)
    n = 64
    batch = {"obs": obs_of(jax_cfg, n, rng), "actions": rng.integers(0, 2, n).astype(np.int32),
             "logp": (np.log(0.5) + 0.3 * rng.normal(size=n)).astype(np.float32),
             "advantages": rng.normal(size=n).astype(np.float32),
             "returns": rng.normal(size=n).astype(np.float32)}
    params = ref_params(jax_cfg)
    config = jax_ppo.PPOConfig()
    want, jax_grads = _value_and_grad(
        lambda p, b: jax_ppo.ppo_loss(p, b, config, forward_fn=jax_core.get_forward(jax_cfg)), params, batch)
    module = rl_params_from_jax(params, cfg, "cpu")
    got = _port_loss(ppo.ppo_loss, module, batch, ppo.PPOConfig())
    assert_metrics(got, want)
    assert_grads(module, jax_grads)


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("algo", ["dqn", "cql"])
def test_dqn_and_cql_loss_and_grads(algo, double_q):
    jax_cfg, cfg = MLP
    rng = np.random.default_rng(11)
    batch = _transitions(rng, jax_cfg, 64)
    params, target = ref_params(jax_cfg, 0), ref_params(jax_cfg, 1)
    if algo == "dqn":
        ref = jax_dqn.DQNLearner(jax_dqn.DQNConfig(double_q=double_q), jax_cfg)
        loss_fn, config = dqn.dqn_loss, dqn.DQNConfig(double_q=double_q)
    else:
        ref = jax_cql.CQLLearner(jax_cql.CQLConfig(double_q=double_q, cql_alpha=0.7), jax_cfg)
        loss_fn, config = cql.cql_loss, cql.CQLConfig(double_q=double_q, cql_alpha=0.7)
    want, jax_grads = _value_and_grad(ref._loss, params, dict(batch, target_params=target))
    module = rl_params_from_jax(params, cfg, "cpu")
    target_module = rl_params_from_jax(target, cfg, "cpu")
    got = _port_loss(lambda m, b: loss_fn(m, target_module, b, config), module, batch)
    assert_metrics(got, want)
    assert_grads(module, jax_grads)


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_impala_and_appo_loss_and_grads(algo):
    jax_cfg, cfg = MLP
    rng = np.random.default_rng(12)
    T, B = 9, 3
    batch = {"obs": rng.normal(size=(T, B, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
             "logp": (np.log(0.5) + 0.3 * rng.normal(size=(T, B))).astype(np.float32),
             "rewards": rng.normal(size=(T, B)).astype(np.float32),
             "dones": (rng.random((T, B)) < 0.2).astype(np.float32),
             "last_obs": rng.normal(size=(B, 4)).astype(np.float32)}
    params = ref_params(jax_cfg)
    if algo == "impala":
        ref = jax_impala.IMPALALearner(jax_impala.IMPALAConfig(), jax_cfg)
        loss_fn, config = impala.impala_loss, impala.IMPALAConfig()
    else:
        ref = jax_appo.APPOLearner(jax_appo.APPOConfig(clip_param=0.1), jax_cfg)
        loss_fn, config = appo.appo_loss, appo.APPOConfig(clip_param=0.1)
    want, jax_grads = _value_and_grad(ref._loss, params, batch)
    module = rl_params_from_jax(params, cfg, "cpu")
    assert_metrics(_port_loss(loss_fn, module, batch, config), want)
    assert_grads(module, jax_grads)


def _reference_sac_losses(learner):
    """The reference's own ``losses(trainable, frozen, batch)``, taken
    from the closure of the update it builds."""
    update = learner._build_update()
    return dict(zip(update.__code__.co_freevars, (c.cell_contents for c in update.__closure__)))["losses"]


def test_sac_loss_and_grads():
    jax_cfg, cfg = MLP
    rng = np.random.default_rng(13)
    batch = _transitions(rng, jax_cfg, 64)
    ref = jax_sac.SACLearner(jax_sac.SACConfig(initial_alpha=0.3), jax_cfg)
    params = jax.tree.map(np.asarray, ref.params)
    # targets that trail the critics, as after some polyak syncs
    params["q1_t"] = ref_params(jax_cfg, 5)
    params["q2_t"] = ref_params(jax_cfg, 6)
    trainable = {k: params[k] for k in ("pi", "q1", "q2")}
    frozen = {k: params[k] for k in ("q1_t", "q2_t", "log_alpha")}
    (_, want), jax_grads = jax.jit(jax.value_and_grad(_reference_sac_losses(ref), has_aux=True))(
        trainable, frozen, batch)
    module = rl_params_from_jax(params, cfg, "cpu")
    got = _port_loss(sac.sac_loss, module, batch, sac.SACConfig())
    assert_metrics(got, want)
    for name in ("pi", "q1", "q2"):
        assert_grads(getattr(module, name), jax_grads[name])
    assert module.log_alpha.grad is None
    assert all(p.grad is None for p in (*module.q1_t.parameters(), *module.q2_t.parameters()))


@pytest.mark.parametrize("beta", [0.0, 1.5])
def test_marwil_loss_and_grads(beta):
    jax_cfg, cfg = MLP
    rng = np.random.default_rng(14)
    batch = {"obs": obs_of(jax_cfg, 64, rng), "actions": rng.integers(0, 2, 64).astype(np.int32),
             "returns": (3 * rng.normal(size=64)).astype(np.float32), "adv_sq_ma": np.float32(1.7)}
    params = ref_params(jax_cfg)
    ref = jax_marwil.MARWILLearner(jax_marwil.MARWILConfig(beta=beta, max_advantage_weight=5.0), jax_cfg)
    want, jax_grads = _value_and_grad(ref._loss, params, batch)
    module = rl_params_from_jax(params, cfg, "cpu")
    got = _port_loss(marwil.marwil_loss, module, batch, marwil.MARWILConfig(beta=beta, max_advantage_weight=5.0))
    assert_metrics(got, want)
    assert_grads(module, jax_grads)


def test_bc_loss_and_grads():
    jax_cfg, cfg = CNN
    rng = np.random.default_rng(15)
    batch = {"obs": obs_of(jax_cfg, 16, rng), "actions": rng.integers(0, 5, 16).astype(np.int32)}
    params = ref_params(jax_cfg)
    ref = jax_offline.BCLearner(jax_offline.BCConfig(), jax_cfg)
    want, jax_grads = _value_and_grad(ref._loss, params, batch)
    module = rl_params_from_jax(params, cfg, "cpu")
    assert_metrics(_port_loss(lambda m, b: offline.bc_loss(m, b), module, batch), want)
    assert_grads(module, jax_grads)


# -- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_is_optax(max_norm):
    """Above the threshold every gradient is scaled by max_norm / ‖g‖ with
    no epsilon; below it nothing changes."""
    import optax

    rng = np.random.default_rng(16)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((4, 16), (16,), (16, 2), (2,))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    assert (norm > max_norm) == (max_norm == 0.5)
    want, _ = optax.clip_by_global_norm(max_norm).update(grads, optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)
    if max_norm == 50.0:
        assert all(np.array_equal(a.numpy(), g) for a, g in zip(got, grads))


# -- copied host code -------------------------------------------------------

def test_replay_buffer_bit_for_bit():
    rng = np.random.default_rng(17)
    bufs = [jax_dqn.ReplayBuffer(50, 3), dqn.ReplayBuffer(50, 3)]
    for _ in range(7):
        n = int(rng.integers(5, 15))
        args = (rng.normal(size=(n, 3)).astype(np.float32), rng.integers(0, 2, n).astype(np.int32),
                rng.normal(size=n).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32),
                (rng.random(n) < 0.3).astype(np.float32))
        for b in bufs:
            b.add_batch(*args)
    assert bufs[0].size == bufs[1].size == 50
    want, got = (b.sample(np.random.default_rng(18), 32) for b in bufs)
    assert set(want) == set(got) and all(np.array_equal(want[k], got[k]) for k in want)


def test_connectors_bit_for_bit():
    rng = np.random.default_rng(19)
    frames = [rng.normal(5.0, 2.0, size=(3, 2, 2)).astype(np.float32) for _ in range(6)]

    def run(mod):
        pipe = mod.Pipeline([mod.FlattenObs(), mod.NormalizeObs(clip=3.0), mod.FrameStack(k=3)])
        outs = []
        for i, f in enumerate(frames):
            if i == 3:
                pipe.reset(1)
            outs.append(pipe(f))
        outs.append(mod.ClipActions(-0.5, 0.5)(frames[0]))
        outs.append(np.asarray(mod.obs_shape_after(mod.Pipeline([mod.FrameStack(k=4)]), (3, 2))))
        return outs

    for a, b in zip(run(jax_connectors), run(connectors)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- whole training steps -------------------------------------------------------

class SeededRunners:
    """Stands in for an EnvRunnerGroup: every ``sample`` returns the next
    of the fragments drawn from one seed, the same in both packages."""

    def __init__(self, env, module_config, num_runners=2, num_envs_per_runner=4, seed=0, **_):
        self.rng = np.random.default_rng(100 + seed)
        self.n, self.B = num_runners, num_envs_per_runner
        self.synced = 0

    def sample(self, T, epsilon=None):
        r, B = self.rng, self.B
        return [{"obs": r.normal(size=(T, B, 4)).astype(np.float32),
                 "actions": r.integers(0, 2, (T, B)).astype(np.int32),
                 "rewards": r.normal(size=(T, B)).astype(np.float32),
                 "dones": (r.random((T, B)) < 0.1).astype(np.float32),
                 "logp": (np.log(0.5) + 0.2 * r.normal(size=(T, B))).astype(np.float32),
                 "values": r.normal(size=(T, B)).astype(np.float32),
                 "last_values": r.normal(size=B).astype(np.float32),
                 "final_obs": r.normal(size=(B, 4)).astype(np.float32),
                 "episode_returns": r.uniform(5, 50, size=2)} for _ in range(self.n)]

    def sync_weights(self, _params):
        self.synced += 1

    def stop(self):
        pass


def _build_pair(monkeypatch, jax_mod, port_mod, jax_config, port_config):
    monkeypatch.setattr(jax_mod, "EnvRunnerGroup", SeededRunners)
    monkeypatch.setattr(port_mod, "EnvRunnerGroup", SeededRunners)
    return jax_config.build(), port_config.learners(0, device="cpu").build()


def _state(module):
    return {n: v.detach().clone() for n, v in module.state_dict().items()}


def _assert_moved_alike(w0, got, want):
    """Each parameter's move from ``w0`` in the port (``got``) against the
    reference's (``want``, converted), within the bound of the module
    docstring."""
    assert set(got) == set(want) == set(w0)
    eps = torch.finfo(torch.float32).eps
    for n in want:
        d_ref, d_port = (want[n] - w0[n]).double(), (got[n] - w0[n]).double()
        bound = STEP_REL * d_ref.abs().max() + STEP_ULPS * eps * torch.maximum(want[n].abs(), w0[n].abs()).double()
        err = (d_port - d_ref).abs()
        assert (err <= bound).all(), f"{n}: |Δ - Δ_ref| {float(err.max()):.3e}, max|Δ_ref| {float(d_ref.abs().max()):.3e}"


def _assert_learned_alike(w0, module, want_jax):
    """The port's module moved as the reference's did, and a learner that
    left any tensor the reference moved in place would have failed."""
    want = rl_state_from_jax(jax.tree.map(np.asarray, want_jax))
    _assert_moved_alike(w0, _state(module), want)
    moved = [n for n in want if not torch.equal(want[n], w0[n])]
    assert moved
    for n in moved:
        with pytest.raises(AssertionError):
            _assert_moved_alike({n: w0[n]}, {n: w0[n]}, {n: want[n]})


def _assert_learner_metrics(got, want):
    """The learner's metrics of the last iteration (timings aside), taken
    at parameters that agree as above."""
    keys = {k for k, v in want.items() if isinstance(v, float) and "time" not in k}
    assert keys and keys <= set(got)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_REL, atol=STEP_REL * 1e-2, err_msg=k)


STEP_CASES = {
    # one minibatch per epoch (128 rows): any permutation is the same update
    "ppo": (jax_ppo, ppo, lambda m: m.PPOConfig(hidden=(16, 16), minibatch_size=128, num_epochs=2,
                                                rollout_fragment_length=16, num_envs_per_runner=4)),
    "dqn": (jax_dqn, dqn, lambda m: m.DQNConfig(hidden=(16, 16), learning_starts=64,
                                                updates_per_env_step=0.03, target_update_freq=4)),
    "sac": (jax_sac, sac, lambda m: m.SACConfig(hidden=(16, 16), learning_starts=64,
                                                updates_per_env_step=0.03, tau=0.2, train_batch_size=32)),
}


@pytest.mark.parametrize("algo", sorted(STEP_CASES))
def test_three_training_steps_match(algo, monkeypatch):
    jax_mod, port_mod, make = STEP_CASES[algo]
    ref, port = _build_pair(monkeypatch, jax_mod, port_mod,
                            make(jax_mod).environment("CartPole-v1"), make(port_mod).environment("CartPole-v1"))
    try:
        if algo == "sac":
            learner, ref_learner = port.learner, ref.learner
        else:
            learner, ref_learner = port.learner_group.local, ref.learner_group.local
        learner.set_weights(rl_state_from_jax(jax.tree.map(np.asarray, ref_learner.params)))
        if algo == "dqn":
            learner.sync_target()
            t0 = _state(learner.target)
        w0 = _state(learner.module)
        for _ in range(3):
            want, got = ref.train(), port.train()
            assert got["training_iteration"] == want["training_iteration"]
            assert got["episode_return_mean"] == want["episode_return_mean"]
        _assert_learner_metrics(got, want)
        _assert_learned_alike(w0, learner.module, ref_learner.params)
        if algo == "dqn":  # the target synced at the 4th and 8th of 9 updates
            assert learner.grad_steps == ref_learner.grad_steps == 9
            _assert_learned_alike(t0, learner.target, ref_learner.target_params)
    finally:
        ref.stop()
        port.stop()


def test_three_bc_steps_on_one_jsonl_match(tmp_path, monkeypatch):
    path = str(tmp_path / "expert.jsonl")
    jax_offline.record_episodes("CartPole-v1", lambda o: int(o[2] + 0.5 * o[3] > 0), num_episodes=3, path=path)
    kw = dict(hidden=(16, 16), train_batch_size=64, updates_per_iteration=4, input_paths=[path])
    ref, port = _build_pair(monkeypatch, jax_offline, offline, jax_offline.BCConfig(**kw).environment("CartPole-v1"),
                            offline.BCConfig(**kw).environment("CartPole-v1"))
    try:
        port.learner.set_weights(rl_state_from_jax(jax.tree.map(np.asarray, ref.learner.params)))
        w0 = _state(port.learner.module)
        for _ in range(3):
            want, got = ref.train(), port.train()
            np.testing.assert_allclose(got["bc_loss"], want["bc_loss"], rtol=LOSS_TOL)
        _assert_learned_alike(w0, port.learner.module, ref.learner.params)
    finally:
        ref.stop()
        port.stop()


# -- greedy evaluation ----------------------------------------------------------

def test_greedy_evaluation_returns_equal():
    params = ref_params(jax_core.MLPModuleConfig(4, 2), seed=21)
    ref = jax_env_runner.EnvRunnerActor._cls("CartPole-v1", jax_core.MLPModuleConfig(4, 2), 2, 3)
    threads = torch.get_num_threads()
    try:  # a runner takes one intra-op thread for its process
        port = env_runner.EnvRunnerActor._cls("CartPole-v1", core.MLPModuleConfig(4, 2), 2, 3)
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(threads)
    ref.set_weights(params)
    port.set_weights(rl_state_from_jax(params))
    want, got = ref.evaluate(6, greedy=True), port.evaluate(6, greedy=True)
    assert len(got["episode_returns"]) >= 6
    assert np.array_equal(got["episode_returns"], want["episode_returns"])
    assert np.array_equal(got["episode_lengths"], want["episode_lengths"])


# -- the seams ------------------------------------------------------------------

def test_two_cuda_learners_refused_on_one_card(monkeypatch):
    monkeypatch.setenv("RT_GPU_COUNT_OVERRIDE", "1")
    port_config.cfg.reset()
    try:
        with pytest.raises(RuntimeError, match=r"wants 2 GPU\(s\).*the node has 1"):
            ppo.PPOConfig().environment("CartPole-v1").learners(2, device="cuda").build()
        with pytest.raises(RuntimeError, match=r"wants 2 GPU\(s\).*the node has 1"):
            LearnerGroup(lambda: None, num_learners=2, device="cuda")
    finally:
        monkeypatch.delenv("RT_GPU_COUNT_OVERRIDE")
        port_config.cfg.reset()


def test_learners_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    assert ppo.PPOConfig().learner_device == "cuda"
    for make in (lambda: ppo.PPOLearner(ppo.PPOConfig(), MLP[1]),
                 lambda: sac.SACLearner(sac.SACConfig(), MLP[1]),
                 lambda: core.module_init(CNN[1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("config", [impala.IMPALAConfig, appo.APPOConfig])
def test_podracer_mode_raises(config, monkeypatch):
    """Podracer mode puts its learner actor on a card: on a node without
    one it is refused when the algorithm is made, before any env is probed
    or any process started (the mode itself trains: tests/
    test_zz_torch_podracer.py)."""
    monkeypatch.setenv("RT_GPU_COUNT_OVERRIDE", "0")
    port_config.cfg.reset()
    try:
        with pytest.raises(RuntimeError, match=r"a podracer learner on 'cuda' wants 1 GPU\(s\).*the node has 0"):
            config(env="CartPole-v1", throughput_mode="podracer").build()
    finally:
        monkeypatch.delenv("RT_GPU_COUNT_OVERRIDE")
        port_config.cfg.reset()
