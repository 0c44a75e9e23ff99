"""The port's training path (gradients, remat, AdamW steps) against the JAX
package.

Weights are drawn with numpy in the shapes of the JAX ``init`` pytree (norms
near 1, biases near 0, all perturbed) and cross to the port through
``gpt2_params_from_jax``; tokens and masks come from a numpy seed.  Each case
is one jitted JAX program, run once per module: ``jax.value_and_grad`` of
``loss_fn``, through the reference's Pallas backward kernels in interpret
mode where attention is flash.  The port runs the plain versions of its
kernels on the CPU.  The tiny config's head dim is 16, which only the plain
versions take; the ``d64`` cases widen it to 256 wide and 4 heads, the head
dim the card's kernels take.

Gradients are compared leaf by leaf, relative to each gradient's norm:
|g_port - g_jax| / |g_jax|.

- f32: the same arithmetic up to summation order; measured worst 4.4e-7,
  held to 1e-5 (loss 1e-5).
- bf16: both sides round activations, products and the backward's p and ds
  to bf16, and a summation-order difference flips a rounding by one ulp
  (2^-8 relative) now and then; flips carried through two layers and back
  move gradients by about 1e-2 of their norm (measured worst 1.2e-2, in
  ``proj_bias``).  Two choices of the port add to that, both more accurate
  than the reference: ``GPT2.embed`` sums the gradient rows of a repeated
  token in f32 where the reference sums them in bf16, and ``matmul_f32``'s
  backward (see ``test_matmul_f32_backward_matches_vjp``).  Held to 3e-2,
  the loss to 2e-3.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.common import matmul_f32
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.parallel.spmd import TrainState, adamw, compile_train_step

_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {
    torch.float32: {"loss": 1e-5, "grad": 1e-5},
    torch.bfloat16: {"loss": 2e-3, "grad": 3e-2},
}
# Widths on top of the tiny config: "" is tiny itself (D = 16), "d64" the
# head dim the card's kernels take.
WIDTHS = {"": {}, "d64": dict(embed_dim=256, num_heads=4)}
# case → (attention_impl, dtype, xent_chunk, masked, widths)
CASES = {
    "flash-f32": ("flash", torch.float32, 0, False, ""),
    "dense-f32": ("dense", torch.float32, 0, False, ""),
    "flash-bf16": ("flash", torch.bfloat16, 0, False, ""),
    "chunked-xent-mask-f32": ("dense", torch.float32, 32, True, ""),
    "flash-d64-f32": ("flash", torch.float32, 0, True, "d64"),
    "flash-d64-bf16": ("flash", torch.bfloat16, 0, False, "d64"),
}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    """The JAX package keeps a process-wide current mesh, which its own
    tests leave set in the worker that ran them; its flash attention then
    shards over that mesh.  The references here are single-device."""
    jax_mesh.set_current_mesh(None)


def _draw_params(widths=""):
    jcfg = jax_gpt2.GPTConfig.tiny(**WIDTHS[widths])
    shapes = jax.eval_shape(lambda: jax_gpt2.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)

    def draw(path, s):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def np_params():
    return _draw_params()


@pytest.fixture(scope="module")
def params_of(np_params):
    """widths → the numpy params drawn for them."""
    cache = {"": np_params}

    def get(widths):
        if widths not in cache:
            cache[widths] = _draw_params(widths)
        return cache[widths]

    return get


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (2, 129), dtype=np.int32)
    mask = (rng.random((2, 128)) < 0.7).astype(np.float32)
    return tokens, mask


def _configs(impl, dtype, chunk=0, widths=""):
    kw = dict(attention_impl=impl, xent_chunk=chunk, **WIDTHS[widths])
    return (jax_gpt2.GPTConfig.tiny(dtype=_JAX_DTYPE[dtype], **kw),
            gpt2.GPTConfig.tiny(dtype=dtype, **kw))


def _batch(tokens, mask, masked):
    return {"tokens": tokens, **({"mask": mask} if masked else {})}


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _flat_jax(tree):
    """The reference's gradient pytree as {name: array}, block leaves
    stacked over layers."""
    out = {k: np.asarray(tree[k]) for k in ("wte", "wpe", "lnf_scale", "lnf_bias")}
    out.update({f"blocks.{k}": np.asarray(v) for k, v in tree["blocks"].items()})
    return out


def _flat_port(model, attr="grad"):
    """The port's parameters' ``attr`` (grad or data) in ``_flat_jax``'s
    layout."""
    get = lambda p: getattr(p, attr).detach().numpy()
    out = {k: get(getattr(model, k)) for k in ("wte", "wpe", "lnf_scale", "lnf_bias")}
    for name, _ in model.blocks[0].named_parameters():
        out[f"blocks.{name}"] = np.stack([get(getattr(b, name)) for b in model.blocks])
    return out


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_grads(params_of, batch):
    cache = {}

    def get(case):
        if case not in cache:
            impl, dtype, chunk, masked, widths = CASES[case]
            jcfg, _ = _configs(impl, dtype, chunk, widths)
            fn = jax.jit(jax.value_and_grad(lambda p, b: jax_gpt2.loss_fn(p, b, jcfg)))
            loss, grads = fn(params_of(widths), _batch(*batch, masked))
            cache[case] = float(loss), _flat_jax(jax.tree.map(np.asarray, grads))
        return cache[case]

    return get


def _port_loss_and_grads(np_params, cfg, b):
    model = gpt2_params_from_jax(np_params, cfg, device="cpu")
    loss = gpt2.loss_fn(model, _torch_batch(b))
    loss.backward()
    return model, loss.item(), _flat_port(model)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(params_of, batch, jax_grads, case):
    impl, dtype, chunk, masked, widths = CASES[case]
    _, cfg = _configs(impl, dtype, chunk, widths)
    ref_loss, ref = jax_grads(case)
    model, loss, grads = _port_loss_and_grads(params_of(widths), cfg, _batch(*batch, masked))
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert abs(loss - ref_loss) <= TOL[dtype]["loss"], (loss, ref_loss)
    assert set(grads) == set(ref)
    errs = {k: _rel_err(grads[k], ref[k]) for k in ref}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL[dtype]["grad"], (worst, errs[worst])


def test_remat_matches_no_remat(np_params, batch):
    """remat=True recomputes each block in the backward (each block's
    forward runs twice) and gives the same loss and gradients bit for bit:
    the recomputation is the same arithmetic."""
    b = _batch(*batch, masked=True)
    runs = {}
    for remat in (False, True):
        _, cfg = _configs("flash", torch.float32)
        model = gpt2_params_from_jax(np_params, dataclasses.replace(cfg, remat=remat), "cpu")
        calls = []
        for blk in model.blocks:
            blk.register_forward_pre_hook(lambda *_: calls.append(1))
        loss = gpt2.loss_fn(model, _torch_batch(b))
        loss.backward()
        runs[remat] = (loss.item(), _flat_port(model), len(calls))
    assert runs[False][2] == 2 and runs[True][2] == 4
    assert runs[True][0] == runs[False][0]
    for k, g in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][k], g, err_msg=k)


def test_adamw_steps_match_optax(np_params, batch):
    """Three steps of ``compile_train_step`` with the port's
    ``adamw(3e-4, weight_decay=0.1)`` against ``optax.adamw`` on the f32
    tiny config: the parameters after three updates and each step's
    ``grad_norm`` against ``optax.global_norm`` (1e-5 relative).

    Adam moves a parameter by about lr a step whatever its gradient's size,
    and where a gradient is zero up to rounding (the key bias: softmax
    ignores a shift of all of a row's scores) it scales the two frameworks'
    rounding noise by up to 1/eps.  So parameters are held elementwise to
    5e-2 lr (measured worst 1.6e-2 lr, in ``out_kernel``); a weight decay of
    1e-2 instead of 0.1 moves the norm scales (near 1) by 0.27 lr."""
    jcfg, cfg = _configs("dense", torch.float32)
    b = _batch(*batch, masked=False)
    opt = optax.adamw(3e-4, weight_decay=0.1)

    def three_steps(params, b):
        state, norms = opt.init(params), []
        for _ in range(3):
            grads = jax.grad(lambda p: jax_gpt2.loss_fn(p, b, jcfg))(params)
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            norms.append(optax.global_norm(grads))
        return params, norms

    ref_params, ref_norms = jax.jit(three_steps)(np_params, b)
    ref_params = _flat_jax(jax.tree.map(np.asarray, ref_params))

    model = gpt2_params_from_jax(np_params, cfg, device="cpu")
    step = compile_train_step(gpt2.loss_fn, adamw(model.parameters(), 3e-4, weight_decay=0.1))
    state, norms = TrainState(0, model), []
    for _ in range(3):
        state, metrics = step(state, _torch_batch(b))
        norms.append(float(metrics["grad_norm"]))
    assert state.step == 3
    np.testing.assert_allclose(norms, np.asarray(ref_norms), rtol=1e-5)
    params = _flat_port(state.params, "data")
    start = _flat_jax(np_params)
    for k, ref in ref_params.items():
        assert not np.array_equal(params[k], start[k]), k
        np.testing.assert_allclose(params[k], ref, rtol=0, atol=5e-2 * 3e-4, err_msg=k)


def test_adamw_defaults_are_optax():
    """torch's AdamW decays by 1e-2 by default, optax's by 1e-4."""
    opt = adamw([torch.zeros(2, requires_grad=True)], 1e-3)
    ref = inspect.signature(optax.adamw).parameters
    assert opt.defaults["weight_decay"] == ref["weight_decay"].default == 1e-4
    assert opt.defaults["betas"] == (ref["b1"].default, ref["b2"].default)
    assert opt.defaults["eps"] == ref["eps"].default


def test_matmul_f32_backward_matches_vjp():
    """bf16 operands, f32 cotangent.  JAX's gradient is the f32 cotangent
    times the other operand widened to f32, rounded once to bf16; the port
    splits the cotangent into two bf16 terms (a residual below 2^-16
    relative), so at least 99% of elements are JAX's bit for bit (rounding
    the cotangent to bf16 instead leaves about 58%) and every element is
    within one bf16 ulp (2^-7 relative), or, where the sum cancels to near 0,
    within 1e-5 of the gradient's largest element."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 64, 128)).astype(np.float32)
    b = (rng.standard_normal((128, 512)) * 0.02).astype(np.float32)
    g = (rng.standard_normal((2, 64, 512)) * 1e-3).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    out, vjp = jax.vjp(
        lambda x, w: jnp.einsum("bse,ev->bsv", x, w, preferred_element_type=jnp.float32), ja, jb
    )
    ref = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g))]
    ta = torch.from_numpy(a).bfloat16().requires_grad_()
    tb = torch.from_numpy(b).bfloat16().requires_grad_()
    o = matmul_f32(ta, tb)
    assert o.dtype == torch.float32
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), atol=1e-6, rtol=1e-6)
    o.backward(torch.from_numpy(g))
    for name, t, r in (("da", ta.grad, ref[0]), ("db", tb.grad, ref[1])):
        assert t.dtype == torch.bfloat16, name
        x = t.float().numpy()
        assert (x == r).mean() >= 0.99, (name, (x == r).mean())
        np.testing.assert_allclose(x, r, rtol=2**-7, atol=1e-5 * np.abs(r).max(), err_msg=name)
