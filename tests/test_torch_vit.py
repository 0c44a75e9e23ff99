"""The port's ViT (ray_tpu_torch.models.vit) against the JAX package.

Weights are drawn with numpy in the shapes of the JAX ``init`` pytree
(norms near 1, biases near 0, all perturbed) and cross to the port through
``vit_params_from_jax``; images and labels come from a numpy seed.  Each
case is one jitted JAX program (logits, ``jax.value_and_grad`` of
``loss_fn``) at ``ViTConfig.tiny()``: 32×32×3 images, patch 8 (16 patch
tokens), 2 layers of width 64 and 4 heads, 128 classes.

Tolerances, as the GPT-2 parity tests state them: f32 agrees to summation
order (logits and loss 1e-5; gradients relative to each leaf's norm,
measured worst 3.5e-7, held to 1e-5).  In bf16 both sides round every
product, activation and residual add to bf16, and a summation-order
difference flips a rounding by one ulp (2^-8 relative) now and then:
logits held to 2e-2, the loss to 2e-3, gradients to 3e-2 of their norm
(measured worst 2.4e-2, in ``qkv_bias``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jax_vit
from ray_tpu_torch.models import vit
from ray_tpu_torch.models.convert import vit_params_from_jax

_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {
    torch.float32: {"logits": dict(atol=1e-5, rtol=1e-5), "loss": 1e-5, "grad": 1e-5},
    torch.bfloat16: {"logits": dict(atol=2e-2, rtol=2e-2), "loss": 2e-3, "grad": 3e-2},
}
TOP = ("patch_kernel", "patch_bias", "pos_embed", "lnf_scale", "lnf_bias",
       "head_kernel", "head_bias")


def _configs(dtype, **kw):
    return (jax_vit.ViTConfig.tiny(dtype=_JAX_DTYPE[dtype], **kw),
            vit.ViTConfig.tiny(dtype=dtype, **kw))


@pytest.fixture(scope="module")
def np_params():
    shapes = jax.eval_shape(lambda: jax_vit.init(jax.random.key(0), jax_vit.ViTConfig.tiny()))
    rng = np.random.default_rng(0)

    def draw(path, s):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 128, (4,)).astype(np.int32)
    return {"images": images, "labels": labels}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat_jax(tree):
    out = {k: np.asarray(tree[k]) for k in TOP}
    out.update({f"blocks.{k}": np.asarray(v) for k, v in tree["blocks"].items()})
    return out


def _flat_grads(model):
    out = {k: getattr(model, k).grad.numpy() for k in TOP}
    for name, _ in model.blocks[0].named_parameters():
        out[f"blocks.{name}"] = np.stack([getattr(b, name).grad.numpy() for b in model.blocks])
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_patchify_matches_jax(batch):
    """(B, H, W, C) → (B, n·n, P·P·C) in the reference's (n, n, P, P, C)
    order: a reshuffle, so bit for bit."""
    cfg = vit.ViTConfig.tiny()
    out = vit.patchify(torch.from_numpy(batch["images"]), cfg)
    ref = jax_vit.patchify(batch["images"], jax_vit.ViTConfig.tiny())
    assert out.shape == (4, cfg.num_patches, cfg.patch_dim) == (4, 16, 192)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_vit_matches_jax(np_params, batch, dtype):
    """Logits, loss and every gradient from the same converted weights."""
    jcfg, cfg = _configs(dtype)

    def program(p, b):
        loss, grads = jax.value_and_grad(lambda q: jax_vit.loss_fn(q, b, jcfg))(p)
        return jax_vit.forward(p, b["images"], jcfg), loss, grads

    ref_logits, ref_loss, ref_grads = jax.jit(program)(np_params, batch)
    ref_grads = _flat_jax(jax.tree.map(np.asarray, ref_grads))
    model = vit_params_from_jax(np_params, cfg, device="cpu")
    b = _torch_batch(batch)
    with torch.inference_mode():
        logits = model(b["images"])
    assert logits.dtype == torch.float32 and logits.shape == (4, 128)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL[dtype]["logits"])
    loss = vit.loss_fn(model, b)
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= TOL[dtype]["loss"]
    grads = _flat_grads(model)
    assert set(grads) == set(ref_grads)
    errs = {k: _rel(grads[k], ref_grads[k]) for k in ref_grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL[dtype]["grad"], (worst, errs[worst])


def test_accuracy_matches_jax(np_params, batch):
    jcfg, cfg = _configs(torch.float32)
    ref = float(jax.jit(lambda p, b: jax_vit.accuracy(p, b, jcfg))(np_params, batch))
    with torch.inference_mode():
        acc = vit.accuracy(vit_params_from_jax(np_params, cfg, device="cpu"), _torch_batch(batch))
    assert float(acc) == ref


def test_remat_matches_no_remat(np_params, batch):
    """remat=True recomputes each block in the backward (each block's
    forward runs twice) and gives the same loss and gradients bit for bit."""
    runs = {}
    for remat in (False, True):
        _, cfg = _configs(torch.bfloat16)
        model = vit_params_from_jax(np_params, dataclasses.replace(cfg, remat=remat), "cpu")
        calls = []
        for blk in model.blocks:
            blk.register_forward_pre_hook(lambda *_: calls.append(1))
        loss = vit.loss_fn(model, _torch_batch(batch))
        loss.backward()
        runs[remat] = (loss.item(), _flat_grads(model), len(calls))
    assert runs[False][2] == 2 and runs[True][2] == 4
    assert runs[True][0] == runs[False][0]
    for k, g in runs[False][1].items():
        np.testing.assert_array_equal(runs[True][1][k], g, err_msg=k)


@pytest.mark.parametrize("name", ["tiny", "vit_b16"])
def test_num_params_matches_jax(name):
    cfg = getattr(vit.ViTConfig, name)()
    assert vit.num_params(cfg) == jax_vit.num_params(getattr(jax_vit.ViTConfig, name)())
    assert vit.num_params(cfg) == sum(p.numel() for p in vit.ViT(cfg, "meta").parameters())


def test_init_draws_the_reference_layout():
    """init: norms at (1, 0), biases 0, the drawn leaves near the
    reference's standard deviations."""
    cfg = vit.ViTConfig.tiny(num_layers=4)
    model = vit.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.all(model.lnf_scale == 1) and torch.all(model.head_bias == 0)
    for blk in model.blocks:
        assert torch.all(blk.ln1_scale == 1) and torch.all(blk.fc_bias == 0)
    assert abs(model.patch_kernel.std().item() - 0.02) < 2e-3
    assert abs(model.pos_embed.std().item() - 0.01) < 1e-3
    resid = 0.02 / np.sqrt(2 * cfg.num_layers)
    assert abs(model.blocks[0].out_kernel.std().item() - resid) < 1e-3


def test_vit_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vit.ViT(vit.ViTConfig.tiny())
