"""The port's GPT-2 (ray_tpu_torch.models) against the JAX package.

Weights are drawn with numpy in the shapes of the JAX ``init`` pytree and
cross to the port through ``gpt2_params_from_jax``; tokens and masks come
from a numpy seed.  Biases and norm parameters are drawn too (``init`` sets
them to 0 and 1), so that their layout is checked as well.  The JAX side
runs jitted, flash attention as its Pallas kernel in interpret mode; the
port's side runs the kernel's plain version (both on the CPU).  The tiny
config's head dim is 16, which only the plain version takes; the ``d64``
cases widen it to 256 wide and 4 heads, the head dim the card's kernels
take, so that the flash branch is certified at a shape the card runs.

Tolerances: f32 configs agree to summation order, so 1e-5.  In bf16 both
sides round every product, activation and residual add to bf16, but the two
frameworks may sum a product's terms in another order and so round the other
way by one bf16 ulp (2^-8 relative); such flips, carried through two layers,
move logits of size ~0.5 by up to a few 1e-3, so bf16 logits are held to
2e-2 and the loss, a mean over 256 tokens, to 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import common as jax_common
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu_torch.models import common, gpt2
from ray_tpu_torch.models.convert import gpt2_params_from_jax

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = {"logits": dict(atol=2e-2, rtol=2e-2), "loss": dict(atol=2e-3, rtol=0)}
_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# Widths on top of the tiny config: "" is tiny itself (D = 16), "d64" the
# head dim the card's kernels take.
WIDTHS = {"": {}, "d64": dict(embed_dim=256, num_heads=4)}
# (impl, dtype, widths) → outputs compared; each key is one jitted JAX
# program.  Every attention path is compared with and without a mask and
# with the chunked cross-entropy.
CASES = {
    ("flash", torch.float32, ""): ("logits", "loss", "loss_mask_chunk"),
    ("dense", torch.float32, ""): ("logits", "loss_mask", "loss_chunk"),
    ("flash", torch.bfloat16, ""): ("logits", "loss_mask"),
    ("flash", torch.float32, "d64"): ("logits", "loss_mask"),
    ("flash", torch.bfloat16, "d64"): ("logits", "loss"),
}


def _configs(dtype, widths="", **kw):
    """The same tiny config in both packages."""
    kw.update(WIDTHS[widths])
    return (
        jax_gpt2.GPTConfig.tiny(dtype=_JAX_DTYPE[dtype], **kw),
        gpt2.GPTConfig.tiny(dtype=dtype, **kw),
    )


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


def _loss_inputs(output, tokens, mask):
    """(batch dict for loss_fn, whether xent_chunk is set) of one loss output."""
    b = {"tokens": tokens}
    if "mask" in output:
        b["mask"] = mask
    return b, output.endswith("chunk")


@pytest.fixture(scope="module")
def jax_refs(params_of, batch):
    cache = {}

    def get(impl, dtype, widths):
        key = (impl, dtype, widths)
        if key not in cache:
            jcfg, _ = _configs(dtype, widths, attention_impl=impl)
            chunked = dataclasses.replace(jcfg, xent_chunk=32)

            def program(params, tokens, mask):
                out = {}
                for name in CASES[key]:
                    if name == "logits":
                        out[name] = jax_gpt2.forward(params, tokens[:, :-1], jcfg)
                    else:
                        b, chunk = _loss_inputs(name, tokens, mask)
                        out[name] = jax_gpt2.loss_fn(params, b, chunked if chunk else jcfg)
                return out

            cache[key] = jax.tree.map(
                np.asarray, jax.jit(program)(params_of(widths), *batch)
            )
        return cache[key]

    return get


def _port(np_params, config):
    return gpt2_params_from_jax(np_params, config, device="cpu")


@pytest.mark.parametrize("impl,dtype,widths,output", [
    pytest.param(impl, dtype, widths, output,
                 id="-".join(filter(None, (impl, widths, str(dtype)[6:], output))))
    for (impl, dtype, widths), outs in CASES.items() for output in outs
])
def test_model_matches_jax(params_of, batch, jax_refs, impl, dtype, widths, output):
    ref = jax_refs(impl, dtype, widths)[output]
    np_params = params_of(widths)
    tokens, mask = batch
    _, cfg = _configs(dtype, widths, attention_impl=impl)
    with torch.inference_mode():
        if output == "logits":
            out = _port(np_params, cfg)(torch.from_numpy(tokens[:, :-1]).long())
            assert out.shape == (2, 128, 256)
        else:
            b, chunk = _loss_inputs(output, tokens, mask)
            if chunk:
                cfg = dataclasses.replace(cfg, xent_chunk=32)
            b = {k: torch.from_numpy(v) for k, v in b.items()}
            out = gpt2.loss_fn(_port(np_params, cfg), b)
    assert out.dtype == torch.float32
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL[output.split("_")[0]]
    np.testing.assert_allclose(out.numpy(), ref, **tol)


class TestParityTraps:
    def test_gelu_is_tanh_approximation(self):
        x = np.linspace(-6, 6, 1001, dtype=np.float32)
        ref = np.asarray(jax.nn.gelu(x))
        np.testing.assert_allclose(common.gelu(torch.from_numpy(x)).numpy(), ref,
                                   atol=1e-6, rtol=1e-6)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
    def test_layernorm_matches_jax(self, dtype):
        """Population variance, f32 statistics, result in x.dtype (bf16:
        one rounding of nearly equal f32 values, so within a bf16 ulp)."""
        rng = np.random.default_rng(1)
        x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
        scale, bias = rng.standard_normal((2, 64)).astype(np.float32)
        jx = jnp.asarray(x, _JAX_DTYPE[dtype])
        ref = np.asarray(jax_common.layernorm(jx, scale, bias).astype(jnp.float32))
        out = common.layernorm(torch.from_numpy(x).to(dtype), *map(torch.from_numpy, (scale, bias)))
        assert out.dtype == dtype
        tol = F32_TOL if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(out.float().numpy(), ref, **tol)

    def test_embedding_bitwise_in_bf16(self, np_params, batch):
        """Table cast to bf16, then the position add in bf16: bit for bit."""
        jcfg, cfg = _configs(torch.bfloat16)
        tokens = batch[0][:, :128]
        p = np_params
        ref = (jnp.asarray(p["wte"]).astype(jcfg.dtype)[tokens]
               + jnp.asarray(p["wpe"]).astype(jcfg.dtype)[:128])
        with torch.inference_mode():
            out = _port(np_params, cfg).embed(torch.from_numpy(tokens).long())
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))

    def test_block_rounds_like_reference_in_bf16(self, np_params):
        """One dense block in bf16: products, bias and residual adds round
        to bf16 where the reference rounds, so almost every element is bit
        for bit the reference's (94% here; the rest differ by an ulp from
        summation order).  Residual adds kept in f32 and rounded once would
        leave about 58% equal."""
        jcfg, cfg = _configs(torch.bfloat16)
        x = np.random.default_rng(2).standard_normal((2, 128, 64)).astype(np.float32)
        layer0 = jax.tree.map(lambda a: a[0], np_params["blocks"])
        ref, _ = jax.jit(lambda x, p: jax_gpt2._block(x, p, jcfg))(jnp.asarray(x, jnp.bfloat16), layer0)
        ref = np.asarray(ref.astype(jnp.float32))
        with torch.inference_mode():
            out = _port(np_params, cfg).blocks[0](torch.from_numpy(x).bfloat16())
        assert out.dtype == torch.bfloat16
        out = out.float().numpy()
        assert (out == ref).mean() > 0.85
        np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)

    def test_head_logits_f32_from_bf16_operands(self, np_params):
        """bf16 features and table, f32 accumulation and f32 logits: a bf16
        rounding of the logits (2^-9 relative) would fail 1e-5."""
        jcfg, cfg = _configs(torch.bfloat16)
        x = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(np.float32)
        ref = jax_gpt2._head(np_params, jnp.asarray(x, jnp.bfloat16), jcfg)
        with torch.inference_mode():
            out = _port(np_params, cfg).head(torch.from_numpy(x).bfloat16())
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


class TestConfig:
    @pytest.mark.parametrize("name", ["tiny", "gpt2_124m"])
    def test_counts_match_jax(self, name):
        jcfg = getattr(jax_gpt2.GPTConfig, name)()
        cfg = getattr(gpt2.GPTConfig, name)()
        assert gpt2.num_params(cfg) == jax_gpt2.num_params(jcfg)
        assert gpt2.flops_per_token(cfg, 512) == jax_gpt2.flops_per_token(jcfg, 512)

    def test_unported_options_raise(self):
        with pytest.raises(NotImplementedError):
            gpt2.GPT2(gpt2.GPTConfig.tiny(num_experts=2), device="cpu")
        with pytest.raises(NotImplementedError):
            gpt2.GPT2(gpt2.GPTConfig.tiny(attention_impl="ring"), device="cpu")

    def test_convert_rejects_wrong_shapes(self, np_params):
        cfg = gpt2.GPTConfig.tiny(embed_dim=32)
        with pytest.raises(ValueError, match="shape"):
            gpt2_params_from_jax(np_params, cfg, device="cpu")


@pytest.mark.parametrize("embed_dim,heads,dtype", [
    (64, 4, torch.float32),      # the tiny config: D = 16
    (256, 4, torch.float32),     # D = 64
    (256, 2, torch.bfloat16),    # D = 128
    (128, 4, torch.bfloat16),    # D = 32
])
def test_flash_config_calls_the_flash_wrapper_at_any_head_dim(monkeypatch, embed_dim, heads, dtype):
    """A flash config sends every layer's attention through
    ``flash_attention_bhsd`` whatever its head dim: the model never routes
    a shape the kernels refuse to dense attention.  On the CPU the wrapper
    runs its plain version; on the card it raises for D not in (64, 128)."""
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = gpt2.GPTConfig.tiny(attention_impl="flash", embed_dim=embed_dim, num_heads=heads, dtype=dtype)
    calls = []

    def counted(q, k, v, scale=None):
        calls.append(tuple(q.shape))
        return fa.flash_attention_bhsd(q, k, v, scale)

    monkeypatch.setattr(gpt2, "flash_attention_bhsd", counted)
    model = gpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        out = model(torch.randint(0, 256, (2, 128), generator=torch.Generator().manual_seed(1)))
    assert torch.isfinite(out).all()
    assert calls == [(2, heads, 128, cfg.head_dim)] * cfg.num_layers
