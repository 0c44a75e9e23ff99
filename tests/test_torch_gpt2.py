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
from ray_tpu.parallel import mesh as jax_mesh
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


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    """The JAX package keeps a process-wide current mesh, which its own
    tests leave set in the worker that ran them; its flash attention then
    shards over that mesh.  The references here are single-device."""
    jax_mesh.set_current_mesh(None)


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
            out, _ = _port(np_params, cfg).blocks[0](torch.from_numpy(x).bfloat16())
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

    def test_unported_options_raise(self, np_params):
        """Every attention_impl of the reference is ported and an unknown
        one raises: "ring" with no mesh is dense attention (the reference's
        semantics), logits bit for bit."""
        with pytest.raises(ValueError, match="attention_impl"):
            gpt2.GPT2(gpt2.GPTConfig.tiny(attention_impl="paged"), device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 16)))
        ring, dense = (gpt2_params_from_jax(np_params, gpt2.GPTConfig.tiny(attention_impl=impl), "cpu")
                       for impl in ("ring", "dense"))
        with torch.no_grad():
            assert torch.equal(ring(tokens), dense(tokens))

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
    flash = fa.flash_attention_bhsd

    def counted(q, k, v, scale=None):
        calls.append(tuple(q.shape))
        return flash(q, k, v, scale)

    # the model reaches it through sharded_flash_attention_bhsd
    monkeypatch.setattr(fa, "flash_attention_bhsd", counted)
    model = gpt2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        out = model(torch.randint(0, 256, (2, 128), generator=torch.Generator().manual_seed(1)))
    assert torch.isfinite(out).all()
    assert calls == [(2, heads, 128, cfg.head_dim)] * cfg.num_layers


# --- Mixture-of-Experts (num_experts > 0): the switch MLP of every block ---
#
# The tiny config with 4 experts, weights drawn as above (router included).
# Capacity factor 1.25 (C = 40 of 128 tokens a row) and, for the overflow
# case, 0.25 (C = 8: most tokens of a row pass an expert's buffer and take
# only the residual).  f32: the same arithmetic up to summation order, held
# to F32_TOL (logits, losses) and MOE_F32_GRAD (gradients, relative to each
# leaf's norm; measured worst 1.6e-6, in the router).  bf16: a token whose
# two top router probabilities lie within a bf16 rounding of each other can
# choose another expert in either framework, and the tiny router's
# probabilities are near 1/4 each, so both frameworks' bf16 gradients stand
# 1-10% from the f32 gradients (the reference's own: up to 9.6%, in
# moe_in).  So the port's bf16 gradients (and logits) are held to the
# reference's f32 ones, at most MOE_BF16_RATIO times as far as the
# reference's bf16 ones are (gradients: or the bf16 gradient tolerance of
# the training tests, 3e-2, whichever is larger), and the bf16 loss to
# BF16_TOL["loss"].
MOE_EXPERTS = 4
MOE_F32_GRAD = 1e-5
MOE_BF16_RATIO = 1.25
MOE_BF16_GRAD_FLOOR = 3e-2
MOE_CAPACITY = {"cap1.25": 1.25, "cap0.25": 0.25}


def _moe_configs(dtype, cap="cap1.25", **kw):
    return _configs(dtype, num_experts=MOE_EXPERTS,
                    moe_capacity_factor=MOE_CAPACITY[cap], **kw)


@pytest.fixture(scope="module")
def moe_params():
    jcfg = jax_gpt2.GPTConfig.tiny(num_experts=MOE_EXPERTS)
    shapes = jax.eval_shape(lambda: jax_gpt2.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)

    def draw(path, s):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _moe_flat_grads(model):
    out = {k: getattr(model, k).grad.numpy() for k in ("wte", "wpe", "lnf_scale", "lnf_bias")}
    for name, _ in model.blocks[0].named_parameters():
        out[f"blocks.{name}"] = np.stack([getattr(b, name).grad.numpy() for b in model.blocks])
    return out


def _jax_flat(tree):
    out = {k: np.asarray(tree[k]) for k in ("wte", "wpe", "lnf_scale", "lnf_bias")}
    out.update({f"blocks.{k}": np.asarray(v) for k, v in tree["blocks"].items()})
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def moe_jax(moe_params, batch):
    """(dtype, cap, masked) → the reference's logits, loss and gradients."""
    cache = {}

    def get(dtype, cap, masked):
        key = (dtype, cap, masked)
        if key not in cache:
            jcfg, _ = _moe_configs(dtype, cap, attention_impl="flash")
            tokens, mask = batch
            b = {"tokens": tokens, **({"mask": mask} if masked else {})}

            def program(p):
                loss, grads = jax.value_and_grad(lambda q: jax_gpt2.loss_fn(q, b, jcfg))(p)
                return jax_gpt2.forward(p, tokens[:, :-1], jcfg), loss, grads

            logits, loss, grads = jax.jit(program)(moe_params)
            cache[key] = np.asarray(logits), float(loss), _jax_flat(jax.tree.map(np.asarray, grads))
        return cache[key]

    return get


def _moe_port(moe_params, dtype, cap, masked, batch):
    _, cfg = _moe_configs(dtype, cap, attention_impl="flash")
    tokens, mask = batch
    model = gpt2_params_from_jax(moe_params, cfg, device="cpu")
    with torch.inference_mode():
        logits = model(torch.from_numpy(tokens[:, :-1]).long())
    b = {"tokens": torch.from_numpy(tokens)}
    if masked:
        b["mask"] = torch.from_numpy(mask)
    loss = gpt2.loss_fn(model, b)
    loss.backward()
    return logits.numpy(), loss.item(), _moe_flat_grads(model)


@pytest.mark.parametrize("cap,masked", [("cap1.25", False), ("cap1.25", True), ("cap0.25", False)],
                         ids=["aux", "aux-mask", "overflow"])
def test_moe_matches_jax_f32(moe_params, batch, moe_jax, cap, masked):
    """Logits, loss with the aux term (and with a mask, which takes padding
    tokens out of the routing) and every gradient, router included."""
    ref_logits, ref_loss, ref_grads = moe_jax(torch.float32, cap, masked)
    logits, loss, grads = _moe_port(moe_params, torch.float32, cap, masked, batch)
    np.testing.assert_allclose(logits, ref_logits, **F32_TOL)
    np.testing.assert_allclose(loss, ref_loss, **F32_TOL)
    assert set(grads) == set(ref_grads) and "blocks.router" in grads
    errs = {k: _rel(grads[k], ref_grads[k]) for k in ref_grads}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= MOE_F32_GRAD, (worst, errs[worst])


@pytest.mark.parametrize("masked", [False, True], ids=["aux", "aux-mask"])
def test_moe_matches_jax_bf16(moe_params, batch, moe_jax, masked):
    ref_logits, ref_loss, ref_grads = moe_jax(torch.bfloat16, "cap1.25", masked)
    f32_logits, _, f32_grads = moe_jax(torch.float32, "cap1.25", masked)
    logits, loss, grads = _moe_port(moe_params, torch.bfloat16, "cap1.25", masked, batch)
    # A token routed to another expert moves its logits past BF16_TOL (up
    # to 0.064 measured, 0.16% of the elements): at least 99% stay within
    # it, and the whole block is no farther from f32 than MOE_BF16_RATIO
    # times the reference's own bf16 distance.
    near = np.isclose(logits, ref_logits, **BF16_TOL["logits"])
    assert near.mean() >= 0.99, near.mean()
    assert _rel(logits, f32_logits) <= MOE_BF16_RATIO * _rel(ref_logits, f32_logits)
    np.testing.assert_allclose(loss, ref_loss, **BF16_TOL["loss"])
    for k, g32 in f32_grads.items():
        bound = max(MOE_BF16_RATIO * _rel(ref_grads[k], g32), MOE_BF16_GRAD_FLOOR)
        assert _rel(grads[k], g32) <= bound, (k, _rel(grads[k], g32), bound)


def test_moe_capacity_overflow_drops_tokens(moe_params, batch):
    """At capacity factor 0.25 (C = 8 of 128) tokens overflow their
    expert's buffer; an overflowed token's MoE output is exactly zero, so
    the block passes it through the residual, and each buffer holds at most
    C tokens of a row."""
    _, cfg = _moe_configs(torch.float32, "cap0.25")
    blk = gpt2_params_from_jax(moe_params, cfg, device="cpu").blocks[0]
    h = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 128, 64)).astype(np.float32))
    C = gpt2.moe_capacity(cfg, 128)
    assert C == 8
    with torch.inference_mode():
        _, _, expert, onehot, pos = gpt2.moe_route(h, blk.router, cfg)
        out, aux = gpt2._moe_mlp(h, blk.router, blk.moe_in, blk.moe_out, cfg)
    dropped = pos.amax(dim=-1) >= C
    assert 0 < int(dropped.sum()) < dropped.numel()
    assert torch.all(out[dropped] == 0) and torch.all(out[~dropped].abs().sum(-1) > 0)
    kept = onehot * ((pos >= 0) & (pos < C))
    assert int(kept.sum(dim=1).amax()) <= C
    jcfg, _ = _moe_configs(torch.float32, "cap0.25")
    layer0 = jax.tree.map(lambda a: a[0], moe_params["blocks"])
    ref_out, ref_aux = jax.jit(lambda h, p: jax_gpt2._moe_mlp(h, p, jcfg))(h.numpy(), layer0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **F32_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), **F32_TOL)


@pytest.mark.parametrize("name", ["tiny", "gpt2_124m"])
def test_moe_counts_match_jax(name):
    for experts in (1, 4, 8):
        jcfg = getattr(jax_gpt2.GPTConfig, name)(num_experts=experts)
        cfg = getattr(gpt2.GPTConfig, name)(num_experts=experts)
        assert gpt2.num_params(cfg) == jax_gpt2.num_params(jcfg)
        assert gpt2.flops_per_token(cfg, 512) == jax_gpt2.flops_per_token(jcfg, 512)
