"""The port's Llama (ray_tpu_torch.models.llama) against the JAX package.

Weights are drawn with numpy in the shapes of the JAX ``init`` pytree (norm
scales near 1, matrices N(0, 0.1) so that attention is far from uniform)
and cross to the port through ``llama_params_from_jax``; tokens come from
numpy seeds.  The JAX side runs jitted on the CPU, each program compiled
once per module.

Tolerances: f32 runs the same arithmetic up to summation order (the port's
grouped attention adds exact zeros in another order), so logits and losses
are held to 1e-5 and greedy tokens must be equal.  bf16: the port rounds
every product, activation and residual add to bf16 where the reference's
source does.  XLA does not always: by default (excess precision allowed)
it feeds the second RMSNorm the residual sum unrounded, and its bf16
sigmoid rounds otherwise than torch's; the reference itself moves by up to
0.037 (mean 0.0054) on these logits of size up to 3 when compiled with
``xla_allow_excess_precision`` off, and the port lies within 0.031 (mean
0.0056) of it either way.  So bf16 logits are held to 5e-2 at most and
1e-2 on average, and the loss, a mean over 64 tokens, to 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import llama_params_from_jax

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = {"logits": dict(atol=5e-2, rtol=0), "loss": dict(atol=2e-3, rtol=0)}
BF16_MEAN_ABS = 1e-2
_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _configs(dtype=torch.float32, **kw):
    """The same tiny config in both packages."""
    return (
        jax_llama.LlamaConfig.tiny(dtype=_JAX_DTYPE[dtype], **kw),
        llama.LlamaConfig.tiny(dtype=dtype, **kw),
    )


def _draw_params(cfg, seed):
    shapes = jax.eval_shape(lambda: jax_llama.init(jax.random.key(0), cfg))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        base = 1.0 if "norm" in jax.tree_util.keystr(path) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def np_params():
    return _draw_params(jax_llama.LlamaConfig.tiny(), 0)


def _port(np_params, cfg):
    return llama_params_from_jax(np_params, cfg, device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.int32)


def _close(out, ref, tol=F32_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32),
                               err_msg=msg, **tol)


# (dtype, window) → outputs compared; each key is one jitted JAX program.
CASES = {
    (torch.float32, 0): ("logits", "loss", "loss_mask_chunk"),
    (torch.float32, 4): ("logits", "loss_mask"),
    (torch.bfloat16, 0): ("logits", "loss_mask"),
}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    return _tokens((2, 33), 1), (rng.random((2, 32)) < 0.7).astype(np.float32)


@pytest.fixture(scope="module")
def jax_refs(np_params, batch):
    cache = {}

    def get(dtype, window):
        if (dtype, window) not in cache:
            jcfg, _ = _configs(dtype, sliding_window=window)

            def program(params, tokens, mask):
                out = {}
                for name in CASES[(dtype, window)]:
                    if name == "logits":
                        out[name] = jax_llama.forward(params, tokens[:, :-1], jcfg)
                        continue
                    b = {"tokens": tokens, **({"mask": mask} if "mask" in name else {})}
                    c = dataclasses.replace(jcfg, xent_chunk=8) if name.endswith("chunk") else jcfg
                    out[name] = jax_llama.loss_fn(params, b, c)
                return out

            cache[(dtype, window)] = jax.tree.map(np.asarray, jax.jit(program)(np_params, *batch))
        return cache[(dtype, window)]

    return get


@pytest.mark.parametrize("dtype,window,output", [
    pytest.param(d, w, o, id=f"{str(d)[6:]}-w{w}-{o}") for (d, w), outs in CASES.items() for o in outs
])
def test_model_matches_jax(np_params, batch, jax_refs, dtype, window, output):
    ref = jax_refs(dtype, window)[output]
    tokens, mask = batch
    _, cfg = _configs(dtype, sliding_window=window)
    if output.endswith("chunk"):
        cfg = dataclasses.replace(cfg, xent_chunk=8)
    model = _port(np_params, cfg)
    with torch.inference_mode():
        if output == "logits":
            out = model(torch.from_numpy(tokens[:, :-1]))
            assert out.shape == (2, 32, 256)
        else:
            b = {"tokens": torch.from_numpy(tokens)}
            if "mask" in output:
                b["mask"] = torch.from_numpy(mask)
            out = llama.loss_fn(model, b)
    assert out.dtype == torch.float32
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL[output.split("_")[0]]
    _close(out, ref, tol)
    if dtype == torch.bfloat16:
        assert np.abs(out.numpy() - ref).mean() < BF16_MEAN_ABS


class TestParityTraps:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
    def test_rmsnorm_and_rope_match_jax(self, dtype):
        """f32 statistics and RoPE angles, one rounding to x.dtype (bf16:
        within an ulp).  Positions up to 30,000 exercise the frequencies'
        f32 rounding: theta ** (-i / half) in place of the reference's
        exp(-log(theta) * i / half) moves these angles by up to ~1e-2."""
        rng = np.random.default_rng(2)
        x = (rng.standard_normal((2, 5, 3, 64)) * 3 + 1).astype(np.float32)
        scale = rng.standard_normal(64).astype(np.float32)
        pos = rng.integers(0, 30000, (2, 5))
        jx = jnp.asarray(x, _JAX_DTYPE[dtype])
        tx = torch.from_numpy(x).to(dtype)
        tol = F32_TOL if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)
        out = llama._rmsnorm(tx, torch.from_numpy(scale), 1e-5)
        assert out.dtype == dtype
        _close(out.float(), jax_llama._rmsnorm(jx, scale, 1e-5).astype(jnp.float32), tol)
        out = llama._rope(tx, torch.from_numpy(pos), 1e4)
        assert out.dtype == dtype
        ref = jax_llama._rope(jx, jnp.asarray(pos), 1e4).astype(jnp.float32)
        _close(out.float(), ref, dict(atol=2e-4, rtol=2e-4) if dtype == torch.float32 else tol)

    def test_gqa_equals_mha_with_repeated_kv(self, np_params):
        """Two KV heads each serving two query heads give what four KV heads
        holding the same heads repeated (head h reads KV head h // 2) give,
        in the full forward and in the grouped cached decode."""
        _, gqa = _configs()
        mha = dataclasses.replace(gqa, num_kv_heads=4)
        rep = {**np_params, "blocks": dict(np_params["blocks"])}
        for name in ("wk", "wv"):
            rep["blocks"][name] = np.repeat(np_params["blocks"][name], 2, axis=2)
        tokens = torch.from_numpy(_tokens((2, 12), 3))
        outs = []
        with torch.inference_mode():
            for cfg, p in ((gqa, np_params), (mha, rep)):
                m = _port(p, cfg)
                cache = llama.init_cache(cfg, 2, 16, "cpu")
                llama.forward_cached(m, tokens[:, :-1], cache, 0)
                step, _ = llama.decode_step_rowwise(m, tokens[:, -1], cache, [11, 11])
                outs.append((m(tokens), step))
        _close(outs[0][0], outs[1][0], dict(atol=1e-6, rtol=1e-6))
        _close(outs[0][1], outs[1][1], dict(atol=1e-6, rtol=1e-6))


_jax_forward_cached = jax.jit(jax_llama.forward_cached, static_argnames="config")


def test_forward_cached_prefill_and_decode_match_jax(np_params):
    """Prefill (2, 8) into a 16-slot cache, then four one-token steps
    through forward_cached: logits and the cache's contents."""
    jcfg, cfg = _configs()
    tokens = _tokens((2, 12), 4)
    model = _port(np_params, cfg)
    cache = llama.init_cache(cfg, 2, 16, "cpu")
    jcache = jax_llama.init_cache(jcfg, 2, 16)
    for start, stop in ((0, 8), (8, 9), (9, 10), (10, 11), (11, 12)):
        chunk = tokens[:, start:stop]
        logits, cache = llama.forward_cached(model, torch.from_numpy(chunk), cache, start)
        ref, jcache = _jax_forward_cached(np_params, jnp.asarray(chunk), jcache, jnp.int32(start),
                                          config=jcfg)
        _close(logits, ref, msg=f"tokens {start}..{stop}")
    for name in ("k", "v"):
        _close(cache[name], jcache[name])


def test_rolling_cache_wraps_and_matches_jax(np_params):
    """Window 4 in a rolling cache of rolling_cache_len(cfg, 3) = 6 slots:
    a 3-token prefill, then ten row-wise decode steps (positions 3..12, so
    the cache wraps twice) on the reference's greedy tokens."""
    jcfg, cfg = _configs(sliding_window=4)
    T = llama.rolling_cache_len(cfg, 3)
    assert T == jax_llama.rolling_cache_len(jcfg, 3) == 6
    model = _port(np_params, cfg)
    cache = llama.init_cache(cfg, 1, T, "cpu")
    jcache = jax_llama.init_cache(jcfg, 1, T)
    prompt = _tokens((1, 3), 5)
    logits, cache = llama.forward_cached(model, torch.from_numpy(prompt), cache, 0)
    ref, jcache = _jax_forward_cached(np_params, jnp.asarray(prompt), jcache, jnp.int32(0),
                                      config=jcfg)
    for pos in range(3, 13):
        _close(logits, ref, msg=f"before position {pos}")
        nxt = np.array(jnp.argmax(ref, axis=-1), np.int32)
        logits, cache = llama.decode_step_rowwise(model, torch.from_numpy(nxt), cache, [pos])
        ref, jcache = jax_llama.decode_step_rowwise(
            np_params, jnp.asarray(nxt), jcache, jnp.asarray([pos], jnp.int32), jcfg)
    _close(logits, ref)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])


def test_rowwise_decode_and_prefill_into_slot_match_jax(np_params):
    """Prompts of 5 and 9 tokens prefilled into rows 0 and 2 of a 3-row
    cache (row 1 stays free), then four decode steps with the rows at
    positions 5.., 0 and 9..: every row's logits and the whole cache."""
    jcfg, cfg = _configs()
    model = _port(np_params, cfg)
    cache = llama.init_cache(cfg, 3, 24, "cpu")
    jcache = jax_llama.init_cache(jcfg, 3, 24)
    last = np.zeros(3, np.int32)
    for slot, n, seed in ((0, 5, 6), (2, 9, 7)):
        prompt = _tokens((1, n), seed)
        logits, cache = llama.prefill_into_slot(model, torch.from_numpy(prompt), cache, slot)
        ref, jcache = jax_llama.prefill_into_slot(np_params, jnp.asarray(prompt), jcache,
                                                  jnp.int32(slot), jcfg)
        _close(logits, ref, msg=f"prefill of slot {slot}")
        last[slot] = int(jnp.argmax(ref[0]))
    for i in range(4):
        pos = np.array([5 + i, 0, 9 + i], np.int32)
        logits, cache = llama.decode_step_rowwise(model, torch.from_numpy(last), cache, pos)
        ref, jcache = jax_llama.decode_step_rowwise(np_params, jnp.asarray(last), jcache,
                                                    jnp.asarray(pos), jcfg)
        _close(logits, ref, msg=f"decode step {i}")
        last = np.array(jnp.argmax(ref, axis=-1), np.int32)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])


@pytest.mark.parametrize("fn", ["generate", "generate_kv"])
def test_greedy_tokens_equal_jax(np_params, fn):
    jcfg, cfg = _configs()
    prompt = _tokens((2, 5), 8)
    ref = getattr(jax_llama, fn)(np_params, jnp.asarray(prompt), jcfg, max_new_tokens=8)
    out = getattr(llama, fn)(_port(np_params, cfg), prompt, max_new_tokens=8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampling_is_deterministic_for_a_seed(np_params):
    """temperature > 0 draws from the torch generator passed in: the same
    seed gives the same tokens (the reference's jax.random stream cannot be
    reproduced, so there is no reference to match)."""
    _, cfg = _configs()
    model = _port(np_params, cfg)
    prompt = _tokens((2, 5), 9)

    def run(fn, seed):
        g = torch.Generator().manual_seed(seed)
        return fn(model, prompt, max_new_tokens=12, temperature=1.5, generator=g)

    a = run(llama.generate_kv, 1)
    assert torch.equal(a, run(llama.generate_kv, 1))
    assert torch.equal(a, run(llama.generate, 1))
    assert not torch.equal(a, run(llama.generate_kv, 2))
    assert not torch.equal(a, llama.generate_kv(model, prompt, max_new_tokens=12))


class TestOutOfRange:
    """Where the reference clamps or drops an out-of-range cache write, the
    port raises."""

    def test_reference_clamps_where_port_raises(self, np_params):
        jcfg, cfg = _configs()
        tokens = _tokens((1, 4), 10)
        # the reference's dynamic_update_slice moves start 6 back to 4
        _jax_forward_cached(np_params, jnp.asarray(tokens), jax_llama.init_cache(jcfg, 1, 8),
                            jnp.int32(6), config=jcfg)
        model = _port(np_params, cfg)
        cache = llama.init_cache(cfg, 2, 8, "cpu")
        with pytest.raises(ValueError, match="outside the cache"):
            llama.forward_cached(model, torch.from_numpy(tokens), cache, 6)
        with pytest.raises(ValueError, match="outside the cache"):
            llama.decode_step_rowwise(model, [1, 2], cache, [3, 8])
        with pytest.raises(ValueError, match="slot 2 outside"):
            llama.prefill_into_slot(model, torch.from_numpy(tokens), cache, 2)

    def test_window_chunk_longer_than_cache_raises(self, np_params):
        _, cfg = _configs(sliding_window=4)
        cache = llama.init_cache(cfg, 1, 6, "cpu")
        with pytest.raises(ValueError, match="prefill chunk 8 exceeds cache length 6"):
            llama.forward_cached(_port(np_params, cfg), torch.zeros((1, 8), dtype=torch.long), cache, 0)

    def test_ring_attention_not_ported(self):
        """Ring attention is ported; with a sliding window it raises, as the
        reference's does."""
        llama.Llama(llama.LlamaConfig.tiny(attention_impl="ring"), device="cpu")
        with pytest.raises(NotImplementedError, match="sliding_window with ring attention"):
            llama.Llama(llama.LlamaConfig.tiny(attention_impl="ring", sliding_window=8), device="cpu")


@pytest.mark.parametrize("name", ["tiny", "llama2_7b", "mistral_7b"])
def test_counts_match_jax(name):
    jcfg, cfg = getattr(jax_llama.LlamaConfig, name)(), getattr(llama.LlamaConfig, name)()
    assert llama.num_params(cfg) == jax_llama.num_params(jcfg)
    assert llama.flops_per_token(cfg, 512) == jax_llama.flops_per_token(jcfg, 512)
