"""The port's continuous-batching engine (ray_tpu_torch.serve.llm) against
the JAX package's ``LLMEngine``, on the CPU under ``asyncio.run``.

The same numpy-drawn tiny Llama weights go to both engines (the port's
through ``llama_params_from_jax``); both decode greedily in f32, so every
request's tokens must be equal.  The rest pins the engine's admission
semantics: the prompt cap, zero-token requests, shedding of lapsed
deadlines, earliest-deadline-first admission and the failure path.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.serve.llm import LLMEngine as JaxLLMEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import llama_params_from_jax
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.serve.traffic.config import RequestShedError, set_request_deadline

# Five requests of five prompt lengths through two slots, so most wait for a
# slot and are admitted while the other slot decodes; with window 6 and a
# prompt cap of 5 the cache is rolling_cache_len = 10 slots, which the
# longer requests wrap.
PROMPT_LENS = (3, 1, 5, 2, 4)
MAX_NEW = (9, 14, 6, 20, 11)


@pytest.fixture(scope="module")
def np_params():
    shapes = jax.eval_shape(lambda: jax_llama.init(jax.random.key(0), jax_llama.LlamaConfig.tiny()))
    rng = np.random.default_rng(0)

    def draw(path, s):
        base = 1.0 if "norm" in jax.tree_util.keystr(path) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _engine(np_params, window=6, **kw):
    cfg = llama.LlamaConfig.tiny(sliding_window=window)
    return LLMEngine(llama_params_from_jax(np_params, cfg, device="cpu"), device="cpu", **kw)


async def _collect(engine, prompt, max_new):
    return [tok async for tok in engine.stream(prompt, max_new)]


def _serve(engine, requests):
    async def main():
        return await asyncio.gather(*(_collect(engine, p, n) for p, n in requests))

    return asyncio.run(main())


@pytest.mark.parametrize("window", [0, 6], ids=["full-cache", "rolling-window6"])
def test_concurrent_requests_match_jax_engine(np_params, window):
    rng = np.random.default_rng(11)
    requests = [(rng.integers(0, 256, n).tolist(), m) for n, m in zip(PROMPT_LENS, MAX_NEW)]
    kw = dict(max_slots=2, max_len=64, max_prompt_len=5)
    engine = _engine(np_params, window, **kw)
    ref_engine = JaxLLMEngine(np_params, jax_llama.LlamaConfig.tiny(sliding_window=window), **kw)
    assert engine.cache_len == ref_engine.cache_len == (10 if window else 64)
    assert engine.cache["k"].shape == ref_engine.cache["k"].shape
    got = _serve(engine, requests)
    ref = _serve(ref_engine, requests)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g == r, f"request {i}"
        assert len(g) == MAX_NEW[i]
    assert engine.admitted_total == ref_engine.admitted_total == len(requests)


def test_prompt_cap_and_zero_token_requests(np_params):
    engine = _engine(np_params, max_slots=1, max_len=64, max_prompt_len=4)
    assert engine.cache_len == 9

    async def main():
        with pytest.raises(ValueError, match="prompt cap"):
            await _collect(engine, [1] * 8, 2)
        with pytest.raises(ValueError, match="exceeds max_len"):
            await _collect(engine, [1, 2], 63)
        assert await _collect(engine, [1, 2], 0) == []
        return await _collect(engine, [3, 7], 3)

    assert len(asyncio.run(main())) == 3
    assert engine.admitted_total == 4


def test_lapsed_deadline_is_shed_and_edf_admits(np_params):
    """One slot: a request whose deadline has passed is shed without a
    prefill; the waiters behind a running request are admitted earliest
    deadline first, those without a deadline last."""
    engine = _engine(np_params, max_slots=1, max_len=64)
    order = []

    async def request(name, deadline, max_new):
        set_request_deadline(deadline)  # this task's context only
        async for _ in engine.stream([5, 6, 7], max_new):
            if name not in order:
                order.append(name)

    async def main():
        now = time.monotonic()
        with pytest.raises(RequestShedError, match="SLO budget exhausted"):
            await request("lapsed", now - 1.0, 4)
        first = asyncio.create_task(request("running", None, 6))
        while not order:
            await asyncio.sleep(0)
        await asyncio.gather(first, request("none", None, 2), request("late", now + 100, 2),
                             request("soon", now + 50, 2))

    asyncio.run(main())
    assert engine.shed_total == 1
    assert engine.admitted_total == 4
    assert order == ["running", "soon", "late", "none"]


def test_failed_step_fails_streams_and_reinitialises_cache(np_params, monkeypatch):
    engine = _engine(np_params, max_slots=2, max_len=32)
    decode = engine._decode

    def broken(tokens, pos):
        monkeypatch.setattr(engine, "_decode", decode)
        raise RuntimeError("device fault")

    monkeypatch.setattr(engine, "_decode", broken)
    stale = engine.cache

    async def main():
        results = await asyncio.gather(_collect(engine, [1, 2, 3], 5), _collect(engine, [4], 5),
                                       return_exceptions=True)
        fresh = engine.cache
        assert fresh is not stale and not fresh["k"].any() and not fresh["v"].any()
        assert engine.slots == [None, None]
        return results, await _collect(engine, [1, 2, 3], 5)

    results, after = asyncio.run(main())
    assert all(isinstance(r, RuntimeError) for r in results)
    expected = llama.generate(engine.model, [[1, 2, 3]], max_new_tokens=5)[0, 3:].tolist()
    assert after == expected


def test_cached_path_runs_in_inference_mode(np_params, monkeypatch):
    """The engine's worker thread enters inference mode in the model
    functions: the cache stays out of autograd and logits carry no graph."""
    engine = _engine(np_params, max_slots=1, max_len=32)
    seen = []
    step = llama.decode_step_rowwise

    def spy(*args):
        logits, cache = step(*args)
        seen.append((logits.requires_grad, cache["k"].requires_grad, torch.is_inference(logits)))
        return logits, cache

    monkeypatch.setattr(llama, "decode_step_rowwise", spy)
    assert len(_serve(engine, [([1, 2], 3)])[0]) == 3
    assert seen and all(s == (False, False, True) for s in seen)
