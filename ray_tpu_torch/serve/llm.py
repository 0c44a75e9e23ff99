"""LLM serving: a continuous-batching decode engine over the Llama KV-cache
path (port of ``ray_tpu/serve/llm.py`` ``LLMEngine``).

N concurrent streaming requests share one fixed batch of cache rows
("slots"): a new request is prefilled into a free row
(``llama.prefill_into_slot``) while the other rows keep decoding, and every
decode step is one ``llama.decode_step_rowwise`` over all rows at their own
positions.  Tokens stream back to each request through its own queue.

Waiting requests are admitted earliest-deadline first, by the deadline
that ``serve/traffic/config.py`` records for the request; one whose
deadline lapsed before a row freed up is shed with ``RequestShedError``.
Prefill and decode run in a worker thread (``asyncio.to_thread``), so the
event loop keeps accepting requests and delivering tokens meanwhile; the
model functions enter ``torch.inference_mode`` in that thread.

``LlamaDeployment`` serves the engine from a replica actor (``serve.run``,
a one-GPU lease per replica with ``ray_actor_options={"num_gpus": 1}``), and
takes new weights through ``update_weights``, the method the weight push
(``serve/weights.py``) calls.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import logging
import time
from typing import List, Optional

import torch

from ray_tpu_torch import serve
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.serve.traffic.config import RequestShedError, get_request_deadline


class _Slot:
    __slots__ = ("queue", "pos", "remaining", "last_token", "max_pos")

    def __init__(self, queue, pos, remaining, last_token, max_pos):
        self.queue = queue          # per-request token queue
        self.pos = pos              # absolute position of last_token
        self.remaining = remaining  # tokens still to generate
        self.last_token = last_token
        self.max_pos = max_pos


_END = object()


class LLMEngine:
    """Slot-based continuous batcher: admit-prefill plus one shared decode
    step.  ``model`` is a :class:`ray_tpu_torch.models.llama.Llama` on
    ``device``, where the engine keeps its KV cache."""

    def __init__(self, model: llama.Llama, *, max_slots: int = 4,
                 max_len: int = 256, max_prompt_len: Optional[int] = None,
                 device="cuda"):
        # "cuda" names the current card: its tensors are on cuda:<index>
        self.device = torch.empty(0, device=resolve_device(device)).device
        if model.tok_embed.device != self.device:
            raise ValueError(
                f"the model's weights are on {model.tok_embed.device}, the engine's device is "
                f"{self.device}"
            )
        config = model.config
        self.model = model
        self.config = config
        self.max_slots = max_slots
        self.max_len = max_len
        # Sliding-window models with an explicit prompt cap get a rolling
        # cache: window + max_prompt - 1 slots serve any decode length up to
        # max_len positions (llama.rolling_cache_len).  Without the cap, or
        # without a window, the cache holds every position.
        self.max_prompt_len = max_prompt_len or max_len
        if config.sliding_window and max_prompt_len:
            self.cache_len = min(max_len, llama.rolling_cache_len(config, max_prompt_len))
        else:
            self.cache_len = max_len
        self.cache = llama.init_cache(config, max_slots, self.cache_len, self.device)
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        # admission queue: an EDF heap of (deadline, seq, prompt, max_new,
        # out_queue); requests without a deadline wait at +inf
        self._pending: List[tuple] = []
        self._admit_seq = itertools.count()
        self._runner: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self.admitted_total = 0
        self.shed_total = 0

    # -- client side -----------------------------------------------------
    async def stream(self, prompt: List[int], max_new_tokens: int = 16):
        """Async generator of the generated token ids of one request.

        The request's deadline (``get_request_deadline``) is read here, at
        submit time: the context variable is live only in the submitting
        task."""
        if self._runner is None or self._runner.done():
            self._runner = asyncio.get_running_loop().create_task(self._run())
        q: asyncio.Queue = asyncio.Queue()
        deadline = get_request_deadline()
        heapq.heappush(self._pending, (
            deadline if deadline is not None else float("inf"),
            next(self._admit_seq), list(prompt), int(max_new_tokens), q,
        ))
        self._wake.set()
        while True:
            tok = await q.get()
            if tok is _END:
                return
            if isinstance(tok, Exception):
                raise tok
            yield tok

    # -- engine loop -----------------------------------------------------
    async def _run(self):
        while True:
            try:
                await self._run_inner()
            except Exception as e:  # noqa: BLE001 — delivered to clients
                logging.getLogger(__name__).exception(
                    "LLM engine step failed; failing active requests"
                )
                # fail every active stream and drain pending admissions;
                # re-initialise the cache (a step may have failed between
                # its layers' writes) and keep serving
                for i, s in enumerate(self.slots):
                    if s is not None:
                        await s.queue.put(e)
                        await s.queue.put(_END)
                        self.slots[i] = None
                while self._pending:
                    _, _, _, _, q = heapq.heappop(self._pending)
                    await q.put(e)
                    await q.put(_END)
                self.cache = llama.init_cache(
                    self.config, self.max_slots, self.cache_len, self.device
                )

    def _prefill(self, prompt: List[int], slot: int) -> int:
        """Prefill ``prompt`` into row ``slot``; its greedy first token."""
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, self.cache = llama.prefill_into_slot(self.model, toks, self.cache, slot)
        return int(logits[0].argmax())

    def _decode(self, tokens: List[int], pos: List[int]) -> List[int]:
        """One decode step over every row; each row's greedy next token."""
        logits, self.cache = llama.decode_step_rowwise(
            self.model, torch.tensor(tokens, device=self.device), self.cache, pos
        )
        return logits.argmax(dim=-1).tolist()

    async def _run_inner(self):
        while True:
            # admit pending requests into free slots (prefill), EDF: the
            # earliest-deadline waiter takes the free row, and a waiter
            # whose deadline lapsed in this queue is shed: its prefill
            # would only delay every live row's next token
            while self._pending and None in self.slots:
                deadline, _, prompt, max_new, q = heapq.heappop(self._pending)
                if deadline <= time.monotonic():
                    self.shed_total += 1
                    await q.put(RequestShedError(
                        "SLO budget exhausted before a decode slot freed up"
                    ))
                    await q.put(_END)
                    continue
                self.admitted_total += 1
                if max_new <= 0:  # exact budget: zero tokens requested
                    await q.put(_END)
                    continue
                slot = self.slots.index(None)
                S0 = len(prompt)
                if S0 + max_new > self.max_len or S0 > self.max_prompt_len or S0 == 0:
                    await q.put(ValueError(
                        f"prompt of {S0} tokens + {max_new} new exceeds max_len "
                        f"{self.max_len} (or prompt cap {self.max_prompt_len})"
                    ))
                    await q.put(_END)
                    continue
                first = await asyncio.to_thread(self._prefill, prompt, slot)
                await q.put(first)
                if max_new <= 1:
                    await q.put(_END)
                    continue
                self.slots[slot] = _Slot(
                    queue=q, pos=S0, remaining=max_new - 1,
                    last_token=first, max_pos=self.max_len - 1,
                )
            active = [i for i, s in enumerate(self.slots) if s is not None]
            if not active:
                # idle: park until a request arrives
                self._wake.clear()
                if not self._pending:
                    await self._wake.wait()
                continue
            # one decode step over all rows (free rows decode into their own
            # rows harmlessly; the shapes stay constant)
            tokens = [0] * self.max_slots
            pos = [0] * self.max_slots
            for i in active:
                tokens[i] = self.slots[i].last_token
                pos[i] = self.slots[i].pos
            nxt = await asyncio.to_thread(self._decode, tokens, pos)
            for i in active:
                s = self.slots[i]
                tok = nxt[i]
                await s.queue.put(tok)
                s.last_token = tok
                s.pos += 1
                s.remaining -= 1
                if s.remaining <= 0 or s.pos >= s.max_pos:
                    await s.queue.put(_END)
                    self.slots[i] = None
            # let admissions and consumers run between steps
            await asyncio.sleep(0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model_from_state(config: llama.LlamaConfig, state, device) -> llama.Llama:
    """A new :class:`Llama` on ``device`` holding the state dict ``state``.
    Keys and shapes must match the model's exactly (``load_state_dict``
    raises otherwise)."""
    model = llama.Llama(config, device)
    model.load_state_dict(state, strict=True)
    return model


@serve.deployment
class LlamaDeployment:
    """Decode replica: tiny-config by default, or real weights via a
    ``weights_ref`` (object-store ref to a state dict) / ``weights_loader``
    callable (returning a :class:`Llama` on ``device``, built where it
    runs: on the replica's card, with no copy through the host).

    ``device`` defaults to ``"cuda"``: a replica without a GPU lease has no
    card and raises here, at construction; it never runs on the CPU unless
    asked to.  Without weights it draws them with ``llama.init`` from a
    ``torch.Generator`` seeded with ``seed`` (other numbers than the
    reference's ``jax.random``)."""

    def __init__(self, config=None, weights_ref=None, weights_loader=None,
                 max_slots: int = 4, max_len: int = 256,
                 max_prompt_len: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        # what the construction cost: its start (time.time(), to line up
        # with the caller's clock) and the seconds of each part
        self.timings = {"start": time.time()}
        t1 = time.perf_counter()
        self.config = config or llama.LlamaConfig.tiny()
        device = resolve_device(device)
        if weights_ref is not None:
            import ray_tpu_torch

            model = _model_from_state(self.config, ray_tpu_torch.get(weights_ref), device)
        elif weights_loader is not None:
            model = weights_loader()
        else:
            model = llama.init(self.config, torch.Generator(device=device).manual_seed(seed), device)
        _sync(device)
        t2 = time.perf_counter()
        self.engine = LLMEngine(
            model, max_slots=max_slots, max_len=max_len,
            max_prompt_len=max_prompt_len, device=device,
        )
        _sync(device)
        self.timings.update(weights_s=t2 - t1, engine_s=time.perf_counter() - t2)
        # what the last update_weights cost, in the same terms
        self.last_update = None

    def update_weights(self, state_dict) -> bool:
        """Replace the served weights by ``state_dict`` — the serve
        weight-push path (``serve.weights.push_weights``).

        A new model is built on the engine's device and swapped in whole:
        the engine reads ``engine.model`` once per prefill or decode step,
        so a step in flight finishes on the old weights and the next one
        runs on the new; no step mixes the two.  (Copying into the live
        tensors would race the step the engine's thread is running.)  For
        a moment both copies are on the card.  A state dict whose keys or
        shapes do not match raises, and the old weights stay.  The KV
        cache is content, not weights, so it stays valid."""
        t0, start = time.perf_counter(), time.time()
        model = _model_from_state(self.config, state_dict, self.engine.device)
        _sync(self.engine.device)
        self.engine.model = model
        self.last_update = {"start": start, "apply_s": time.perf_counter() - t0}
        return True

    async def generate(self, prompt: List[int], max_new_tokens: int = 16):
        """Streaming generation (use handle.options(stream=True)): the
        generated token ids as Python ints."""
        async for tok in self.engine.stream(prompt, max_new_tokens):
            yield tok

    async def generate_all(self, prompt: List[int],
                           max_new_tokens: int = 16) -> List[int]:
        """Unary convenience: the full generated id list."""
        return [
            tok async for tok in self.engine.stream(prompt, max_new_tokens)
        ]
