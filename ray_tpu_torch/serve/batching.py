"""Dynamic request batching for deployment methods.

Role-equivalent of ray: python/ray/serve/batching.py:456 (@serve.batch):
concurrent calls to the decorated async method queue up; once
``max_batch_size`` requests are waiting — or the oldest has waited
``batch_wait_timeout_s`` — the wrapped function runs ONCE with a list of
the batched first-arguments and must return a list of results in the
same order, which are fanned back to the individual callers.

Usage (exactly the reference's shape)::

    @serve.deployment
    class Model:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def predict(self, inputs: List[np.ndarray]) -> List[float]:
            return model(np.stack(inputs)).tolist()

        async def __call__(self, x):
            return await self.predict(x)
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn, owner, max_batch_size: int, wait_s: float):
        self._fn = fn
        self._owner = owner  # bound instance (None for free functions)
        self._max = max_batch_size
        self._wait_s = wait_s
        self._queue: List[tuple] = []  # (item, future)
        self._drainer: Optional[asyncio.Task] = None
        self._full = asyncio.Event()  # set by the submit filling a batch

    async def submit(self, item) -> Any:
        fut = asyncio.get_running_loop().create_future()
        self._queue.append((item, fut))
        if len(self._queue) >= self._max:
            self._full.set()
        if self._drainer is None or self._drainer.done():
            # covers both cold start and restart after idle — and, since
            # a dead drainer fails every future it stranded on the way
            # out (below), restart after a drainer crash too
            self._drainer = asyncio.get_running_loop().create_task(
                self._drain()
            )
        return await fut

    @staticmethod
    def _fan_out_exception(futs, exc: BaseException) -> None:
        """EVERY waiter of a failed batch learns the failure — a raising
        batch fn must never strand a future (the caller would await
        forever; through serve this wedges a replica slot)."""
        for f in futs:
            if not f.done():
                f.set_exception(exc)

    async def _drain(self):
        try:
            while self._queue:
                # exact wakeup: either the batch fills (submit sets the
                # event) or the window from the FIRST item elapses
                if len(self._queue) < self._max:
                    self._full.clear()
                    try:
                        await asyncio.wait_for(
                            self._full.wait(), timeout=self._wait_s
                        )
                    except asyncio.TimeoutError:
                        pass
                batch = self._queue[: self._max]
                del self._queue[: len(batch)]
                # reset between batches: a set() that filled THIS batch
                # must not wake the next (possibly partial) batch's wait
                # before its window — submit re-sets it if the remainder
                # already fills a batch
                self._full.clear()
                if len(self._queue) >= self._max:
                    self._full.set()
                items = [b[0] for b in batch]
                futs = [b[1] for b in batch]
                try:
                    if self._owner is not None:
                        results = await self._fn(self._owner, items)
                    else:
                        results = await self._fn(items)
                    if len(results) != len(items):
                        raise ValueError(
                            f"@serve.batch function returned "
                            f"{len(results)} results for {len(items)} "
                            f"inputs"
                        )
                except (asyncio.CancelledError, GeneratorExit) as e:
                    # the drainer task (or the batch fn from inside) was
                    # cancelled / closed: fail this batch's waiters, then
                    # honor the cancellation — the finally fans out to
                    # the rest of the queue
                    self._fan_out_exception(futs, e)
                    raise
                except Exception as e:  # noqa: BLE001 — fan-out
                    self._fan_out_exception(futs, e)
                    continue
                except BaseException as e:
                    # SystemExit/KeyboardInterrupt: tell this batch's
                    # waiters, then let the process-level signal
                    # propagate — the serve loop must not eat it
                    self._fan_out_exception(futs, e)
                    raise
                for f, r in zip(futs, results):
                    if not f.done():
                        f.set_result(r)
        finally:
            # abnormal exit (cancellation, loop teardown): everything
            # still queued must fail fast rather than hang — the next
            # submit starts a fresh drainer either way
            if self._queue:
                pending = self._queue[:]
                del self._queue[: len(pending)]
                self._fan_out_exception(
                    [f for _, f in pending],
                    RuntimeError("@serve.batch drainer stopped with "
                                 "requests queued"),
                )


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 10,
    batch_wait_timeout_s: float = 0.01,
):
    """Decorator form of the reference's @serve.batch."""

    def wrap(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async def function")
        attr = f"__rt_batch_queue_{fn.__name__}"

        @functools.wraps(fn)
        async def method_wrapper(self, item):
            q = getattr(self, attr, None)
            if q is None:
                q = _BatchQueue(fn, self, max_batch_size,
                                batch_wait_timeout_s)
                setattr(self, attr, q)
            return await q.submit(item)

        # free-function form keeps one shared queue
        shared = _BatchQueue(fn, None, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        async def fn_wrapper(item):
            return await shared.submit(item)

        # methods are detected by their first parameter being `self` —
        # arity alone misclassifies free functions with extra defaulted
        # params (e.g. async def embed(items, normalize=True))
        import inspect

        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] in ("self", "cls")
        return method_wrapper if is_method else fn_wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
