"""ActorPool: schedule work over a fixed set of actors.

Role-equivalent of ray: python/ray/util/actor_pool.py (ActorPool) — the
user-facing pool for "N stateful workers, stream values through them":
``submit(fn, value)`` dispatches ``fn(actor, value)`` to a free actor,
results come back via ``get_next`` (submission order) or
``get_next_unordered`` (completion order); ``map``/``map_unordered``
wrap the loop.  Busy/free bookkeeping is client-side — the pool never
talks to the actors beyond the calls it dispatches.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.errors import GetTimeoutError


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor = {}   # ref -> (submission idx, actor)
        self._index_to_future = {}   # submission idx -> ref
        self._next_task_index = 0
        self._next_return_index = 0  # next idx get_next hands out

    # -- dispatch --------------------------------------------------------
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Dispatch fn(actor, value) onto a free actor (raises when none
        is free — pair with has_free/get_next)."""
        if not self._idle:
            raise RuntimeError(
                "no free actors; call get_next()/get_next_unordered() first"
            )
        actor = self._idle.pop()
        ref = fn(actor, value)
        resp = getattr(ref, "ref", None)
        if resp is not None:  # a serve-style response: use its ref
            ref = resp
        self._future_to_actor[ref] = (self._next_task_index, actor)
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_free(self) -> bool:
        return bool(self._idle)

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def _advance_cursor(self) -> None:
        """Skip indices already consumed by get_next_unordered so the
        ordered cursor always rests on a live (or future) index."""
        while (
            self._next_return_index < self._next_task_index
            and self._next_return_index not in self._index_to_future
        ):
            self._next_return_index += 1

    def _consume(self, idx: int, ref: Any) -> None:
        """Retire a finished submission: drop both map entries, free the
        actor, and re-align the ordered cursor."""
        self._index_to_future.pop(idx, None)
        _, actor = self._future_to_actor.pop(ref)
        self._idle.append(actor)
        self._advance_cursor()

    # -- retrieval -------------------------------------------------------
    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in SUBMISSION order.  On timeout the pool state is
        untouched (the task keeps running, the actor stays busy) — call
        again to keep waiting, matching the reference's ActorPool."""
        self._advance_cursor()
        if not self.has_next():
            raise StopIteration("no pending results")
        idx = self._next_return_index
        ref = self._index_to_future[idx]
        try:
            value = ray_tpu_torch.get(ref, timeout=timeout)
        except GetTimeoutError:
            raise  # still running: nothing consumed, actor still busy
        except Exception:
            self._consume(idx, ref)  # task errored: done, actor is free
            raise
        self._consume(idx, ref)
        return value

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout
        )
        if not ready:
            # same type get_next raises, so one handler covers both paths
            raise GetTimeoutError("no result within timeout")
        ref = ready[0]
        idx = self._future_to_actor[ref][0]
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._consume(idx, ref)

    # -- bulk ------------------------------------------------------------
    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        """Results in submission order, streaming (at most pool-size
        values in flight)."""
        values = iter(values)
        for v in values:
            if not self.has_free():
                yield self.get_next()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        """Results in completion order."""
        values = iter(values)
        for v in values:
            if not self.has_free():
                yield self.get_next_unordered()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- membership ------------------------------------------------------
    def push(self, actor: Any) -> None:
        """Add an idle actor to the pool."""
        self._idle.append(actor)

    def pop_idle(self) -> Optional[Any]:
        """Remove and return an idle actor (None if all are busy)."""
        return self._idle.pop() if self._idle else None
