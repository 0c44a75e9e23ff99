"""Distributed FIFO queue backed by an actor.

Role-equivalent of ray: python/ray/util/queue.py (Queue + Empty/Full) —
a bounded/unbounded multi-producer multi-consumer queue any worker can
reach by handle.  The state lives in ONE async actor wrapping an
asyncio.Queue, so blocking put/get are actor awaits (no polling), and
batch ops are single round trips.

Items travel through the port's serializer: a CUDA tensor put by a GPU
task reaches the queue's actor, and every reader, as a CPU tensor, so the
queue's actor holds no card.
"""

from __future__ import annotations

import asyncio
from queue import Empty, Full  # re-exported, like the reference
from typing import Any, List, Optional

import ray_tpu_torch

__all__ = ["Queue", "Empty", "Full"]


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._maxsize = maxsize

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return True, await self._q.get()
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def put_nowait_batch(self, items: List[Any]) -> bool:
        if self._maxsize and self._q.qsize() + len(items) > self._maxsize:
            return False  # all-or-nothing, like the reference
        for it in items:
            self._q.put_nowait(it)
        return True

    async def get_nowait_batch(self, n: int):
        if self._q.qsize() < n:
            return False, []
        return True, [self._q.get_nowait() for _ in range(n)]

    async def qsize(self) -> int:
        return self._q.qsize()


class Queue:
    """Handle; cheap to pass to tasks/actors (the actor handle inside
    serializes by reference)."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0.1)
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    # -- core ------------------------------------------------------------
    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        if timeout is not None and timeout < 0:
            raise ValueError("timeout must be non-negative")
        ok = ray_tpu_torch.get(
            self.actor.put.remote(item, timeout),
            timeout=None if timeout is None else timeout + 30,
        )
        if not ok:
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        if timeout is not None and timeout < 0:
            raise ValueError("timeout must be non-negative")
        ok, item = ray_tpu_torch.get(
            self.actor.get.remote(timeout),
            timeout=None if timeout is None else timeout + 30,
        )
        if not ok:
            raise Empty
        return item

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get_nowait(self):
        return self.get(block=False)

    # -- batches (one round trip) ---------------------------------------
    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full(
                f"batch of {len(items)} does not fit (maxsize {self.maxsize})"
            )

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        ok, items = ray_tpu_torch.get(
            self.actor.get_nowait_batch.remote(num_items)
        )
        if not ok:
            raise Empty(f"fewer than {num_items} items queued")
        return items

    # -- introspection ---------------------------------------------------
    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    size = qsize

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return bool(self.maxsize) and self.qsize() >= self.maxsize

    def shutdown(self, force: bool = False,
                 grace_period_s: float = 30.0) -> None:
        """Terminate the queue actor.  ``force=False`` first waits (up to
        ``grace_period_s``) for a barrier call to clear the actor's
        mailbox, so work already received executes before the kill;
        ``force=True`` kills immediately, failing in-flight calls."""
        if not force:
            try:
                ray_tpu_torch.get(
                    self.actor.qsize.remote(), timeout=grace_period_s
                )
            except Exception:
                pass  # wedged or already dead: fall through to the kill
        ray_tpu_torch.kill(self.actor)
