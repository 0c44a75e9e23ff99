"""The one shared retry policy: deadline-aware exponential backoff + jitter.

Before this module every retry loop hand-rolled its own shape — fixed
``asyncio.sleep(0.05)`` polls, ``delay = min(delay * 2, 2.0)`` ladders,
magic attempt caps like ``failed_pulls < 8`` — so hot-spin bugs and
thundering-herd reconnects had to be found one site at a time (rtlint
RT112 now flags the unbounded-no-backoff shape outright).  All retrying
paths (rpc reconnect, GCS resubscribe via the reconnect channel, object
pull retry, lease-pending resubmission, rendezvous polls) now share this
implementation; per-site parameters live as named ``common/config.py``
knobs.

Shape: ``delay(attempt) = min(base * mult^(attempt-1), max) * jitter``,
clamped to the remaining deadline.  Jitter is multiplicative
(``1 ± jitter_frac``) so simultaneous retriers de-correlate without
changing the expected schedule.

Usage::

    bo = Backoff(BackoffPolicy(base_s=0.1, max_s=2.0), deadline=deadline)
    while True:
        try:
            return await dial()
        except OSError:
            if not await bo.wait():   # budget (attempts or deadline) spent
                raise
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["Backoff", "BackoffPolicy"]


@dataclass(frozen=True)
class BackoffPolicy:
    """Immutable schedule parameters (share freely across call sites)."""

    base_s: float = 0.05
    mult: float = 2.0
    max_s: float = 2.0
    jitter_frac: float = 0.1   # delay *= uniform(1-j, 1+j)
    max_attempts: int = 0      # 0 = unbounded (a deadline governs instead)

    def delay_for(self, attempt: int, rng=None) -> float:
        """Nominal delay for the ``attempt``-th retry (1-based)."""
        try:
            d = self.base_s * (self.mult ** (attempt - 1))
        except OverflowError:
            # float pow overflows past ~2.0**1024 — a legitimately
            # long unbounded wait (no deadline, no attempt cap) must
            # keep backing off at the cap, not crash
            d = self.max_s
        if d > self.max_s:  # also clamps an inf from the multiply
            d = self.max_s
        if self.jitter_frac:
            j = self.jitter_frac
            d *= (rng.uniform(1.0 - j, 1.0 + j) if rng is not None
                  else random.uniform(1.0 - j, 1.0 + j))
        return d if d > 0.0 else 0.0


class Backoff:
    """Mutable retry state for ONE operation: attempt counter + deadline.

    ``deadline`` is a ``time.monotonic()`` instant (None or ``inf`` =
    no deadline); delays clamp to the remaining budget so the last sleep
    never overshoots it.  ``rng`` makes the jitter stream reproducible
    for deterministic tests.
    """

    __slots__ = ("policy", "deadline", "rng", "attempts")

    def __init__(self, policy: BackoffPolicy,
                 deadline: Optional[float] = None, rng=None):
        self.policy = policy
        self.deadline = deadline
        self.rng = rng
        self.attempts = 0

    def next_delay(self) -> Optional[float]:
        """The next sleep, or None when the budget (attempt cap or
        deadline) is spent — callers give up / surface their error."""
        self.attempts += 1
        p = self.policy
        if p.max_attempts and self.attempts > p.max_attempts:
            return None
        d = p.delay_for(self.attempts, self.rng)
        if self.deadline is not None:
            remaining = self.deadline - time.monotonic()
            if remaining <= 0:
                return None
            if d > remaining:
                d = remaining
        return d

    async def wait(self) -> bool:
        """Async sleep for the next delay; False when the budget is
        spent (nothing slept)."""
        d = self.next_delay()
        if d is None:
            return False
        await asyncio.sleep(d)
        return True

    def wait_sync(self) -> bool:
        """Blocking twin of :meth:`wait` for caller/executor threads
        (never the io loop — rtlint RT101 polices that)."""
        d = self.next_delay()
        if d is None:
            return False
        time.sleep(d)
        return True
