"""Persistent stage-to-stage p2p channels over the collective planes.

The MPMD pipeline's data plane v2 (ROADMAP item 3): adjacent stage
actors open ONE long-lived channel per 1F1B edge at configure time and
stream micro-batch activations/grads directly — the driver ships no
data refs, only O(1) control acks.  A channel is a unidirectional,
sequence-numbered stream between two ranks of a collective group,
riding the same chunked wire path as the ring collectives
(``RpcRingBackend._send_view``): co-hosted ranks keep the zero-copy
shm-arena handoff, cross-host ranks get chunked pickle5-oob sends.

Design points (the preemption-survival contract):

- **Sequence numbers are ledger keys.**  ``seq = step·n_micro + micro``
  is a pure function of the micro-op, so a retry after a mid-transfer
  preemption posts/fetches the SAME seq and dedupes identically to the
  stage ledger (mailbox offsets dedupe duplicate chunk delivery; the
  outbox dedupes duplicate posts by overwriting).
- **Push + reform-resend.**  ``post`` records the payload in an outbox
  and launches the transfer on the runtime io loop (a
  ``CollectiveWork`` — the T3 overlap shape: the NEXT micro-op's
  compute proceeds while chunks stream).  Every chunk rpc is a delivery
  ack, but an *acked* payload may still die unconsumed in a preempted
  receiver's mailbox — so a group listener re-offers the whole
  unpurged outbox into every fresh incarnation
  (``CollectiveManager._install_group``), and receivers dedupe by
  chunk offset.  Outboxes ride the stage checkpoint, so a migrated
  SENDER re-offers too.
- **Purge at the step boundary.**  ``purge_below(step·n_micro)`` at
  apply time drops outbox entries and stale mailboxes of PAST steps
  only — the current step's payloads stay re-deliverable until the
  next apply proves the whole step consumed (the driver completes step
  k before submitting k+1, so cross-host consumption is certain).
- **Self-describing payloads.**  A ``meta`` dict (shape/dtype/total)
  rides the first chunk of every send attempt, so the receive slot is
  allocated on arrival; the window (pre-posted slot budget) is sized
  by the 1F1B in-flight depth (``schedule.inflight_micros``).

Chaos: every send attempt and receive poll hits the
``collective.p2p`` site (``faults.SITE_COLLECTIVE_P2P``) with context
``"<group>:send|recv:<stream>.<seq>"``.  ``drop`` on a send aborts the
attempt (the bounded retry re-sends the outbox copy under the same
seq); on a receive it parks the poll round — nothing is consumed, so
nothing can be lost.  ``delay`` sleeps ``delay_s`` at either end.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.common import faults
from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.util.collective.collective import (
    CollectiveWork,
    _launch,
    _manager,
    _run_blocking,
)
from ray_tpu_torch.util.collective.types import (
    CollectiveError,
    CollectiveTimeoutError,
)

logger = logging.getLogger(__name__)

# how often a parked fetch re-polls its mailbox: short enough to chase
# the group incarnation across a mid-fetch reform, long enough to stay
# off the hot path (arrival wakes the poll immediately via the mailbox
# event inside recv_chunks; this only bounds the re-check of deadline,
# incarnation, and chaos hits)
_POLL_S = 2.0
_RETRY_BACKOFF_S = 0.2


class ChannelError(CollectiveError):
    """A channel transfer failed terminally (retry budget exhausted)."""


def _tag(stream: str, seq: int) -> str:
    return f"ch.{stream}.{seq}"


# every live channel end in this process, for the drain-fence teardown
_live: List = []
_live_lock = threading.Lock()


def _register(ch) -> None:
    with _live_lock:
        _live.append(ch)


def _deregister(ch) -> None:
    with _live_lock:
        try:
            _live.remove(ch)
        except ValueError:
            pass


def drain_teardown() -> None:
    """Drain-fence hook (``core/worker_main.handle_checkpoint_actor``):
    after a successful state capture this process is doomed — close
    every live channel end so in-flight sends stop streaming and the
    reform listeners deregister.  Re-delivery is now owned by the
    restored twin, whose checkpointed outbox re-offers on reform;
    without this the old incarnation keeps pushing chunks it already
    captured, burning the drain window on dead traffic."""
    with _live_lock:
        ends = list(_live)
    for ch in ends:
        try:
            ch.close()
        except Exception:
            logger.exception("channel close failed during drain teardown")


def _chaos(kind: str, group: str, stream: str, seq: int):
    """One ``collective.p2p`` site hit; returns the fired plan."""
    fault_ctl = faults.ACTIVE  # bind once: clear() races the check
    if fault_ctl is None:
        return None
    return fault_ctl.hit(
        faults.SITE_COLLECTIVE_P2P, f"{group}:{kind}:{stream}.{seq}"
    )


class ChannelSender:
    """The sending end of one stream (this rank → ``dst_rank``)."""

    def __init__(self, group_name: str, stream: str, dst_rank: int, *,
                 window: int = 1,
                 retry_timeout_s: Optional[float] = None):
        self.group = group_name
        self.stream = stream
        self.dst = dst_rank
        # pre-posted slot budget: the 1F1B in-flight depth.  post()
        # reaps the oldest transfer past this, so overlap stays bounded
        # by what the schedule can actually consume.
        self.window = max(int(window), 1)
        self.retry_timeout_s = float(
            retry_timeout_s
            if retry_timeout_s is not None
            else cfg.collective_rendezvous_timeout_s
        )
        self._outbox: Dict[int, np.ndarray] = {}
        self._inflight: Dict[int, CollectiveWork] = {}
        self._closed = False
        _manager().add_group_listener(self.group, self._on_group_installed)
        _register(self)

    # -- the hot path ----------------------------------------------------
    def post(self, seq: int, arr) -> CollectiveWork:
        """Register ``arr`` under ``seq`` and launch the async transfer;
        returns immediately (the caller's next micro-op computes while
        chunks stream on the io loop).  Re-posting a seq overwrites —
        exactly-once comes from the deterministic seq, not from the
        caller never retrying."""
        arr = np.ascontiguousarray(arr)
        if arr.nbytes == 0:
            raise ChannelError(
                f"channel {self.group}:{self.stream} rejects empty "
                f"payloads (seq {seq}): zero-byte sends have no chunks "
                f"to ack, so delivery could never be confirmed"
            )
        self._outbox[seq] = arr
        if len(self._inflight) >= self.window:
            self.reap(block=True)
        work = _launch(
            self._deliver(seq, arr), f"ch.{self.stream}.{seq}", self.group
        )
        self._inflight[seq] = work
        return work

    def reap(self, block: bool = False) -> None:
        """Harvest finished transfers, raising the first terminal
        failure.  ``block=True`` waits for the OLDEST in-flight send
        first — the window backpressure point."""
        if block and self._inflight:
            self._inflight[min(self._inflight)].wait()
        for seq in [s for s, w in self._inflight.items() if w.done()]:
            work = self._inflight.pop(seq)
            try:
                exc = work.exception(0)
            # a cancelled work (drain teardown raced this reap) has no
            # outcome to raise; the caller thread is NOT the cancelled
            # task, so swallowing here cannot mask our own cancellation
            except asyncio.CancelledError:  # rtlint: disable=RT107
                continue
            if exc is not None:
                raise exc

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every in-flight transfer completes (tests and
        step-boundary barriers; the steady state never calls this)."""
        for seq in sorted(self._inflight):
            work = self._inflight.get(seq)
            if work is not None:
                work.wait(timeout)
        self.reap()

    # -- delivery (io loop) ----------------------------------------------
    async def _deliver(self, seq: int, arr) -> bool:
        """One payload's life on the loop: bounded retry until every
        chunk is acked.  Transient states — the group poisoned by a
        migrating peer, locally uninitialized mid-reform, an injected
        drop — back off and re-send the SAME seq; the receiver dedupes
        by offset, so a partial first attempt composes with a full
        second one."""
        deadline = time.monotonic() + self.retry_timeout_s
        while True:
            try:
                await self._attempt(seq, arr)
                return True
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if time.monotonic() >= deadline:
                    raise ChannelError(
                        f"channel {self.group}:{self.stream} seq {seq} "
                        f"undeliverable to rank {self.dst} after "
                        f"{self.retry_timeout_s:.0f}s: {e!r}"
                    ) from e
                await asyncio.sleep(_RETRY_BACKOFF_S)

    async def _attempt(self, seq: int, arr) -> None:
        plan = _chaos("send", self.group, self.stream, seq)
        if plan is not None:
            if plan.action == "delay":
                await asyncio.sleep(plan.delay_s)
            elif plan.action == "drop":
                # before any chunk leaves: the attempt vanishes whole,
                # and _deliver re-sends the outbox copy under this seq
                raise ChannelError(
                    f"injected channel drop "
                    f"({self.group}:{self.stream}.{seq})"
                )
        mgr = _manager()
        gh = mgr.groups.get(self.group)
        if gh is None:
            raise ChannelError(
                f"group {self.group!r} not initialized here (mid-reform)"
            )
        gh.check_alive()
        be = gh.backend
        conn = await be._conn(self.dst)
        await be._send_view(
            conn, self.dst, _tag(self.stream, seq), arr,
            extra={"meta": {
                "shape": tuple(arr.shape),
                "dtype": arr.dtype,
                "total": int(arr.nbytes),
            }},
        )

    # -- reform resend -----------------------------------------------------
    def _on_group_installed(self, gh):
        """Group listener: a fresh incarnation exists (first init, a
        survivor-side reform, or this process's own post-restore
        re-join) — re-offer every unpurged payload.  Acked chunks died
        with a preempted receiver's mailbox; consumed seqs are never
        re-fetched (stage ledger) and their stale chunks fall to the
        receiver's purge."""
        if self._closed or not self._outbox:
            return None
        return self._resend_outbox()

    async def _resend_outbox(self):
        for seq in sorted(self._outbox):
            arr = self._outbox.get(seq)
            if arr is None or self._closed:
                continue
            try:
                await self._deliver(seq, arr)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception(
                    "channel %s:%s reform resend of seq %d failed",
                    self.group, self.stream, seq,
                )

    # -- lifecycle ---------------------------------------------------------
    def purge_below(self, seq: int) -> None:
        """Drop outbox entries below ``seq`` — call at the step
        boundary with ``step·n_micro`` (past steps are proven consumed;
        the current step stays re-deliverable)."""
        for s in [s for s in self._outbox if s < seq]:
            del self._outbox[s]
        for s in list(self._inflight):
            if s < seq and self._inflight[s].done():
                work = self._inflight.pop(s)
                try:
                    work.exception(0)
                # consumed seq: its late failure/cancellation is moot,
                # and this caller thread is not the cancelled task
                except asyncio.CancelledError:  # rtlint: disable=RT107
                    pass

    def outbox_state(self) -> Dict[int, np.ndarray]:
        """Checkpoint surface: the unpurged payloads (numpy; pickle
        memoization dedupes arrays shared with the stage ledger)."""
        return dict(self._outbox)

    def restore_outbox(self, state: Dict[int, np.ndarray]) -> None:
        self._outbox.update(state or {})

    def close(self) -> None:
        self._closed = True
        try:
            _manager().remove_group_listener(
                self.group, self._on_group_installed
            )
        except Exception:
            pass
        for work in self._inflight.values():
            try:
                work._fut.cancel()
            except Exception:
                pass
        self._inflight.clear()
        _deregister(self)


class ChannelReceiver:
    """The receiving end of one stream (``src_rank`` → this rank)."""

    def __init__(self, group_name: str, stream: str, src_rank: int, *,
                 timeout_s: Optional[float] = None):
        self.group = group_name
        self.stream = stream
        self.src = src_rank
        self.timeout_s = float(
            timeout_s if timeout_s is not None
            else cfg.collective_op_timeout_s
        )
        _register(self)

    def fetch(self, seq: int, timeout: Optional[float] = None):
        """Block until seq's payload is fully arrived; returns the
        reconstructed array (sync actor threads — the stage's compute
        path self-synchronizes here instead of on a driver ref)."""
        return _run_blocking(self.fetch_async(seq, timeout))

    async def fetch_async(self, seq: int, timeout: Optional[float] = None):
        timeout = self.timeout_s if timeout is None else float(timeout)
        mgr = _manager()
        rt = mgr.rt
        tag = _tag(self.stream, seq)
        deadline = time.monotonic() + timeout
        meta: Optional[dict] = None
        out = flat = None
        pending: List[dict] = []  # chunks arrived before their meta
        covered: set = set()      # offsets applied (resend-overlap dedup)
        nbytes_done = 0
        while meta is None or nbytes_done < meta["total"]:
            plan = _chaos("recv", self.group, self.stream, seq)
            if plan is not None and plan.action in ("drop", "delay"):
                # recv side: both actions park this poll round only —
                # nothing is consumed, so nothing can be lost
                await asyncio.sleep(plan.delay_s)
            left = deadline - time.monotonic()
            if left <= 0:
                want = meta["total"] if meta is not None else -1
                raise CollectiveTimeoutError(
                    f"channel fetch {self.group}:{self.stream} seq {seq} "
                    f"from rank {self.src} timed out after {timeout:.0f}s "
                    f"({nbytes_done}/{want if want >= 0 else '?'} bytes "
                    f"arrived).  The upstream stage is likely dead or "
                    f"its re-formed incarnation never re-offered."
                )
            try:
                # pop chunks one at a time: byte-sum consumption cannot
                # be trusted across interleaved re-send attempts, so
                # coverage (unique offsets) is tracked here instead
                msgs = await mgr.recv_chunks(
                    self.group, self.src, tag, 1,
                    timeout=min(left, _POLL_S),
                )
            except CollectiveTimeoutError:
                continue  # deadline check above bounds the loop
            except CollectiveError:
                # poisoned or locally mid-reform: the mailbox died with
                # the old incarnation — the sender's reform resend
                # re-delivers into the new one; keep polling
                await asyncio.sleep(_RETRY_BACKOFF_S)
                continue
            for msg in msgs:
                if meta is None and msg.get("meta") is not None:
                    meta = msg["meta"]
                    out = np.empty(meta["shape"], dtype=meta["dtype"])
                    flat = out.reshape(-1)
                    if flat.dtype != np.uint8:
                        flat = flat.view(np.uint8)
                if meta is None:
                    # a partial earlier attempt's tail landing before a
                    # re-send's meta chunk: park until the slot exists
                    pending.append(msg)
                    continue
                while pending:
                    nbytes_done += self._apply(rt, flat, pending.pop(0),
                                               covered)
                nbytes_done += self._apply(rt, flat, msg, covered)
        return out

    @staticmethod
    def _apply(rt, flat_u8, msg: dict, covered: set) -> int:
        from ray_tpu_torch.util.collective.rpc_backend import apply_chunk

        off = msg["offset"]
        if off in covered:
            # duplicate delivery (a reform-window resend overlapping a
            # partial first attempt): reclaim, never double-write
            if msg.get("shm") is not None:
                try:
                    rt.store.delete(msg["shm"])
                except Exception:
                    pass
            return 0
        apply_chunk(rt, flat_u8, msg)
        covered.add(off)
        return msg["nbytes"]

    # -- lifecycle ---------------------------------------------------------
    def purge_below(self, seq: int) -> None:
        """Reclaim stale mailboxes of past-step seqs — reform resends
        re-deliver payloads this end already consumed (the sender
        cannot know), and unconsumed shm chunks would pin the arena."""
        _run_blocking(self._purge_async(seq))

    async def _purge_async(self, seq: int) -> None:
        mgr = _manager()
        prefix = f"ch.{self.stream}."
        err = ChannelError(
            f"stale channel seq below {seq} purged at the step boundary"
        )
        for key in [
            k for k in mgr._inbox
            if k[0] == self.group and k[2] == self.src
            and k[3].startswith(prefix)
        ]:
            try:
                s = int(key[3][len(prefix):])
            except ValueError:
                continue
            if s < seq:
                mgr._drop_box(mgr._inbox.pop(key), err)

    def close(self) -> None:
        _deregister(self)
