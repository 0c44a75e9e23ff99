"""Multi-algorithm collectives over the duplex worker RPC plane.

The "gloo role" backend (reference: ray
util/collective/collective_group/gloo_collective_group.py): collective
algorithms in userspace over whatever transport the runtime already
has.  Here that transport is ``core/rpc.py``'s length-prefixed pickle5
framing — numpy chunk views ride as out-of-band buffers, so a cross-host
hop is one serialize-free socket write — and, when the peer rank lives
on the SAME node, the chunk moves through the shared shm arena instead:
the sender seals a short-lived arena object and ships only its 16-byte
id; the receiver maps it zero-copy, reads straight off the arena, and
deletes it.

Algorithms (chunked, send/recv overlapped per step; selection table in
``algorithms.py``, per-group/per-op config in ``GroupOptions``):

- allreduce     = ring reduce-scatter + ring allgather (bandwidth-optimal
                  2·(n-1)/n · bytes per rank, the standard ring schedule;
                  the bit-compat default), or ``rd`` recursive doubling
                  (log2(n) whole-vector pairwise exchanges, pow2 worlds —
                  latency-optimal for small messages)
- reducescatter = the ring first half; rank r keeps flat segment r
- allgather     = ring pass of whole blocks, n-1 steps
- broadcast     = chunk-pipelined ring forward from the root, or
                  ``btree`` binomial tree (log-depth, SUSPECT-node ranks
                  placed at the leaves) — byte-identical results either way
- barrier       = degenerate 1-element allreduce
- send/recv     = direct chunked transfer with per-pair sequence tags

Quantized wire path (``wire_dtype="int8"|"bf16"``, quantize.py): each
hop ships the block-quantized encoding instead of raw fp32 bytes.
Ring allreduce re-quantizes partial sums per reduce-scatter hop and
circulates each reduced segment's encoding VERBATIM through the
allgather half (the owner self-decodes its own encoding), so every
rank still finishes with a bit-identical result array.  Recursive
doubling self-quantizes the accumulator before each pairwise add for
the same all-ranks-identical guarantee.

Ordering/numerics: like NCCL ring reductions, the floating-point
accumulation order depends on ring position — sums are deterministic
per (group, world_size, rank layout, algorithm) but not necessarily
the same order as ``sum(inputs)`` on one host.  Integer-valued float
data (weight broadcast, scaled gradients in tests) is bit-exact
regardless.  All ranks must pass same-shape/same-dtype native-endian
tensors.
"""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional

from ray_tpu_torch.common import faults, serialization
from ray_tpu_torch.common.config import cfg
from ray_tpu_torch._native.store import StoreError, StoreFullError
from ray_tpu_torch.util.collective import algorithms, quantize
from ray_tpu_torch.util.collective.backend import RuntimeBackend
from ray_tpu_torch.util.collective.types import (
    CollectiveError,
    CollectiveGroupError,
    ReduceOp,
    apply_reduce,
)

RPC_METHOD = "collective"


def apply_chunk(rt, flat_u8, msg: dict) -> None:
    """Write one arrived chunk message into a uint8 destination view —
    the single consumer of the chunk wire format, shared by the ring
    backend and the pipeline channel plane (collective/channel.py)."""
    import numpy as np

    off = msg["offset"]
    if msg["shm"] is not None:
        pin = rt.store.get(msg["shm"])
        if pin is None:
            # data loss mid-stream: the op's partial state is
            # unrecoverable — a GROUP error, not a usage error
            raise CollectiveGroupError(
                f"co-hosted shm chunk {msg['shm'].hex()[:12]} vanished "
                f"from the arena before it was consumed"
            )
        try:
            flat_u8[off:off + msg["nbytes"]] = np.frombuffer(
                pin.view, dtype=np.uint8
            )
        finally:
            pin.release()
        rt.store.delete(msg["shm"])
    else:
        flat_u8[off:off + msg["nbytes"]] = np.asarray(
            msg["data"], dtype=np.uint8
        ).reshape(-1)


def _segment_bounds(n_elems: int, world_size: int) -> List[tuple]:
    """numpy.array_split segmentation as (start, stop) pairs."""
    base, extra = divmod(n_elems, world_size)
    bounds = []
    start = 0
    for i in range(world_size):
        stop = start + base + (1 if i < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


async def _overlap(send_coro, recv_coro):
    """Run one ring step's send and recv concurrently.  The recv error
    wins (group failure/timeout surfaces there first); the send is
    cancelled and drained so no exception goes unretrieved."""
    send = asyncio.ensure_future(send_coro)
    try:
        result = await recv_coro
    except BaseException:
        send.cancel()
        try:
            await send
        # deliberately swallows the cancelled send's outcome (incl. its
        # CancelledError): the recv-side failure re-raised below is the
        # actionable one, and the send MUST be drained here or its
        # exception is never retrieved
        except BaseException:  # rtlint: disable=RT107
            pass
        raise
    await send
    return result


async def _gather_all(coros):
    """Run sends to multiple peers concurrently (btree fan-out).  On
    the first failure every sibling send is cancelled AND drained so
    no exception goes unretrieved (same contract as _overlap)."""
    tasks = [asyncio.ensure_future(c) for c in coros]
    try:
        for t in tasks:
            await t
    except BaseException:
        for t in tasks:
            t.cancel()
        for t in tasks:
            # drained for the same reason as _overlap's loser path
            try:
                await t
            except BaseException:  # rtlint: disable=RT107
                pass
        raise


class RpcRingBackend(RuntimeBackend):
    kind = "runtime"

    async def setup(self):
        self.rt = self.manager.rt
        spec = self.spec
        self._next = (spec.rank + 1) % spec.world_size
        self._prev = (spec.rank - 1) % spec.world_size
        # plane: every rank on this node's shm arena, or crossing hosts
        # (an input to the algorithm selection table)
        self._all_cohosted = all(
            m.node_id == self.rt.node_id for m in spec.members
        )
        # dial the ring successor eagerly: first-op latency, and the
        # connection doubles as a liveness probe for that member
        if spec.world_size > 1:
            await self._conn(self._next)

    # ---- Collectives v2 config resolution ------------------------------
    def _codec(self, wire_dtype: Optional[str]):
        """The codec for one op: per-op ``wire_dtype`` beats the group
        option ("fp32" explicitly forces the raw path); None for raw.
        Instances are cached per backend — their scratch buffers are
        the point (ops run one at a time under the group op lock)."""
        wire = (
            wire_dtype if wire_dtype is not None
            else self.spec.options.wire_dtype
        )
        if wire is None or wire == "fp32":
            return None
        cache = getattr(self, "_codec_cache", None)
        if cache is None:
            cache = self._codec_cache = {}
        codec = cache.get(wire)
        if codec is None:
            codec = cache[wire] = quantize.get_codec(
                wire, self.spec.options.quant_block
            )
        return codec

    def _chunk_bytes(self) -> int:
        opt = self.spec.options.chunk_bytes
        return max(int(opt if opt is not None else
                       cfg.collective_chunk_bytes), 1)

    async def _select(self, op: str, nbytes: int,
                      override: Optional[str]) -> str:
        any_suspect = False
        if op == "broadcast" and override in (None, "auto"):
            # only broadcast topology consults health (see algorithms.py:
            # reductions must pick identically on every rank)
            any_suspect = bool(await self._suspect_ranks())
        return algorithms.select(
            op, nbytes, self.spec.world_size,
            all_cohosted=self._all_cohosted,
            options=self.spec.options,
            override=override,
            any_suspect=any_suspect,
        )

    async def _suspect_ranks(self) -> frozenset:
        nodes = await self.manager.suspect_nodes()
        if not nodes:
            return frozenset()
        return frozenset(
            m.rank for m in self.spec.members if m.node_id in nodes
        )

    def _escalate_mid_op(self, e: CollectiveError) -> CollectiveGroupError:
        """A codec rejection (non-finite data, wrong dtype) raised by
        THIS rank once a collective is underway is not a recoverable
        usage error: peers hold partial ring state or are parked
        waiting for our traffic.  Escalate to a GROUP error so
        _collective_op poisons locally and fans the failure out —
        peers fail fast instead of wedging until the op timeout."""
        return CollectiveGroupError(
            f"rank {self.spec.rank} aborted a collective on group "
            f"{self.spec.name!r} mid-op: {e}.  Peers hold partial "
            f"state — the group is poisoned; destroy and re-init (or "
            f"reform) with clean inputs."
        )

    async def _conn(self, peer_rank: int):
        m = self.spec.member(peer_rank)
        try:
            # node-labeled dial: the partition plane (faults.py link
            # cuts) must see collective peer traffic too
            conn = await self.rt.peer_connection_to(m.addr, m.node_id)
        except (OSError, asyncio.TimeoutError) as e:
            raise CollectiveGroupError(
                f"cannot reach {self.spec.describe_member(peer_rank)}: "
                f"{e!r}.  The member died — or its record is stale "
                f"(a previous group reused the name "
                f"{self.spec.name!r} without destroy_collective_group)."
            ) from e
        fault_ctl = faults.ACTIVE  # bind once: clear() races the check
        if fault_ctl is not None:
            # chaos site collective.peer_conn: a reset here severs the
            # ring exactly like a member dying mid-op — the group must
            # poison (and then be reformable), never wedge
            plan = fault_ctl.hit(
                faults.SITE_COLLECTIVE_PEER_CONN,
                f"{self.spec.name}:{peer_rank}",
            )
            if plan is not None and plan.action == "reset":
                await conn.close()
                raise CollectiveGroupError(
                    f"injected peer-conn reset to "
                    f"{self.spec.describe_member(peer_rank)}"
                )
        self.manager._track_conn(conn, self.spec.name, peer_rank)
        return conn

    # ---- wire helpers --------------------------------------------------
    def _cohosted(self, peer_rank: int) -> bool:
        return self.spec.member(peer_rank).node_id == self.rt.node_id

    async def _send_view(self, conn, peer_rank: int, tag: str, view,
                         base_offset: int = 0, extra: dict = None) -> None:
        """Ship one contiguous ndarray view as 1+ chunk messages, each
        tagged with its byte offset within the logical buffer.  Every
        awaited call doubles as a delivery ack, so a dead receiver
        surfaces here instead of buffering sends unboundedly.
        ``extra`` entries ride the FIRST chunk of this call only (the
        btree broadcast carries its rank order in-band this way;
        per-connection delivery is in-order, so the first chunk is
        enough — repeating it on every 4 MB chunk is pure overhead)."""
        import numpy as np

        spec = self.spec
        if view.nbytes == 0:
            return
        flat = view.reshape(-1)
        if flat.dtype != np.uint8:
            flat = flat.view(np.uint8)
        chunk = self._chunk_bytes()
        shm_ok = (
            self._cohosted(peer_rank)
            and view.nbytes >= cfg.collective_shm_min_bytes
        )
        for off in range(0, flat.nbytes, chunk):
            sub = flat[off:off + chunk]
            payload = {
                "op": "chunk",
                "group": spec.name,
                "inc": spec.incarnation,
                "src": spec.rank,
                "tag": tag,
                "offset": base_offset + off,
                "nbytes": sub.nbytes,
                "data": None,
                "shm": None,
            }
            if extra and off == 0:
                payload.update(extra)
            if shm_ok:
                oid = os.urandom(16)
                try:
                    # protect: an LRU pass must not evict the only copy
                    # inside the send→recv window; the receiver deletes
                    self.rt.store.put(oid, sub, protect=True)
                    payload["shm"] = oid
                except (StoreFullError, StoreError):
                    payload["shm"] = None  # arena pressure: wire fallback
            if payload["shm"] is None:
                payload["data"] = sub
            try:
                await conn.call(
                    RPC_METHOD, payload,
                    timeout=cfg.collective_op_timeout_s,
                )
            # BaseException: a cancelled send (_overlap's loser path)
            # must reclaim its sealed+protected chunk too, or failed
            # ops permanently pin arena capacity
            except BaseException:
                if payload["shm"] is not None:
                    try:
                        self.rt.store.delete(payload["shm"])
                    except Exception:
                        pass
                raise

    def _apply_chunk(self, flat_u8, msg: dict) -> None:
        apply_chunk(self.rt, flat_u8, msg)

    async def _recv_into(self, src: int, tag: str, out) -> None:
        """Fill contiguous ndarray ``out`` from (src, tag) chunks."""
        import numpy as np

        if out.nbytes == 0:
            return
        flat = out.reshape(-1)
        if flat.dtype != np.uint8:
            flat = flat.view(np.uint8)
        msgs = await self.manager.recv_chunks(
            self.spec.name, src, tag, out.nbytes
        )
        for m in msgs:
            self._apply_chunk(flat, m)

    def _tag(self) -> str:
        gh = self.manager.get_group(self.spec.name)
        gh.op_seq += 1
        return f"c{gh.op_seq}"

    # ---- collectives ---------------------------------------------------
    async def _reduce_scatter_inplace(self, flat, segs, op, tag, conn):
        """The ring reduce-scatter half: after n-1 steps rank r's flat
        segment r holds the full reduction (MEAN divides later)."""
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        scratch = np.empty(max(hi - lo for lo, hi in segs), dtype=flat.dtype)
        for step in range(n - 1):
            s_lo, s_hi = segs[(r - step - 1) % n]
            r_lo, r_hi = segs[(r - step - 2) % n]
            stag = f"{tag}.r{step}"
            incoming = scratch[: r_hi - r_lo]
            await _overlap(
                self._send_view(conn, self._next, stag, flat[s_lo:s_hi]),
                self._recv_into(self._prev, stag, incoming),
            )
            apply_reduce(op, flat[r_lo:r_hi], incoming)

    async def _reduce_scatter_quant(self, flat, segs, op, tag, conn, codec):
        """Quantized ring reduce-scatter: each hop ships the encoded
        partial segment (absmax re-derived per hop, so growing partial
        sums never clip); accumulation stays f32 local.  The wire-out,
        wire-in and decode buffers are allocated ONCE and reused across
        hops — each chunk rpc is awaited, so reuse never races a send."""
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        max_seg = max(hi - lo for lo, hi in segs)
        max_enc = codec.encoded_nbytes(max_seg)
        wire_buf = np.empty(max_enc, np.uint8)
        inbuf = np.empty(max_enc, np.uint8)
        fuse_add = op in (ReduceOp.SUM, ReduceOp.MEAN)
        dec = None if fuse_add else np.empty(max_seg, np.float32)
        for step in range(n - 1):
            s_lo, s_hi = segs[(r - step - 1) % n]
            r_lo, r_hi = segs[(r - step - 2) % n]
            stag = f"{tag}.r{step}"
            wire_out = codec.encode(
                flat[s_lo:s_hi], out=wire_buf[: codec.encoded_nbytes(s_hi - s_lo)]
            )
            wire_in = inbuf[: codec.encoded_nbytes(r_hi - r_lo)]
            await _overlap(
                self._send_view(conn, self._next, stag, wire_out),
                self._recv_into(self._prev, stag, wire_in),
            )
            if fuse_add:  # decode + accumulate in one pass
                codec.decode_add_into(wire_in, flat[r_lo:r_hi])
            else:
                incoming = dec[: r_hi - r_lo]
                codec.decode_into(wire_in, incoming)
                apply_reduce(op, flat[r_lo:r_hi], incoming)

    async def _allgather_quant(self, flat, segs, tag, conn, codec):
        """Quantized ring allgather of the reduced segments: each
        segment is encoded ONCE by its owner (who adopts its own
        decode) and the encoding circulates VERBATIM — every rank
        decodes identical bytes, so all ranks finish bit-identical."""
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        lo, hi = segs[r]
        enc = {r: codec.encode(flat[lo:hi])}
        codec.decode_into(enc[r], flat[lo:hi])
        for step in range(n - 1):
            s_blk = (r - step) % n
            r_blk = (r - step - 1) % n
            stag = f"{tag}.g{step}"
            b_lo, b_hi = segs[r_blk]
            # the received encoding is FORWARDED verbatim next step, so
            # it cannot ride a reused scratch — fresh per hop
            inbuf = np.empty(codec.encoded_nbytes(b_hi - b_lo), np.uint8)
            await _overlap(
                self._send_view(conn, self._next, stag, enc[s_blk]),
                self._recv_into(self._prev, stag, inbuf),
            )
            enc[r_blk] = inbuf
            codec.decode_into(inbuf, flat[b_lo:b_hi])

    async def _allreduce_rd(self, flat, op, tag, codec):
        """Recursive doubling: log2(n) pairwise whole-vector exchanges
        (latency-optimal; pow2 worlds, enforced by the selection
        layer).  Pairwise sums commute bitwise, and the quantized path
        self-quantizes the accumulator before each add, so all ranks
        finish bit-identical either way."""
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        fuse_add = codec is not None and op in (ReduceOp.SUM, ReduceOp.MEAN)
        if codec is not None:
            wire = np.empty(codec.encoded_nbytes(flat.size), np.uint8)
            inbuf = np.empty_like(wire)
        incoming = None if fuse_add else np.empty_like(flat)
        for k in range(n.bit_length() - 1):
            peer = r ^ (1 << k)
            conn = await self._conn(peer)
            stag = f"{tag}.d{k}"
            if codec is not None:
                codec.encode(flat, out=wire)
                # adopt our own encoding BEFORE adding: both sides then
                # compute q(a)+q(b) == q(b)+q(a) — identical bits
                codec.decode_into(wire, flat)
                await _overlap(
                    self._send_view(conn, peer, stag, wire),
                    self._recv_into(peer, stag, inbuf),
                )
                if fuse_add:
                    codec.decode_add_into(inbuf, flat)
                    continue
                codec.decode_into(inbuf, incoming)
            else:
                await _overlap(
                    self._send_view(conn, peer, stag, flat),
                    self._recv_into(peer, stag, incoming),
                )
            apply_reduce(op, flat, incoming)

    async def allreduce(self, arr, op: ReduceOp, *,
                        wire_dtype: Optional[str] = None,
                        algorithm: Optional[str] = None):
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        a = np.array(arr, copy=True)
        if n == 1:
            return a
        codec = self._codec(wire_dtype)
        flat = a.reshape(-1)
        nbytes = (
            codec.encoded_nbytes(flat.size) if codec is not None
            else flat.nbytes
        )
        alg = await self._select("allreduce", nbytes, algorithm)
        tag = self._tag()
        try:
            if alg == "rd":
                await self._allreduce_rd(flat, op, tag, codec)
            else:
                segs = _segment_bounds(flat.size, n)
                conn = await self._conn(self._next)
                if codec is not None:
                    await self._reduce_scatter_quant(
                        flat, segs, op, tag, conn, codec
                    )
                    await self._allgather_quant(flat, segs, tag, conn, codec)
                else:
                    await self._reduce_scatter_inplace(
                        flat, segs, op, tag, conn
                    )
                    # allgather: circulate the reduced segments
                    for step in range(n - 1):
                        s_lo, s_hi = segs[(r - step) % n]
                        r_lo, r_hi = segs[(r - step - 1) % n]
                        stag = f"{tag}.g{step}"
                        await _overlap(
                            self._send_view(
                                conn, self._next, stag, flat[s_lo:s_hi]
                            ),
                            self._recv_into(
                                self._prev, stag, flat[r_lo:r_hi]
                            ),
                        )
        except CollectiveGroupError:
            raise
        except CollectiveError as e:
            raise self._escalate_mid_op(e)
        if op is ReduceOp.MEAN:
            np.divide(flat, n, out=flat, casting="unsafe")
        return a

    async def reducescatter(self, arr, op: ReduceOp, *,
                            wire_dtype: Optional[str] = None):
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        a = np.array(arr, copy=True)
        flat = a.reshape(-1)
        segs = _segment_bounds(flat.size, n)
        if n > 1:
            codec = self._codec(wire_dtype)
            tag = self._tag()
            conn = await self._conn(self._next)
            try:
                if codec is not None:
                    await self._reduce_scatter_quant(
                        flat, segs, op, tag, conn, codec
                    )
                else:
                    await self._reduce_scatter_inplace(
                        flat, segs, op, tag, conn
                    )
            except CollectiveGroupError:
                raise
            except CollectiveError as e:
                raise self._escalate_mid_op(e)
        lo, hi = segs[r]
        out = flat[lo:hi].copy()
        if op is ReduceOp.MEAN:
            np.divide(out, n, out=out, casting="unsafe")
        return out

    async def allgather(self, arr):
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        a = np.ascontiguousarray(arr)
        blocks: List = [None] * n
        blocks[r] = a.copy()
        if n == 1:
            return blocks
        tag = self._tag()
        conn = await self._conn(self._next)
        for step in range(n - 1):
            s_blk = (r - step) % n
            r_blk = (r - step - 1) % n
            stag = f"{tag}.a{step}"
            incoming = np.empty_like(a)
            await _overlap(
                self._send_view(conn, self._next, stag, blocks[s_blk]),
                self._recv_into(self._prev, stag, incoming),
            )
            blocks[r_blk] = incoming
        return blocks

    async def broadcast(self, arr, root: int, *,
                        wire_dtype: Optional[str] = None,
                        algorithm: Optional[str] = None):
        """Root's bytes to everyone.  The ROOT picks the algorithm
        (ring pipeline vs binomial tree, health-steered — see
        algorithms.py) and the choice propagates IN-BAND: btree chunk
        messages carry the tree's rank order, so non-roots never
        consult their own (possibly divergent) suspect view — they
        just consume from whoever sends first and forward accordingly.
        With a codec, the root encodes once and every rank (root
        included) adopts the decode of those same bytes, so all ranks
        return bit-identical tensors."""
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        if not (0 <= root < n):
            raise CollectiveError(f"broadcast root {root} out of range")
        codec = self._codec(wire_dtype)
        if r == root:
            a = np.ascontiguousarray(arr)
            enc_nbytes = (
                codec.encoded_nbytes(a.size) if codec is not None
                else a.nbytes
            )
            tag = self._tag()
            if n > 1:
                alg = await self._select("broadcast", enc_nbytes, algorithm)
                try:
                    wire = (
                        codec.encode(a.reshape(-1))
                        if codec is not None else None
                    )
                    payload = wire if codec is not None else a
                    if alg == "btree":
                        order = algorithms.btree_order(
                            n, root, await self._suspect_ranks()
                        )
                        _, children = algorithms.btree_parent_children(
                            order, r
                        )
                        conns = [(c, await self._conn(c)) for c in children]
                        await _gather_all([
                            self._send_view(
                                conn, c, tag, payload,
                                extra={"order": order},
                            )
                            for c, conn in conns
                        ])
                    else:
                        conn = await self._conn(self._next)
                        await self._send_view(conn, self._next, tag, payload)
                except CollectiveGroupError:
                    raise
                except CollectiveError as e:
                    raise self._escalate_mid_op(e)
            else:
                wire = (
                    codec.encode(a.reshape(-1))
                    if codec is not None else None
                )
            if codec is not None:
                return codec.decode(wire, a.size).reshape(a.shape)
            return a
        # non-root: validate an EXPLICIT per-op override symmetrically
        # (callers must pass the same overrides on every rank) — the
        # root raising a usage error while non-roots park in first_src
        # for the full op timeout would turn an argument typo into a
        # poisoned group.  The tag is allocated FIRST, exactly like the
        # root's path: every rank must consume one op tag per call or
        # the next op's tags desynchronize.
        a = np.asarray(arr)
        tag = self._tag()
        if algorithm is not None:
            algorithms.select(
                "broadcast",
                codec.encoded_nbytes(a.size) if codec is not None
                else a.nbytes,
                n, all_cohosted=self._all_cohosted,
                options=self.spec.options, override=algorithm,
            )
        if codec is not None:
            # receive the encoded bytes, decode at the end
            flat = np.empty(codec.encoded_nbytes(a.size), dtype=np.uint8)
        else:
            if a.nbytes and (
                not a.flags.writeable or not a.flags["C_CONTIGUOUS"]
            ):
                # task args deserialize read-only (zero-copy off the rpc
                # buffers); fill a writable copy — callers use the return
                a = np.array(a)
            flat = a.reshape(-1)
            if flat.dtype != np.uint8:
                flat = flat.view(np.uint8)
        await self._broadcast_consume(flat, root, tag)
        if codec is not None:
            return codec.decode(flat, a.size).reshape(a.shape)
        return a

    async def _broadcast_consume(self, flat_u8, root: int, tag: str):
        """Non-root half of broadcast: fill ``flat_u8`` from whichever
        parent the root's algorithm routed to us, forwarding each chunk
        as it lands (ring: to the ring successor until the pre-root
        rank; btree: to this rank's children per the in-band order)."""
        n, r = self.spec.world_size, self.spec.rank
        if flat_u8.nbytes == 0:
            return
        group = self.spec.name
        src = await self.manager.first_src(group, tag)
        fwd = None  # lazily resolved [(child_rank, conn), ...] or []
        got = 0
        while got < flat_u8.nbytes:
            msgs = await self.manager.recv_chunks(group, src, tag, 1)
            for m in msgs:
                order = m.get("order")
                if fwd is None:
                    if order is not None:  # btree: forward to children
                        _, children = algorithms.btree_parent_children(
                            order, r
                        )
                        fwd = [(c, await self._conn(c)) for c in children]
                    elif r != (root - 1) % n:  # ring: forward to next
                        fwd = [(self._next, await self._conn(self._next))]
                    else:  # ring chain ends just before the root
                        fwd = []
                self._apply_chunk(flat_u8, m)
                got += m["nbytes"]
                # the order list rides only the first chunk of each
                # edge (in-order delivery per connection); forward it
                # on OUR first chunk to each child, then drop it
                extra = {"order": order} if order is not None else None
                if fwd:
                    await _gather_all([
                        self._send_view(
                            conn, c, tag,
                            flat_u8[m["offset"]:m["offset"] + m["nbytes"]],
                            base_offset=m["offset"], extra=extra,
                        )
                        for c, conn in fwd
                    ])
        return

    async def broadcast_object(self, obj, root: int):
        import numpy as np

        n, r = self.spec.world_size, self.spec.rank
        if n == 1:
            return obj
        # wire_dtype="fp32": pickle bytes and the int64 length are not
        # float tensors — a group-level quantization option must never
        # leak into these control-plane transfers
        if r == root:
            # the runtime's serializer: torch tensors go through its
            # tensor reducer (dtype, shape and bytes; bf16 included)
            so = serialization.serialize(obj)
            blob = np.empty(so.total_bytes, dtype=np.uint8)
            so.write_into(memoryview(blob))
            await self.broadcast(
                np.array([len(blob)], dtype=np.int64), root,
                wire_dtype="fp32",
            )
            await self.broadcast(blob, root, wire_dtype="fp32")
            return obj
        size = np.zeros(1, dtype=np.int64)
        await self.broadcast(size, root, wire_dtype="fp32")
        payload = np.empty(int(size[0]), dtype=np.uint8)
        await self.broadcast(payload, root, wire_dtype="fp32")
        return serialization.deserialize(memoryview(payload))

    async def barrier(self):
        import numpy as np

        # raw path always: the 1-int32 token is not a float tensor, and
        # a group-level wire_dtype must not make barrier() raise
        await self.allreduce(
            np.zeros(1, dtype=np.int32), ReduceOp.SUM, wire_dtype="fp32"
        )
        return True

    # ---- point to point ------------------------------------------------
    async def send(self, arr, dst: int):
        import numpy as np

        spec = self.spec
        if dst == spec.rank:
            raise CollectiveError("send to self")
        if not (0 <= dst < spec.world_size):
            raise CollectiveError(f"send dst {dst} out of range")
        gh = self.manager.get_group(spec.name)
        seq = gh.p2p_send_seq.get(dst, 0)
        gh.p2p_send_seq[dst] = seq + 1
        conn = await self._conn(dst)
        await self._send_view(
            conn, dst, f"p{seq}", np.ascontiguousarray(arr)
        )
        return True

    async def recv(self, arr, src: int):
        import numpy as np

        spec = self.spec
        if src == spec.rank:
            raise CollectiveError("recv from self")
        if not (0 <= src < spec.world_size):
            raise CollectiveError(f"recv src {src} out of range")
        gh = self.manager.get_group(spec.name)
        seq = gh.p2p_recv_seq.get(src, 0)
        gh.p2p_recv_seq[src] = seq + 1
        a = np.asarray(arr)
        if a.nbytes and (not a.flags.writeable or not a.flags["C_CONTIGUOUS"]):
            a = np.array(a)  # read-only task arg: fill a writable copy
        await self._recv_into(src, f"p{seq}", a)
        return a
