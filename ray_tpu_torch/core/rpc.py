"""Asyncio message transport: symmetric request/response/notify over TCP.

Role-equivalent of the reference's RPC layer (ray: src/ray/rpc/grpc_server.h,
client_call.h) redesigned for a Python-asyncio control plane: one duplex
connection per peer pair carries requests in both directions (so GCS can push
pubsub messages down the same pipe a client calls up on), frames are
length-prefixed pickles, and large binary payloads ride pickle5 out-of-band
buffers to avoid copies.

Wire frame:  [u32 nbufs][u32 len_0]...[u32 len_{n-1}][buf_0]...[buf_{n-1}]
where buf_0 is the message pickle and buf_1.. are out-of-band buffers.
Message: (kind, msg_id, method, payload)  kind: 0=req, 1=resp-ok, 2=resp-err,
3=notify, 4=batch (payload is a list of non-batch messages; one frame, one
pickle parse, applied in arrival order).

Per-tick frame coalescing: `call_soon` requests and request responses do
not write their own frame — they append to a per-connection accumulator
that a `loop.call_soon` callback flushes, so every message issued within
one event-loop tick rides ONE vectored write (and the peer admits the
whole batch from one parse).  Latency-neutral at depth 1: the flush
callback runs before the loop can go back to sleep, and a single pending
message is written as a plain frame — bytes identical to the unbatched
protocol.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import pickle
import struct
import time
from typing import Any, Awaitable, Callable, Dict, Optional

from ray_tpu_torch.common import faults
from ray_tpu_torch.common.backoff import Backoff, BackoffPolicy
from ray_tpu_torch.common.config import cfg

logger = logging.getLogger(__name__)

_U32 = struct.Struct("<I")

REQUEST = 0
RESPONSE_OK = 1
RESPONSE_ERR = 2
NOTIFY = 3
BATCH = 4  # payload: list of (kind, msg_id, method, payload) messages

# process-wide outbound REQUEST tally (every Connection.call /
# call_soon, any peer).  Pure diagnostics: the pipeline bench reads
# the delta across a timed step to report driver rpcs per micro-op
# for the handoff A/B — never reset, wrap-free in practice.
CALLS = 0


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class RemoteCallError(RpcError):
    """The peer's handler raised; carries the remote exception."""

    def __init__(self, exc):
        super().__init__(f"remote handler raised: {exc!r}")
        self.remote_exception = exc


def _approx_payload_bytes(obj, depth: int = 3) -> int:
    """Cheap size estimate for batch-accumulator accounting: sums
    bytes-like payload bodies through shallow container nesting (spec
    dict → args list → ("val", b) tuple is depth 3).  Small control
    values estimate 0 — the count cap governs those."""
    t = type(obj)
    if t is bytes or t is bytearray or t is memoryview:
        return len(obj)
    if depth <= 0:
        return 0
    # explicit loops, not sum(genexpr): this runs per queued message on
    # the hot path and a generator object is a tracked gen0 alloc
    n = 0
    if t is tuple or t is list:
        for o in obj:
            n += _approx_payload_bytes(o, depth - 1)
    elif t is dict:
        for v in obj.values():
            n += _approx_payload_bytes(v, depth - 1)
    return n


def _dump(msg) -> list:
    bufs: list = [None]
    meta = pickle.dumps(
        msg, protocol=5, buffer_callback=lambda pb: bufs.append(pb.raw())
    )
    bufs[0] = meta
    return bufs


def _load(bufs: list):
    return pickle.loads(bufs[0], buffers=bufs[1:])


class Connection:
    """One duplex peer connection. Both sides can call() and notify()."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        handler: Callable[["Connection", str, Any], Awaitable[Any]],
        name: str = "",
        on_close: Optional[Callable[["Connection"], None]] = None,
        peer_endpoint: Optional[str] = None,
    ):
        self.reader = reader
        self.writer = writer
        self.handler = handler
        self.name = name
        self.on_close = on_close
        # logical endpoint of the peer ("gcs", a node id hex) when known
        # — the key the faults.py link-cut (network partition) site
        # matches on; None = unlabeled, never cut
        self.peer_endpoint = peer_endpoint
        self._msg_ids = itertools.count()
        self._pending: Dict[int, asyncio.Future] = {}
        self._send_lock = asyncio.Lock()
        self._closed = False
        self._recv_task: Optional[asyncio.Task] = None
        # per-tick frame coalescing: messages queued by call_soon /
        # response sends, flushed as one BATCH frame at tick end
        self._out_batch: list = []
        self._out_batch_bytes = 0  # _approx_payload_bytes running sum
        self._flush_scheduled = False
        # peers can stash identity here after a hello exchange
        self.peer_info: dict = {}

    def start(self) -> None:
        self._recv_task = asyncio.get_running_loop().create_task(self._recv_loop())

    # -- sending ---------------------------------------------------------
    async def _send(self, msg, urgent: bool = False) -> None:
        bufs = _dump(msg)
        async with self._send_lock:
            if self._closed:
                raise ConnectionLost(f"connection {self.name} is closed")
            # preserve program order with the coalesced path: anything
            # queued this tick goes on the wire before this message.
            # urgent (order-independent liveness traffic — heartbeats)
            # skips both the flush and the drain: its tiny frame must
            # not queue behind a large coalesced batch or a slow peer's
            # flow control — a loaded tick would otherwise delay the
            # detector's input past heartbeat_interval_s and manufacture
            # the exact false positive the health plane exists to avoid
            if self._out_batch and not urgent:
                self._flush_out_batch()
            self._write_frames(bufs)
            if not urgent:
                await self.writer.drain()

    def _write_frames(self, bufs):
        """Synchronous frame write (header + buffers, no await between
        writes — frames never interleave).  ONE encoder for _send and
        call_soon; wire-format changes live here only.

        Small frames coalesce into a single transport write: each write()
        tries a sock.send() when the buffer is empty, so header+payload
        as separate writes costs 2-3 syscalls per message — the dominant
        per-RPC term for control-plane traffic.  Large buffers still pass
        through uncopied (a memcpy of a big payload beats nothing)."""
        # chaos site rpc.link (outbound): a cut (local -> peer) link
        # swallows the frame — partition semantics are silence, not an
        # error, so the sender's call simply never completes
        if faults.LINKS_ACTIVE and self.peer_endpoint is not None:
            if faults.link_is_cut(faults.LOCAL_ENDPOINT, self.peer_endpoint):
                return
        fault_ctl = faults.ACTIVE  # bind once: clear() races the check
        if fault_ctl is not None:
            # chaos site rpc.send.frame: drop (frame vanishes — the peer
            # simply never sees these messages) or reset (transport
            # aborted; both sides observe ConnectionLost and run their
            # real loss paths)
            plan = fault_ctl.hit(faults.SITE_RPC_SEND_FRAME, self.name)
            if plan is not None:
                if plan.action == "drop":
                    return
                if plan.action == "reset":
                    try:
                        self.writer.transport.abort()
                    except Exception:
                        pass
                    return
        header = bytearray(_U32.pack(len(bufs)))
        total = 0
        for b in bufs:
            n = len(b) if isinstance(b, bytes) else b.nbytes
            header += _U32.pack(n)
            total += n
        if total < 65536:
            for b in bufs:
                header += b
            self.writer.write(bytes(header))
            return
        self.writer.write(bytes(header))
        for b in bufs:
            self.writer.write(b)

    async def call(self, method: str, payload: Any = None,
                   timeout: float = None, urgent: bool = False):
        """timeout=None → config default; timeout<0 → wait forever.
        ``urgent`` writes the request as its own lone frame ahead of any
        coalesced batch queued this tick (liveness traffic only)."""
        global CALLS
        if timeout is None:
            timeout = cfg.rpc_call_timeout_s
        elif timeout < 0:
            timeout = None
        CALLS += 1
        msg_id = next(self._msg_ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        try:
            await self._send((REQUEST, msg_id, method, payload), urgent)
            return await asyncio.wait_for(fut, timeout=timeout)
        finally:
            self._pending.pop(msg_id, None)

    def call_soon(self, method: str, payload: Any = None) -> "asyncio.Future":
        """Fire a request WITHOUT awaiting transport drain or the reply;
        returns the reply future (completed by the recv loop, failed with
        ConnectionLost on shutdown).  The hot-path primitive for high-rate
        callers (actor pushes): no per-call coroutine/Task, no wait_for
        timer — attach a done-callback instead.  Loop-only.

        Requests issued within one event-loop tick coalesce into a single
        BATCH frame (flushed by a loop.call_soon callback, so a lone
        request still hits the wire before the loop can sleep — depth-1
        latency is unchanged).  NB: skipping drain() skips asyncio's
        write flow control — transport.write buffers unboundedly — so
        callers MUST police `send_backlog` and fall back to an awaiting
        path (conn.drain) past their budget."""
        global CALLS
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        CALLS += 1
        msg_id = next(self._msg_ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        self._send_soon((REQUEST, msg_id, method, payload))
        return fut

    def _send_soon(self, msg) -> None:
        """Queue one message for the per-tick batch flush (loop-only)."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        self._out_batch.append(msg)
        self._out_batch_bytes += _approx_payload_bytes(msg[3])
        if (
            len(self._out_batch) >= cfg.rpc_batch_max_msgs
            or self._out_batch_bytes >= cfg.rpc_batch_max_bytes
        ):
            # count cap: a burst bigger than one tick's worth of batching
            # flushes mid-tick, so transport backlog becomes visible to
            # the callers policing send_backlog before the tick ends.
            # byte cap: large payloads (object chunks, big inline args)
            # must never coalesce into a frame past rpc_max_frame_bytes —
            # a single huge message flushes alone, as its own plain frame
            self._flush_out_batch()
        elif not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush_out_batch)

    def _flush_out_batch(self) -> None:
        """Write everything queued this tick as one frame.  A single
        queued message is written as a plain (non-BATCH) frame — the
        depth-1 wire bytes are identical to the unbatched protocol."""
        self._flush_scheduled = False
        batch = self._out_batch
        self._out_batch = []
        self._out_batch_bytes = 0
        if not batch or self._closed:
            # closed: _shutdown already failed every pending future;
            # dropping queued messages mirrors a loss mid-flight
            return
        try:
            if len(batch) == 1:
                self._write_frames(_dump(batch[0]))
            else:
                self._write_frames(_dump((BATCH, 0, "", batch)))
        except Exception:
            # transport died under us; the recv loop notices the loss and
            # fails every pending future via _shutdown
            logger.debug("batch flush failed on %s", self.name, exc_info=True)

    @property
    def send_backlog(self) -> int:
        """Bytes sitting unsent in the transport's write buffer."""
        try:
            return self.writer.transport.get_write_buffer_size()
        except Exception:
            return 0

    async def drain(self):
        """Await transport flow control (pauses while the peer is slow).
        Flushes the per-tick batch first so the backlog being drained
        includes everything queued this tick."""
        if self._out_batch:
            self._flush_out_batch()
        await self.writer.drain()

    async def notify(self, method: str, payload: Any = None,
                     urgent: bool = False) -> None:
        await self._send((NOTIFY, 0, method, payload), urgent)

    # -- receiving -------------------------------------------------------
    async def _read_frame(self):
        hdr = await self.reader.readexactly(_U32.size)
        (nbufs,) = _U32.unpack(hdr)
        if nbufs == 0 or nbufs > 1024:
            raise RpcError(f"bad frame: nbufs={nbufs}")
        lens_raw = await self.reader.readexactly(_U32.size * nbufs)
        lens = [_U32.unpack_from(lens_raw, i * _U32.size)[0] for i in range(nbufs)]
        total = sum(lens)
        if total > cfg.rpc_max_frame_bytes:
            raise RpcError(f"frame too large: {total}")
        bufs = []
        for ln in lens:
            bufs.append(await self.reader.readexactly(ln))
        return bufs

    async def _recv_loop(self):
        try:
            while True:
                bufs = await self._read_frame()
                kind, msg_id, method, payload = _load(bufs)
                if kind == BATCH:
                    # one parse for the whole tick's worth of peer
                    # messages; sub-messages apply in arrival order, so
                    # e.g. a run of push_task requests admits (and, with
                    # eager tasks, seq-admits) back-to-back in one pass
                    for kind, msg_id, method, sub in payload:
                        self._dispatch_msg(kind, msg_id, method, sub)
                else:
                    self._dispatch_msg(kind, msg_id, method, payload)
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            BrokenPipeError,
            OSError,
        ):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("rpc recv loop error on %s", self.name)
        finally:
            await self._shutdown()

    def _dispatch_msg(self, kind, msg_id, method, payload):
        """Route one inbound message (loop-only, called by the recv
        loop) — chaos site ``rpc.recv.msg`` guards the real dispatch,
        so drop/delay/dup/error faults apply per MESSAGE (batched and
        plain frames alike)."""
        # chaos site rpc.link (inbound): frames from a cut (peer ->
        # local) link were "lost in the network" — drop before dispatch
        if faults.LINKS_ACTIVE and self.peer_endpoint is not None:
            if faults.link_is_cut(self.peer_endpoint, faults.LOCAL_ENDPOINT):
                return
        fault_ctl = faults.ACTIVE  # bind once: clear() races the check
        if fault_ctl is not None:
            plan = fault_ctl.hit(
                faults.SITE_RPC_RECV_MSG, f"{self.name}:{method}"
            )
            if plan is not None and self._inject_recv_fault(
                plan, kind, msg_id, method, payload
            ):
                return
        self._dispatch_msg_now(kind, msg_id, method, payload)

    def _inject_recv_fault(self, plan, kind, msg_id, method, payload) -> bool:
        """Apply one recv-side fault; True = normal dispatch replaced."""
        act = plan.action
        if act == "drop":
            return True
        if act == "dup":
            # deliver one extra copy; the wrapper delivers the original
            self._dispatch_msg_now(kind, msg_id, method, payload)
            return False
        if act == "delay":
            asyncio.get_running_loop().call_later(
                plan.delay_s, self._dispatch_msg_now,
                kind, msg_id, method, payload,
            )
            return True
        if act == "error":
            injected = RpcError(f"injected fault at rpc.recv.msg:{method}")
            if kind == REQUEST:
                # the handler never runs; the caller sees a remote error
                try:
                    self._send_soon((RESPONSE_ERR, msg_id, method, injected))
                except ConnectionLost:
                    pass
            elif kind == RESPONSE_OK or kind == RESPONSE_ERR:
                # the reply arrives as a failure
                self._dispatch_msg_now(RESPONSE_ERR, msg_id, method, injected)
            # NOTIFY: no reply channel — an errored notify is a drop
            return True
        if act == "reset":
            try:
                self.writer.transport.abort()
            except Exception:
                pass
            return True
        return False

    def _dispatch_msg_now(self, kind, msg_id, method, payload):
        if kind == REQUEST:
            asyncio.get_running_loop().create_task(
                self._handle_request(msg_id, method, payload)
            )
        elif kind == NOTIFY:
            asyncio.get_running_loop().create_task(
                self._handle_notify(method, payload)
            )
        elif kind == BATCH:
            logger.warning("nested BATCH frame on %s dropped", self.name)
        else:
            # pop: call() also pops in its finally (harmless
            # no-op then); call_soon() futures are only removed
            # here or at shutdown
            fut = self._pending.pop(msg_id, None)
            if fut is not None and not fut.done():
                if kind == RESPONSE_OK:
                    fut.set_result(payload)
                else:
                    fut.set_exception(RemoteCallError(payload))

    async def _handle_request(self, msg_id, method, payload):
        try:
            result = await self.handler(self, method, payload)
        except ConnectionLost:
            return
        except Exception as e:
            logger.debug("handler %s raised: %r", method, e)
            result = _safe_exc(e)
            try:
                self._send_soon((RESPONSE_ERR, msg_id, method, result))
            except ConnectionLost:
                pass
            return
        # buffered reply: replies completed within one tick coalesce into
        # a single frame (a handler that ran synchronously under the eager
        # task factory replies in the same tick its request arrived).
        # call_soon's skipped flow control is restored here: past the
        # backlog budget the handler awaits the transport drain.
        try:
            self._send_soon((RESPONSE_OK, msg_id, method, result))
        except ConnectionLost:
            return
        if self.send_backlog > cfg.rpc_send_backlog_limit_bytes:
            try:
                await self.drain()
            except (ConnectionLost, OSError):
                pass

    async def _handle_notify(self, method, payload):
        try:
            await self.handler(self, method, payload)
        except Exception:
            logger.exception("notify handler %s raised", method)

    async def _shutdown(self):
        if self._closed:
            return
        self._closed = True
        self._out_batch.clear()
        self._out_batch_bytes = 0
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost(f"connection {self.name} lost"))
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:
            pass
        if self.on_close:
            try:
                self.on_close(self)
            except Exception:
                logger.exception("on_close callback failed")

    async def close(self):
        if self._recv_task:
            self._recv_task.cancel()
        await self._shutdown()

    @property
    def closed(self) -> bool:
        return self._closed


def _safe_exc(e: Exception):
    """Make an exception picklable; fall back to a generic RpcError."""
    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RpcError(f"{type(e).__name__}: {e}")


class Server:
    """Accepts connections; each gets the shared handler."""

    def __init__(
        self,
        handler: Callable[[Connection, str, Any], Awaitable[Any]],
        host: str = "127.0.0.1",
        port: int = 0,
        on_connect: Optional[Callable[[Connection], None]] = None,
        on_close: Optional[Callable[[Connection], None]] = None,
    ):
        self.handler = handler
        self.host = host
        self.port = port
        self.on_connect = on_connect
        self.on_close = on_close
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set[Connection] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._accept, host=self.host, port=self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def _accept(self, reader, writer):
        sock = writer.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        conn = Connection(
            reader, writer, self.handler,
            name=f"server@{self.port}", on_close=self._conn_closed,
        )
        self.connections.add(conn)
        if self.on_connect:
            self.on_connect(conn)
        conn.start()

    def _conn_closed(self, conn):
        self.connections.discard(conn)
        if self.on_close:
            self.on_close(conn)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def close(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for conn in list(self.connections):
            await conn.close()


class ReconnectingConnection:
    """A call/notify channel that survives peer restarts.

    Wraps a `Connection` to `address`; when the underlying connection is
    lost (peer crashed or restarted), calls block while a new connection
    is dialed with backoff, `on_reconnect(conn)` re-registers this client
    with the reborn peer, and the call is retried — up to
    `max_downtime_s` of cumulative downtime, after which ConnectionLost
    propagates.  This is the client half of GCS fault tolerance (ray:
    gcs_rpc_client.h reconnection + gcs_client resubscribe behavior):
    servers persist their tables; clients re-attach and replay identity.

    Retried calls must be idempotent — true for the control-plane verbs
    used over this channel (registrations, kv, lookups, notifies).
    """

    def __init__(
        self,
        address: str,
        handler: Callable[[Connection, str, Any], Awaitable[Any]] = None,
        name: str = "",
        on_reconnect: Optional[
            Callable[[Connection], Awaitable[None]]
        ] = None,
        on_give_up: Optional[Callable[[], None]] = None,
        max_downtime_s: float = None,
        peer_endpoint: Optional[str] = None,
    ):
        self.address = address
        self.handler = handler
        self.name = name
        self.peer_endpoint = peer_endpoint  # applied to every dialed conn
        self.on_reconnect = on_reconnect
        self.on_give_up = on_give_up
        self.max_downtime_s = (
            cfg.gcs_reconnect_max_downtime_s
            if max_downtime_s is None
            else max_downtime_s
        )
        self._conn: Optional[Connection] = None
        self._lock = asyncio.Lock()
        self._closed = False

    async def _ensure(self) -> Connection:
        if self._closed:
            raise ConnectionLost(f"{self.name}: channel closed")
        conn = self._conn
        if conn is not None and not conn.closed:
            return conn
        async with self._lock:
            if self._closed:
                raise ConnectionLost(f"{self.name}: channel closed")
            if self._conn is not None and not self._conn.closed:
                return self._conn
            # shared deadline-aware backoff (common/backoff.py): dials
            # de-correlate across the fleet via jitter, and the last
            # sleep clamps to the remaining downtime budget
            redial_backoff = Backoff(
                BackoffPolicy(
                    base_s=cfg.reconnect_backoff_base_s,
                    mult=cfg.backoff_mult,
                    max_s=cfg.reconnect_backoff_max_s,
                    jitter_frac=cfg.backoff_jitter_frac,
                ),
                deadline=time.monotonic() + self.max_downtime_s,
            )
            first_attempt = self._conn is None
            while True:
                conn = None
                try:
                    conn = await connect(
                        self.address, self.handler, name=self.name,
                        peer_endpoint=self.peer_endpoint,
                    )
                    if self.on_reconnect and not first_attempt:
                        await self.on_reconnect(conn)
                    self._conn = conn
                    return conn
                except BaseException as e:
                    # never leak a half-initialized connection (its recv
                    # loop would keep handling server pushes concurrently
                    # with the eventually-installed one)
                    if conn is not None and self._conn is not conn:
                        try:
                            await conn.close()
                        except Exception:
                            pass
                    if not isinstance(
                        e, (OSError, RpcError, asyncio.TimeoutError)
                    ):
                        raise
                    if not await redial_backoff.wait():
                        if self.on_give_up:
                            self.on_give_up()
                        raise ConnectionLost(
                            f"{self.name}: peer at {self.address} unreachable "
                            f"for {self.max_downtime_s:.0f}s ({e!r})"
                        ) from e

    async def call(self, method: str, payload: Any = None,
                   timeout: float = None, urgent: bool = False):
        while True:
            conn = await self._ensure()
            try:
                return await conn.call(method, payload, timeout=timeout,
                                       urgent=urgent)
            except ConnectionLost:
                if self._closed:
                    raise
                continue  # _ensure() re-dials with its own deadline

    async def notify(self, method: str, payload: Any = None,
                     urgent: bool = False) -> None:
        conn = await self._ensure()
        try:
            await conn.notify(method, payload, urgent=urgent)
        except ConnectionLost:
            if self._closed:
                raise
            conn = await self._ensure()
            await conn.notify(method, payload, urgent=urgent)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def current(self) -> Optional[Connection]:
        """The live underlying Connection, if any (for identity checks)."""
        return self._conn

    async def close(self):
        self._closed = True
        if self._conn is not None:
            await self._conn.close()


async def connect(
    address: str,
    handler: Callable[[Connection, str, Any], Awaitable[Any]] = None,
    name: str = "",
    on_close: Optional[Callable[[Connection], None]] = None,
    timeout: float = None,
    peer_endpoint: Optional[str] = None,
) -> Connection:
    if timeout is None:
        timeout = cfg.rpc_connect_timeout_s
    host, port_s = address.rsplit(":", 1)

    async def _null_handler(conn, method, payload):
        raise RpcError(f"unexpected inbound {method!r} on client-only connection")

    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, int(port_s)), timeout=timeout
    )
    sock = writer.get_extra_info("socket")
    if sock is not None:
        import socket as _socket

        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    conn = Connection(
        reader, writer, handler or _null_handler, name=name or address,
        on_close=on_close, peer_endpoint=peer_endpoint,
    )
    conn.start()
    return conn
