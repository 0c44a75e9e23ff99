"""Compiled DAGs: static actor-method graphs on reusable shm channels.

Role-equivalent of ray: python/ray/dag/compiled_dag_node.py:186
(CompiledDAG) + dag_node binding surface.  `method.bind(...)` builds a
lazy node graph; `experimental_compile()` allocates one mutable shm
channel per edge (ray_tpu/dag/channel.py) and parks a persistent exec
loop on every participating actor.  `execute()` then moves data purely
through channels — no per-call task submission, no GCS, no RPC — which
is what makes pipeline-shaped execution (capability 8 of SURVEY §2.4)
cheap enough to matter.

Notes on the port:
- Channels are host-local (/dev/shm) and carry the port's serializer's
  bytes: a CUDA tensor that a stage returns reaches the next stage, or
  the driver, as a CPU tensor (``common/serialization.py``).  The
  reference's NCCL channel variant has no counterpart here.
- Depth-1 SPSC channels give natural backpressure: `execute()` blocks
  on the input channel while every stage is busy, so a pipeline of K
  stages holds at most K items in flight -- the reference bounds this
  with `_max_buffered_results` instead.
- The exec loop holds its actor's executor thread until teardown: a
  `.remote()` call on the same actor waits until then.
- A loop that dies (an output over ``buffer_size_bytes``, an actor's
  death) closes its channels; `get()` then raises the loop's own error,
  where the JAX package's raises a bare `ChannelClosedError`.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.common import serialization
from ray_tpu_torch.dag.channel import (
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
    make_channel_name,
)

_DEFAULT_BUFFER = 4 * 1024 * 1024

_VAL = b"V"
_ERR = b"E"


class DAGExecutionError(RuntimeError):
    pass


def _pack(kind: bytes, obj: Any) -> bytes:
    return kind + serialization.serialize(obj).to_bytes()


def _unpack(data: bytes) -> Tuple[bytes, Any]:
    return data[:1], serialization.deserialize(memoryview(data)[1:])


# ---------------------------------------------------------------------------
# Node graph (lazy binding surface)
# ---------------------------------------------------------------------------


class DAGNode:
    def experimental_compile(
        self, buffer_size_bytes: int = _DEFAULT_BUFFER
    ) -> "CompiledDAG":
        return CompiledDAG(self, buffer_size_bytes)


class InputNode(DAGNode):
    """The driver-fed entry point; use as a context manager like the
    reference (`with InputNode() as inp: ...`)."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method_name: str, args: tuple):
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args

    def __repr__(self):
        return f"ClassMethodNode({self.method_name})"


class MultiOutputNode(DAGNode):
    def __init__(self, outputs: List[DAGNode]):
        self.outputs = list(outputs)


# ---------------------------------------------------------------------------
# Actor-side exec loop (runs via the __rt_apply__ dispatch)
# ---------------------------------------------------------------------------


def _actor_exec_loop(instance, stages: List[dict], capacity: int,
                     ready_name: str):
    """Run this actor's DAG stages forever until a channel closes.

    `stages` (in topological order) each carry:
      method:  method name on the actor instance
      inputs:  list of ("chan", name) | ("const", serialized bytes)
      outputs: list of channel names (one per consumer edge + driver edge)
    """
    chans: Dict[str, Channel] = {}

    def chan(name: str) -> Channel:
        c = chans.get(name)
        if c is None:
            c = chans[name] = Channel(name, capacity)
        return c

    consts: Dict[int, list] = {}
    for si, st in enumerate(stages):
        consts[si] = [
            serialization.deserialize(v) if kind == "const" else None
            for kind, v in st["inputs"]
        ]
    try:
        # readiness barrier: the driver's compile() blocks until every
        # loop has signalled, so execute()/get() timeouts never race a
        # cold actor start (worker spawn + a torch import can take
        # a minute on a loaded host).
        Channel(ready_name, 8).write(b"R")
        while True:
            # read-per-stage in topo order: an actor hosting a->b chains
            # consumes a's output through a local channel like any other
            # edge, keeping one code path (the reference specializes this).
            for si, st in enumerate(stages):
                args, err = [], None
                for ai, (kind, v) in enumerate(st["inputs"]):
                    if kind == "const":
                        args.append(consts[si][ai])
                    else:
                        k, obj = _unpack(chan(v).read())
                        if k == _ERR:
                            err = obj
                        args.append(obj)
                if err is None:
                    try:
                        out = _pack(
                            _VAL, getattr(instance, st["method"])(*args)
                        )
                    except Exception as e:  # noqa: BLE001 - forwarded
                        out = _pack(_ERR, e)
                else:
                    out = _pack(_ERR, err)
                for name in st["outputs"]:
                    chan(name).write(out)
    except ChannelClosedError:
        pass
    finally:
        for c in chans.values():
            c.close()
            c.detach()
    return "dag-loop-done"


# ---------------------------------------------------------------------------
# Compiler + driver-side execution
# ---------------------------------------------------------------------------


class CompiledDAGRef:
    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = 120.0):
        return self._dag._get(self._seq, timeout)


class CompiledDAG:
    def __init__(self, root: DAGNode, buffer_size_bytes: int):
        self._capacity = int(buffer_size_bytes)
        # separate locks so an execute() blocked on a full pipeline never
        # prevents another thread's get() from draining the outputs
        self._exec_lock = threading.Lock()
        self._read_lock = threading.Lock()
        self._next_seq = 0
        self._results: Dict[int, Any] = {}
        self._next_read_seq = 0
        # outputs already drained for the iteration currently being read;
        # survives a ChannelTimeoutError so a retried get() resumes at the
        # first unread channel instead of re-reading channel 0 (which would
        # pair outputs from different iterations)
        self._partial_reads: List[Any] = []
        self._torn_down = False
        self._loop_refs: list = []
        self._compile(root)

    # -- graph analysis ----------------------------------------------

    def _compile(self, root: DAGNode) -> None:
        outputs = (
            root.outputs if isinstance(root, MultiOutputNode) else [root]
        )
        for o in outputs:
            if not isinstance(o, ClassMethodNode):
                raise TypeError(
                    "DAG outputs must be actor-method nodes, got "
                    f"{type(o).__name__}"
                )
        # topo-sort ClassMethodNodes reachable from the outputs
        order: List[ClassMethodNode] = []
        state: Dict[int, int] = {}  # id -> 0 visiting / 1 done
        self._input_node: Optional[InputNode] = None

        def visit(n: DAGNode):
            if isinstance(n, InputNode):
                if self._input_node is not None and self._input_node is not n:
                    raise ValueError("a DAG may have only one InputNode")
                self._input_node = n
                return
            if not isinstance(n, ClassMethodNode):
                return
            s = state.get(id(n))
            if s == 1:
                return
            if s == 0:
                raise ValueError("cycle detected in DAG")
            state[id(n)] = 0
            for a in n.args:
                visit(a)
            state[id(n)] = 1
            order.append(n)

        for o in outputs:
            visit(o)
        if self._input_node is None:
            raise ValueError(
                "DAG has no InputNode; bind at least one argument to it"
            )

        # one channel per (producer -> consumer-arg) edge
        self._input_channels: List[Channel] = []
        out_names: Dict[int, List[str]] = {id(n): [] for n in order}
        node_inputs: Dict[int, list] = {}
        for n in order:
            ins = []
            for a in n.args:
                if isinstance(a, InputNode):
                    name = make_channel_name()
                    self._input_channels.append(
                        Channel(name, self._capacity, create=True)
                    )
                    ins.append(("chan", name))
                elif isinstance(a, ClassMethodNode):
                    name = make_channel_name()
                    Channel(name, self._capacity, create=True).detach()
                    out_names[id(a)].append(name)
                    ins.append(("chan", name))
                else:
                    ins.append(
                        ("const", serialization.serialize(a).to_bytes())
                    )
            node_inputs[id(n)] = ins
        self._output_channels: List[Channel] = []
        for o in outputs:
            name = make_channel_name()
            self._output_channels.append(
                Channel(name, self._capacity, create=True)
            )
            out_names[id(o)].append(name)

        # group stages by actor, preserving topo order within each
        per_actor: Dict[Any, List[dict]] = {}
        self._actors = []
        for n in order:
            key = n.actor._actor_id
            if key not in per_actor:
                per_actor[key] = []
                self._actors.append(n.actor)
            per_actor[key].append(
                {
                    "method": n.method_name,
                    "inputs": node_inputs[id(n)],
                    "outputs": out_names[id(n)],
                }
            )
        self._all_channel_names = (
            [c.name for c in self._input_channels]
            + [c.name for c in self._output_channels]
            + [
                name
                for n in order
                for name in out_names[id(n)]
                if name not in {c.name for c in self._output_channels}
            ]
        )
        # park the exec loops (one long-running actor task per actor) and
        # wait for each to signal readiness through a one-shot channel
        ready_channels = []
        for actor in self._actors:
            stages = per_actor[actor._actor_id]
            ready_name = make_channel_name()
            ready_channels.append(Channel(ready_name, 8, create=True))
            ref = actor._apply(
                _actor_exec_loop, stages, self._capacity, ready_name
            )
            self._loop_refs.append(ref)
        for rc in ready_channels:
            rc.read(timeout=300.0, liveness=self._check_loops_alive)
            rc.unlink()

    # -- execution ----------------------------------------------------

    def _check_loops_alive(self) -> None:
        import ray_tpu_torch

        # a short wait, not timeout=0: the runtime's wait returns nothing
        # ready at timeout=0, even for a loop that has long ended (the JAX
        # package's check never fires for that reason; ROADMAP C)
        done, _ = ray_tpu_torch.wait(
            list(self._loop_refs), num_returns=len(self._loop_refs),
            timeout=0.01,
        )
        for ref in done:
            # a finished loop before teardown means the actor died or the
            # loop crashed; surface it instead of spinning on the channel
            ray_tpu_torch.get(ref)
            raise DAGExecutionError(
                "a DAG exec loop exited while the DAG was still active"
            )

    def _raise_dead_loop(self, timeout: float = 30.0) -> None:
        """A channel was closed before teardown: a loop died and closed
        its channels on the way out.  Wait for that loop's task to end and
        raise its error (e.g. the writer's capacity ValueError)."""
        import ray_tpu_torch

        ray_tpu_torch.wait(list(self._loop_refs), num_returns=1,
                           timeout=timeout)
        self._check_loops_alive()

    def execute(self, *args) -> CompiledDAGRef:
        if self._torn_down:
            raise DAGExecutionError("DAG has been torn down")
        if len(args) != 1:
            raise TypeError(
                "compiled DAG execute() takes exactly one input (the "
                "InputNode value)"
            )
        data = _pack(_VAL, args[0])
        with self._exec_lock:
            # two-phase publish: wait for EVERY input channel to drain,
            # then write them all — the writes cannot block (driver is
            # the sole writer), so a pipeline-full timeout raises with no
            # partial publish to desync stage iteration counts.
            try:
                for c in self._input_channels:
                    c.wait_empty(timeout=120.0,
                                 liveness=self._check_loops_alive)
            except ChannelTimeoutError as e:
                raise DAGExecutionError(
                    "pipeline is full and not draining — call .get() on "
                    "outstanding CompiledDAGRefs to free a slot"
                ) from e
            for c in self._input_channels:
                c.write(data)
            seq = self._next_seq
            self._next_seq += 1
        return CompiledDAGRef(self, seq)

    def _get(self, seq: int, timeout: Optional[float]):
        with self._read_lock:
            while seq not in self._results:
                if self._next_read_seq > seq:
                    # delivered and consumed: DAG results are single-use
                    # (matching the reference's one-get aDAG refs)
                    raise ValueError(
                        f"result for execution #{seq} was already consumed"
                    )
                vals = self._partial_reads
                for c in self._output_channels[len(vals):]:
                    try:
                        data = c.read(timeout=timeout,
                                      liveness=self._check_loops_alive)
                    except ChannelClosedError:
                        if not self._torn_down:
                            self._raise_dead_loop()
                        raise
                    vals.append(_unpack(data))
                self._partial_reads = []
                err = None
                for k, obj in vals:
                    if k == _ERR and err is None:
                        err = obj
                vals = [obj for _, obj in vals]
                if err is not None:
                    self._results[self._next_read_seq] = ("err", err)
                else:
                    self._results[self._next_read_seq] = (
                        "val",
                        vals if len(vals) > 1 else vals[0],
                    )
                self._next_read_seq += 1
            kind, payload = self._results.pop(seq)
        if kind == "err":
            raise payload
        return payload

    # -- lifecycle ----------------------------------------------------

    def teardown(self, timeout: float = 30.0) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        import ray_tpu_torch

        for c in self._input_channels + self._output_channels:
            c.close()
        # loops drain remaining work, hit CLOSED, and return
        try:
            ray_tpu_torch.wait(
                list(self._loop_refs),
                num_returns=len(self._loop_refs),
                timeout=timeout,
            )
        except Exception:
            pass
        for c in self._input_channels + self._output_channels:
            c.unlink()
        import os

        for name in self._all_channel_names:
            try:
                os.unlink(os.path.join("/dev/shm", name))
            except FileNotFoundError:
                pass

    def __del__(self):
        try:
            if not self._torn_down:
                self.teardown(timeout=1.0)
        except Exception:
            pass
