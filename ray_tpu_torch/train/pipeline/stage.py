"""The long-lived pipeline stage actor (port of ``ray_tpu/train/pipeline/stage.py``).

One process per (stage, dp lane).  It holds the stage's blocks (and, on the
edge stages, the tail) on ``spec["device"]``, their optimizers, the 1F1B
activation stash and the step's gradient accumulators, and runs forward and
backward micro-ops in the order the driver enqueued them (a sync actor runs
one caller's calls in admission order, so the actor's queue IS the 1F1B
schedule of this stage).

Every micro-op is EXACTLY-ONCE under migration:

- a per-step ledger caches each completed op's reply keyed by (kind, step,
  micro); a call retried after a migration returns the cached value
  without applying its effects again;
- ``__rt_checkpoint__`` captures the parameters, the optimizer states, the
  accumulators, the stash and the ledger (as CPU tensors), so the runtime's
  drain migrates the stage MID-STEP with its in-flight microbatches; the
  restored actor continues the step, it does not restart it;
- dp > 1 stages are ranks of a runtime collective group joined at configure
  time, which the drain re-forms around a migrated member.

Microbatch handoff (spec["handoff"]):

- ``"p2p"`` (default): adjacent stages of one dp lane are ranks of a
  per-lane collective group and stream activations and gradients over
  persistent channels (``util/collective/channel.py``); the driver's calls
  carry control only.  Ops synchronise by fetching ``seq = step·n_micro +
  micro`` (the ledger key carried onto the wire), and the async sends
  overlap the next micro-op's compute.  Channel outboxes ride the
  checkpoint, so a migrated member re-offers its in-flight payloads.
- ``"driver"``: every activation and gradient is an ObjectRef through the
  driver.

Everything that crosses the process boundary is a contiguous CPU tensor (on
a channel, its bytes as a numpy array); nothing is rounded on the way.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.train.pipeline.partition import (
    StagePrograms,
    flatten_grads,
    from_wire,
    get_partition,
    to_cpu,
    to_wire,
    unflatten_grads,
)


def _stage_device(spec: dict) -> torch.device:
    """The stage's device; "cuda" raises where this lease holds no card."""
    device = torch.device(spec.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"pipeline stage {spec['stage_idx']} wants device 'cuda', but its lease holds "
            f"no card (CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES', '')!r}); "
            "lease it a GPU, or run the pipeline with device='cpu'")
    return device


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


def _cpu_tree(obj):
    """``obj`` (dicts, lists, tuples of tensors and plain values) with every
    tensor copied to the CPU: what a checkpoint carries."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_tree(v) for v in obj)
    return obj


@ray_tpu_torch.remote
class PipelineStageActor:
    """One pipeline stage lane (rank ``lane`` of the stage's dp group)."""

    def __init__(self):
        self._spec: Optional[dict] = None
        self._progs: Optional[StagePrograms] = None
        self._device = None
        self._act_dtype = None
        self._blocks = None
        self._tail = None
        self._opt_blocks = None
        self._opt_tail = None
        self._acc_blocks = None
        self._acc_tail = None
        self._stash: Dict[int, Any] = {}
        self._ledger: Dict[tuple, Any] = {}
        self._losses: Dict[int, Dict[int, Any]] = {}
        self._executed = 0
        self._deduped = 0
        self._ch: Dict[str, Any] = {}
        self._p2p = False

    # -- topology discovery (WorkerGroup rank assignment) ----------------
    def node_info(self) -> dict:
        from ray_tpu_torch.train.worker_group import actor_node_info

        return actor_node_info()

    def set_env(self, env: Dict[str, str]) -> bool:
        os.environ.update(env)
        return True

    # -- lifecycle -------------------------------------------------------
    def configure(self, spec: dict, blocks, tail=None) -> dict:
        """Install the stage: build its programs and modules on
        ``spec["device"]`` from the state dicts ``blocks`` (and ``tail`` on
        the edge stages), make the optimizers, and join the lane group (p2p)
        and the stage's dp group (dp > 1) under rank ``lane``.

        spec keys: model, model_config, n_stages, stage_idx, n_micro, dp,
        lane, optimizer, scale, device, group_name, collective_backend,
        collective_options (optional: wire_dtype / algorithm / chunk_bytes
        for the dp gradient all-reduce; None keeps the exact f32 ring),
        handoff, lane_group (the p2p channel group).
        """
        self._build(spec)
        p = self._progs
        if (p.is_first or p.is_last) and tail is None:
            raise ValueError("first/last pipeline stages need the tail params")
        self._install(blocks, tail if (p.is_first or p.is_last) else None)
        self._opt_blocks = p.init_opt(self._blocks)
        if self._tail is not None:
            self._opt_tail = p.init_opt(self._tail)
        if spec.get("handoff", "driver") == "p2p" and spec["n_stages"] > 1:
            from ray_tpu_torch.util import collective as col

            # every actor joins its LANE group before its dp group: the two
            # group families partition the actors two ways, and one join
            # order keeps the concurrent configure() rendezvous cycle-free.
            # No options: activations cross the wire exactly.
            col.init_collective_group(
                spec["n_stages"], spec["stage_idx"],
                backend=spec.get("collective_backend", "rpc"),
                group_name=spec["lane_group"],
            )
            self._open_channels()
        if spec["dp"] > 1:
            from ray_tpu_torch.util import collective as col

            # group options, not per-op arguments: the wire format rides the
            # rendezvous records, so a drain's reform keeps the same data path
            col.init_collective_group(
                spec["dp"], spec["lane"],
                backend=spec.get("collective_backend", "rpc"),
                group_name=spec["group_name"],
                options=spec.get("collective_options"),
            )
        return {"pid": os.getpid(), "host": socket.gethostname(), "device": str(self._device)}

    def _build(self, spec: dict) -> None:
        self._device = _stage_device(spec)
        part = get_partition(spec["model"], spec["model_config"])
        self._progs = StagePrograms(
            part, spec["n_stages"], spec["stage_idx"], spec["optimizer"], spec["scale"],
        )
        self._act_dtype = part.config.dtype
        self._spec = spec

    def _install(self, blocks_state, tail_state) -> None:
        spec = self._spec
        blocks, tail = self._progs.part.stage_layout(spec["n_stages"], spec["stage_idx"], self._device)
        blocks.load_state_dict(blocks_state)
        self._blocks = blocks
        if tail_state is not None:
            tail.load_state_dict(tail_state)
            self._tail = tail

    # -- p2p channels ------------------------------------------------------
    def _open_channels(self) -> None:
        """Open this stage's persistent channel ends on the lane group
        (group-lazy: only registers endpoints and reform listeners, so the
        restore path may call it BEFORE the group re-join)."""
        from ray_tpu_torch.train.pipeline import schedule as sched
        from ray_tpu_torch.util.collective.channel import (
            ChannelReceiver,
            ChannelSender,
        )

        spec = self._spec
        s, S, M = spec["stage_idx"], spec["n_stages"], spec["n_micro"]
        g = spec["lane_group"]
        depth = sched.inflight_micros(s, S, M)
        self._ch = {}
        if s > 0:
            self._ch["fwd_in"] = ChannelReceiver(g, "F", s - 1)
            self._ch["grad_out"] = ChannelSender(g, "B", s - 1, window=depth)
        if s < S - 1:
            self._ch["fwd_out"] = ChannelSender(g, "F", s + 1, window=depth)
            self._ch["grad_in"] = ChannelReceiver(g, "B", s + 1)
        if s in (0, S - 1):
            # the edge stages exchange their raw tail-gradient sums at apply
            # time over a "T" stream (seq = step)
            peer = S - 1 if s == 0 else 0
            self._ch["tail_out"] = ChannelSender(g, "T", peer)
            self._ch["tail_in"] = ChannelReceiver(g, "T", peer)
        self._p2p = True

    def _seq(self, step: int, micro: int) -> int:
        # the exactly-once ledger key carried onto the wire: pure in (step,
        # micro), so a migrated retry fetches or posts the SAME position
        return step * self._spec["n_micro"] + micro

    def _reap_sends(self) -> None:
        """Surface terminal async-send failures on the next micro-op."""
        for ch in self._ch.values():
            reap = getattr(ch, "reap", None)
            if reap is not None:
                reap()

    # -- exactly-once ledger ---------------------------------------------
    def _cached(self, key):
        if key in self._ledger:
            self._deduped += 1
            return True, self._ledger[key]
        return False, None

    def _tokens(self, a):
        return torch.as_tensor(np.asarray(a)).to(self._device, torch.long)

    # -- micro-ops ---------------------------------------------------------
    def forward(self, step: int, micro: int, payload=None, targets=None):
        """First stage: payload = tokens (mb, S); returns h.  Mid stage:
        payload = h from the stage before; returns h.  Last stage: payload =
        h, targets (mb, S); the fused forward, loss and start of the
        backward, returning the gradient for the stage before (the
        microbatch's loss stays here; the driver reads the step's mean with
        ``step_loss``).

        p2p: a non-first stage ignores ``payload`` and fetches ``seq`` off
        the lane channel; the output is POSTED on (async, so the transfer
        overlaps the next op's compute) and the driver gets an ack."""
        key = ("F", step, micro)
        hit, val = self._cached(key)
        if hit:
            return val
        p = self._progs
        seq = None
        if self._p2p:
            seq = self._seq(step, micro)
            self._reap_sends()
            if not p.is_first:
                # fetch BEFORE counting the execution: an op that dies
                # waiting on the wire did no work to dedupe
                payload = from_wire(self._ch["fwd_in"].fetch(seq), self._act_dtype, self._device)
        self._executed += 1
        if p.is_first:
            payload = self._tokens(payload)
        else:
            payload = payload.to(self._device)
        if p.is_last:
            loss, (gb, gt, gh) = p.fwd_loss(self._blocks, self._tail, payload,
                                            self._tokens(targets))
            self._accumulate(gb, gt)
            self._losses.setdefault(step, {})[micro] = np.float32(loss.item())
            out = to_cpu(gh)
            if self._p2p:
                self._ch["grad_out"].post(seq, to_wire(out))
                out = True
        else:
            if p.is_first:
                h = p.fwd(self._blocks, self._tail, payload)
            else:
                h = p.fwd(self._blocks, payload)
            self._stash[micro] = payload
            out = to_cpu(h)
            if self._p2p:
                self._ch["fwd_out"].post(seq, to_wire(out))
                out = True
        self._ledger[key] = out
        return out

    def backward(self, step: int, micro: int, g_out=None):
        """Backward from the stash, recomputing the forward, on first and
        mid stages; returns the gradient for the stage before (True on the
        first stage: token gradients stop here).  p2p: ``g_out`` is fetched
        off the lane channel and the gradient posted on."""
        key = ("B", step, micro)
        hit, val = self._cached(key)
        if hit:
            return val
        p = self._progs
        if p.is_last:
            raise RuntimeError(
                "last-stage backward is fused into forward; the driver "
                "must not submit B ops to the last stage"
            )
        seq = None
        if self._p2p:
            seq = self._seq(step, micro)
            self._reap_sends()
            g_out = from_wire(self._ch["grad_in"].fetch(seq), self._act_dtype, self._device)
        self._executed += 1
        g_out = g_out.to(self._device)
        h_in = self._stash.pop(micro)
        if p.is_first:
            gb, gt = p.bwd(self._blocks, self._tail, h_in, g_out)
            self._accumulate(gb, gt)
            out = True
        else:
            gb, gh = p.bwd(self._blocks, h_in, g_out)
            self._accumulate(gb, None)
            out = to_cpu(gh)
            if self._p2p:
                self._ch["grad_out"].post(seq, to_wire(out))
                out = True
        self._ledger[key] = out
        return out

    def run_ops(self, step: int, ops, tokens=None, targets=None) -> bool:
        """ONE control call per stage per step (p2p): run this stage's
        whole 1F1B op list in order; activations and gradients move on the
        lane channels, so the call carries only the edge stages' token and
        target slices, (n_micro, lane_mb, seq_len), and returns one ack.
        Every micro-op still ledgers on its own, so a batch retried after a
        migration re-runs only the ops actually lost."""
        for kind, m in ops:
            if kind == "F":
                self.forward(
                    step, m,
                    tokens[m] if tokens is not None else None,
                    targets[m] if targets is not None else None,
                )
            else:
                self.backward(step, m)
        return True

    def _accumulate(self, g_blocks, g_tail):
        p = self._progs
        self._acc_blocks = (g_blocks if self._acc_blocks is None
                            else p.tree_add(self._acc_blocks, g_blocks))
        if g_tail is not None:
            self._acc_tail = (g_tail if self._acc_tail is None
                              else p.tree_add(self._acc_tail, g_tail))

    # -- step end ---------------------------------------------------------
    def tail_grads(self, step: int):
        """This side's RAW accumulated tail-gradient sum (the edge stages
        exchange these; see the partition module)."""
        key = ("TG", step)
        hit, val = self._cached(key)
        if hit:
            return val
        out = to_cpu(self._acc_tail)
        self._ledger[key] = out
        return out

    def apply_gradients(self, step: int, other_tail_grads=None) -> bool:
        """All-reduce (dp > 1), scale and update; clears the step's
        accumulators and expires the ledger entries of PAST steps (the
        current step's stay: a lost apply reply must dedupe)."""
        key = ("A", step)
        hit, val = self._cached(key)
        if hit:
            return val
        p = self._progs
        self._executed += 1
        g_blocks = self._acc_blocks
        g_tail = None
        if p.is_first or p.is_last:
            if (self._p2p and other_tail_grads is None
                    and "tail_in" in self._ch):
                other_tail_grads = self._exchange_tail(step)
            other = _to_device(other_tail_grads, self._device)
            # the operand order (first_side, last_side): both tail copies
            # compute the same sum bit for bit
            own = self._acc_tail
            first_side = own if p.is_first else other
            last_side = other if p.is_first else own
            g_tail = p.tree_add(first_side, last_side)
        if self._spec["dp"] > 1:
            g_blocks, g_tail = self._allreduce(g_blocks, g_tail)
        p.apply(self._blocks, self._opt_blocks, p.tree_scale(g_blocks))
        if g_tail is not None:
            p.apply(self._tail, self._opt_tail, p.tree_scale(g_tail))
        self._acc_blocks = None
        self._acc_tail = None
        self._stash.clear()
        if self._p2p:
            # PAST steps only (seq < step·M): the current step's payloads
            # stay re-deliverable until the NEXT apply proves every fetch of
            # this step done (the driver finishes step k before it submits
            # k+1).  The "T" stream counts steps, not micro seqs.
            base = step * self._spec["n_micro"]
            for ch in self._ch.values():
                ch.purge_below(step if ch.stream == "T" else base)
        self._ledger = {
            k: v for k, v in self._ledger.items() if k[1] >= step
        }
        self._losses = {s: v for s, v in self._losses.items() if s >= step}
        self._ledger[key] = True
        return True

    def _exchange_tail(self, step: int):
        """Edge-stage tail-gradient swap over the lane "T" stream: post the
        own RAW sum as one f32 vector, fetch the peer's, unflatten against
        the local tree (both edges hold the same tail).  seq = step, so a
        migrated retry posts and fetches the same position."""
        own = to_cpu(self._acc_tail)
        self._ch["tail_out"].post(step, flatten_grads(own).numpy())
        return unflatten_grads(own, self._ch["tail_in"].fetch(step))

    def _allreduce(self, g_blocks, g_tail):
        """Gradient all-reduce over the stage group, riding out a migration
        window: between a peer's old worker dying and the reform completing
        the group is transiently poisoned or uninitialised here.  The op
        changes no actor state, so retrying against the re-formed group is
        exact.  A peer that is really gone keeps the group poisoned past the
        budget, and the error surfaces."""
        import time as _time

        from ray_tpu_torch.common.config import cfg
        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective.types import CollectiveError

        group = self._spec["group_name"]
        deadline = _time.monotonic() + float(
            self._spec.get("allreduce_retry_timeout_s")
            or cfg.collective_rendezvous_timeout_s
        )
        # ONE op per apply: blocks (and the tail, where this stage holds
        # one) in a single f32 vector
        flat_b = flatten_grads(g_blocks)
        flat = flat_b if g_tail is None else torch.cat([flat_b, flatten_grads(g_tail)])
        flat = flat.cpu().numpy()
        while True:
            try:
                summed = col.allreduce(flat, group_name=group)
                break
            except CollectiveError:
                if _time.monotonic() >= deadline:
                    raise
                _time.sleep(0.5)
        summed = torch.from_numpy(np.ascontiguousarray(summed))
        n_b = flat_b.numel()
        out_blocks = unflatten_grads(g_blocks, summed[:n_b])
        out_tail = unflatten_grads(g_tail, summed[n_b:]) if g_tail is not None else None
        return out_blocks, out_tail

    def step_loss(self, step: int) -> float:
        """Mean per-microbatch loss of this lane for ``step`` (last stage)."""
        per = self._losses.get(step)
        if per is None:
            raise RuntimeError(f"no losses recorded for step {step}")
        vals = np.array([per[m] for m in sorted(per)], dtype=np.float32)
        return float(np.float32(vals.sum() / np.float32(len(vals))))

    # -- introspection ----------------------------------------------------
    def get_params(self):
        """The stage's state dicts, as CPU copies."""
        return {"blocks": _cpu_tree(self._blocks.state_dict()),
                "tail": _cpu_tree(self._tail.state_dict()) if self._tail is not None else None}

    def group_rank(self):
        from ray_tpu_torch.util import collective as col

        return col.get_rank(self._spec["group_name"])

    def counters(self) -> dict:
        from ray_tpu_torch.common import faults, serialization as ser
        from ray_tpu_torch.core.runtime import get_runtime

        return {
            "pid": os.getpid(),
            "executed": self._executed,
            "deduped": self._deduped,
            "copy_trace": dict(ser.COPY_TRACE),
            "slab_hits": get_runtime().store.stats().get("slab_hits", 0),
            # RT_FAULTS firings in THIS worker process (faults.trace() is
            # per-process state)
            "fault_trace": faults.trace(),
        }

    # -- migration hooks (the runtime's drain) ----------------------------
    def __rt_checkpoint__(self):
        return _cpu_tree({
            "spec": self._spec,
            "blocks": self._blocks.state_dict(),
            "tail": self._tail.state_dict() if self._tail is not None else None,
            "opt_blocks": self._opt_blocks.state_dict(),
            "opt_tail": self._opt_tail.state_dict() if self._opt_tail is not None else None,
            "acc_blocks": self._acc_blocks,
            "acc_tail": self._acc_tail,
            "stash": dict(self._stash),
            "ledger": dict(self._ledger),
            "losses": {s: dict(v) for s, v in self._losses.items()},
            "executed": self._executed,
            "deduped": self._deduped,
            # unpurged channel payloads: the restored twin re-offers these
            # into the re-formed lane group
            "send_outbox": {
                name: ch.outbox_state()
                for name, ch in self._ch.items()
                if hasattr(ch, "outbox_state")
            },
        })

    def __rt_restore__(self, state):
        self._build(state["spec"])
        p = self._progs
        self._install(state["blocks"], state["tail"])
        self._opt_blocks = p.init_opt(self._blocks)
        self._opt_blocks.load_state_dict(state["opt_blocks"])
        if self._tail is not None:
            self._opt_tail = p.init_opt(self._tail)
            self._opt_tail.load_state_dict(state["opt_tail"])
        dev = self._device
        self._acc_blocks = _to_device(state["acc_blocks"], dev)
        self._acc_tail = _to_device(state["acc_tail"], dev)
        self._stash = {m: _to_device(v, dev) for m, v in state["stash"].items()}
        self._ledger = state["ledger"]
        self._losses = state["losses"]
        self._executed = state["executed"]
        self._deduped = state["deduped"]
        spec = state["spec"]
        if spec.get("handoff") == "p2p" and spec["n_stages"] > 1:
            # endpoints and reform listeners only: the lane-group re-join
            # runs AFTER this hook (the worker's collective re-join), and its
            # install fires the listeners, which re-offer the outboxes
            self._open_channels()
            for name, st in (state.get("send_outbox") or {}).items():
                ch = self._ch.get(name)
                if ch is not None and hasattr(ch, "restore_outbox"):
                    ch.restore_outbox(st)
