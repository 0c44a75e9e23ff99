"""1F1B micro-batch schedule for the MPMD pipeline.

Two pure functions the driver (and tests) share:

- ``stage_ops(s, n_stages, n_micro)``: the op sequence ONE stage
  executes — this is exactly the order the driver enqueues calls on
  that stage's actor, and sync actors execute per-caller calls in
  admission order, so the actor's queue IS the schedule.  Dataflow
  (activation/grad refs) enforces the cross-stage dependencies; queue
  order enforces the rest.

- ``submission_order(n_stages, n_micro)``: a global interleaving of
  every stage's op list in which each op appears after the op that
  produces its input ref — the order the driver must CREATE the calls
  in (a ref must exist before it can be passed as an argument; it need
  not be resolved).  Only the driver-ref handoff needs this: under the
  p2p channel handoff there are no refs to thread, and the driver
  ships each stage its own ``stage_ops`` list in ONE batched
  ``run_ops`` control call (stages self-synchronize on channel
  arrival).

The last stage has no separate B ops: its forward fuses loss + the
first backward step (see partition.StagePrograms), which is what makes
the schedule 1F1B rather than GPipe — memory stays bounded by the
warmup depth, not the microbatch count.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

Op = Tuple[str, int]  # ("F" | "B", micro_index)


def stage_ops(s: int, n_stages: int, n_micro: int) -> List[Op]:
    """The 1F1B op order for stage ``s``: warmup forwards (pipeline
    depth remaining below this stage), steady-state F/B alternation,
    cooldown backwards.  The last stage is all (fused) forwards."""
    if n_micro < 1:
        raise ValueError("n_micro must be >= 1")
    if s == n_stages - 1:
        return [("F", m) for m in range(n_micro)]
    warmup = min(n_micro, n_stages - 1 - s)
    ops: List[Op] = [("F", m) for m in range(warmup)]
    f, b = warmup, 0
    while f < n_micro:
        ops.append(("F", f))
        ops.append(("B", b))
        f += 1
        b += 1
    while b < n_micro:
        ops.append(("B", b))
        b += 1
    return ops


def op_dep(s: int, kind: str, m: int,
           n_stages: int) -> Optional[Tuple[int, str, int]]:
    """The producing op whose ref this op consumes (None: driver input)."""
    if kind == "F":
        return None if s == 0 else (s - 1, "F", m)
    # B on stage s < last consumes the grad from the stage above; the
    # stage right below the last consumes the last stage's FUSED F
    if s == n_stages - 2:
        return (n_stages - 1, "F", m)
    return (s + 1, "B", m)


def submission_order(n_stages: int,
                     n_micro: int) -> List[Tuple[int, str, int]]:
    """Dependency-respecting global merge of every stage's op list.

    Deterministic; preserves each stage's own op order (the per-actor
    queue order) and emits an op only after its producer."""
    lists = [stage_ops(s, n_stages, n_micro) for s in range(n_stages)]
    ptr = [0] * n_stages
    total = sum(len(l) for l in lists)
    done = set()
    order: List[Tuple[int, str, int]] = []
    while len(order) < total:
        progressed = False
        for s in range(n_stages):
            while ptr[s] < len(lists[s]):
                kind, m = lists[s][ptr[s]]
                dep = op_dep(s, kind, m, n_stages)
                if dep is not None and dep not in done:
                    break
                order.append((s, kind, m))
                done.add((s, kind, m))
                ptr[s] += 1
                progressed = True
        if not progressed:  # pragma: no cover — 1F1B is always feasible
            raise RuntimeError(
                f"1F1B submission deadlock at {ptr} "
                f"(n_stages={n_stages}, n_micro={n_micro})"
            )
    return order


def inflight_micros(s: int, n_stages: int, n_micro: int) -> int:
    """Peak in-flight microbatches at stage ``s`` under 1F1B — warmup
    depth + the one steady-state forward.  Sizes the channel window
    (pre-posted receive slots / unreaped async sends): the schedule can
    never put more than this many of one stage's payloads in flight."""
    if s == n_stages - 1:
        return 1  # fused fwd+loss+bwd: consumed as it arrives
    return min(n_micro, n_stages - s)


def bubble_micro_ops(n_stages: int) -> int:
    """Micro-op count of ONE pipeline bubble: the fill/drain ramp is
    (n_stages - 1) microbatches deep, each a forward + a backward —
    the acceptance bound on work lost to a preemption."""
    return 2 * (n_stages - 1)
