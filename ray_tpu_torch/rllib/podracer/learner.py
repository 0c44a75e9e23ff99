"""Central learner actor for the podracer plane (port of
``ray_tpu/rllib/podracer/learner.py``).

One process owns the training step.  Fragments arrive as ObjectRefs in
``ingest`` calls — the arg-unpack resolves them over the direct-shm get
path (zero-copy on the co-hosted node; the payload never transits the
driver) into CPU numpy arrays, which stay on the host until the learner's
update moves the assembled batch onto its device (``Learner._batch``).
An in-flight queue assembles fixed-size batches with staleness bounds: a
fragment whose policy lag exceeds ``max_policy_lag`` is DROPPED, at
ingest or at assembly time (droppable-on-lag — queued work can go stale
while it waits and must not train).  Fragments from SUSPECT runners are
deprioritized into a second queue consumed only when no fresh-node
fragment is available.

The learner's module lives on the learner's device (the card, unless its
config asks for the CPU; ``PodracerRunner`` leases the card for it).  The
actor is drain-plane checkpointable (``__rt_checkpoint__`` /
``__rt_restore__`` carry CPU copies of the params and of Adam's state, and
the policy-version counter; a restore puts them back onto this actor's
own device; queued fragments are droppable by design, so they are NOT
part of the migrated state).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.podracer.fragment import FragmentMeta, StalenessHistogram


@ray_tpu_torch.remote
class PodracerLearnerActor:
    """The fleet's single policy authority.

    ``learner_factory`` builds a ``rllib.learner_group.Learner`` inside
    this process; ``batch_from_fragments`` turns a list of fragment
    dicts into one training batch of ``batch_fragments`` fragments
    stacked along the env axis.
    """

    def __init__(
        self,
        learner_factory: Callable[[], Any],
        batch_from_fragments: Callable[[List[dict]], Dict[str, np.ndarray]],
        batch_fragments: int = 2,
        max_policy_lag: int = 4,
        train: bool = True,
        max_queue_fragments: Optional[int] = None,
    ):
        import torch

        # the lease holds one CPU: the host side of an update (batch
        # assembly, the launch loop) takes one intra-op thread
        torch.set_num_threads(1)
        self.learner = learner_factory()
        self._assemble = batch_from_fragments
        self._batch_fragments = int(batch_fragments)
        self._max_lag = int(max_policy_lag)
        self._train = bool(train)
        # backpressure cap: sampling can transiently outpace training;
        # beyond this the OLDEST queued fragment is shed (it is the one
        # closest to the staleness bound anyway)
        from ray_tpu_torch.common.config import cfg

        self._max_queue = (
            int(max_queue_fragments)
            if max_queue_fragments is not None
            else cfg.podracer_queue_factor * self._batch_fragments
        )
        self.policy_version = 0
        self._queue: collections.deque = collections.deque()
        self._suspect_queue: collections.deque = collections.deque()
        self._hist = StalenessHistogram()
        self._trained_fragments = 0
        self._dropped_stale = 0
        self._dropped_overflow = 0
        self._env_steps_trained = 0

    # -- fragment intake -------------------------------------------------
    def ingest(self, frag: Dict[str, np.ndarray], meta: dict):
        """Accept one fragment (payload resolved by arg-unpack from its
        shm ref); train when a full batch is assembled.  Returns
        ``{"episode_returns": [...], "train": stats-or-None}`` — small
        control-plane data only."""
        m = FragmentMeta.from_dict(meta)
        returns = [float(r) for r in np.asarray(frag["episode_returns"])]
        if self.policy_version - m.policy_version > self._max_lag:
            self._dropped_stale += 1
            # "version" rides EVERY ack: the driver's fan-out trigger
            # keys off it, so a fleet whose fragments all drop stale
            # still learns it must push fresh weights (training can run
            # ahead of acked updates — drain-consumed acks don't count)
            return {
                "episode_returns": returns, "train": None,
                "version": self.policy_version,
            }
        q = self._suspect_queue if m.suspect else self._queue
        q.append((m, frag))
        while (
            len(self._queue) + len(self._suspect_queue) > self._max_queue
        ):
            # shed oldest, suspect first
            (self._suspect_queue or self._queue).popleft()
            self._dropped_overflow += 1
        stats = self._maybe_train() if self._train else None
        return {
            "episode_returns": returns, "train": stats,
            "version": self.policy_version,
        }

    def _pop_fragment(self):
        """Fresh-node fragments strictly before suspect-node ones."""
        if self._queue:
            return self._queue.popleft()
        if self._suspect_queue:
            return self._suspect_queue.popleft()
        return None

    def _maybe_train(self) -> Optional[Dict[str, float]]:
        picked = []
        while len(picked) < self._batch_fragments:
            entry = self._pop_fragment()
            if entry is None:
                break
            m, frag = entry
            if self.policy_version - m.policy_version > self._max_lag:
                # went stale while queued: droppable-on-lag
                self._dropped_stale += 1
                continue
            picked.append(entry)
        if len(picked) < self._batch_fragments:
            # not enough fresh fragments yet: put them back in order,
            # each to the queue its suspect classification belongs to
            for entry in reversed(picked):
                q = self._suspect_queue if entry[0].suspect else self._queue
                q.appendleft(entry)
            return None
        batch = self._assemble([frag for _, frag in picked])
        metrics = self.learner.update(batch)
        for m, _ in picked:
            self._hist.add(self.policy_version - m.policy_version)
        self.policy_version += 1
        self._trained_fragments += len(picked)
        steps = sum(m.env_steps for m, _ in picked)
        self._env_steps_trained += steps
        out = {k: float(v) for k, v in metrics.items()}
        out["policy_version"] = self.policy_version
        out["env_steps_trained"] = steps
        out["fragments_in_batch"] = len(picked)
        return out

    # -- weights ---------------------------------------------------------
    def get_weights(self):
        """CPU copies of the learner's parameters (a state dict)."""
        return self.learner.get_weights()

    def set_weights(self, params, bump_version: bool = False) -> int:
        self.learner.set_weights(params)
        if bump_version:
            self.policy_version += 1
        return self.policy_version

    def serve_weight_broadcast(
        self, group_name: str, root_rank: int = 0,
        wire_dtype: Optional[str] = None,
    ) -> int:
        """Root side of the weight fan-out: one ``broadcast_tree`` over
        the podracer collective group replaces N per-runner puts.  The
        weights leave the learner's device as CPU copies for the host
        collective.  The skeleton carries the policy version exactly
        (ints never ride the quantized tensor path); with ``wire_dtype``
        the root adopts the decode of its own encoding back onto its
        device, so learner and every runner end bit-identical — the
        LearnerGroup invariant."""
        from ray_tpu_torch.util import collective as col

        tree = {"v": int(self.policy_version), "w": self.learner.get_weights()}
        out = col.broadcast_tree(
            tree, src_rank=root_rank, group_name=group_name,
            wire_dtype=wire_dtype,
        )
        if wire_dtype is not None and wire_dtype != "fp32":
            self.learner.set_weights(out["w"])
        return self.policy_version

    # -- observability ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "policy_version": self.policy_version,
            "trained_fragments": self._trained_fragments,
            "dropped_stale": self._dropped_stale,
            "dropped_overflow": self._dropped_overflow,
            "env_steps_trained": self._env_steps_trained,
            "queue_depth": len(self._queue) + len(self._suspect_queue),
            "suspect_queue_depth": len(self._suspect_queue),
            "staleness_hist": self._hist.snapshot(),
            "max_trained_lag": self._hist.max_lag,
        }

    # -- drain-plane migration hooks ------------------------------------
    def __rt_checkpoint__(self) -> dict:
        from ray_tpu_torch.rllib.learner_group import optimizer_state_cpu

        return {
            "params": self.learner.get_weights(),
            "opt_state": optimizer_state_cpu(self.learner.optimizer),
            "policy_version": self.policy_version,
            "trained_fragments": self._trained_fragments,
            "dropped_stale": self._dropped_stale,
            "dropped_overflow": self._dropped_overflow,
            "env_steps_trained": self._env_steps_trained,
            "staleness_hist": self._hist.state(),
        }

    def __rt_restore__(self, state: dict) -> None:
        # load_state_dict copies into this actor's own device tensors;
        # the optimizer moves its moments onto its parameters' device
        self.learner.set_weights(state["params"])
        self.learner.optimizer.load_state_dict(state["opt_state"])
        self.policy_version = int(state["policy_version"])
        self._trained_fragments = int(state["trained_fragments"])
        self._dropped_stale = int(state["dropped_stale"])
        self._dropped_overflow = int(state["dropped_overflow"])
        self._env_steps_trained = int(state["env_steps_trained"])
        self._hist.restore(state["staleness_hist"])
        # queued fragments are NOT migrated: they are droppable by the
        # staleness contract, and the fleet refills the queue in one
        # fragment interval
