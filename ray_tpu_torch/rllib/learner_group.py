"""LearnerGroup: data-parallel gradient updates across learner actors
(port of ``ray_tpu/rllib/learner_group.py``).

Role-equivalent of ray: rllib/core/learner/learner_group.py:64 +
learner.py:104.  Each learner holds its module on its device (``"cuda"``
unless the config asks for the CPU) and takes gradients with autograd; the
group averages the learners' gradients (equal shards, so the same update
as one learner on the full batch, the loss being a shard mean), and every
learner applies the same averaged update: the replicas stay bit-identical
without a parameter server.

The optimizer is optax's ``chain(clip_by_global_norm(c), adam(lr))``: the
gradients are scaled by ``c / ‖g‖`` only when ``‖g‖ >= c``, with no
epsilon (``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6`` and
would not be the same update), and Adam is ``parallel/spmd.py``'s
``adam``, optax's arithmetic.

num_learners <= 1 keeps the learner in process (a "local learner").  With
n >= 2 each learner is an actor; on ``"cuda"`` each leases one card, and a
group wanting more cards than the node has is refused where it is made.
"""

from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel.spmd import adam, global_norm
from ray_tpu_torch.rllib.core import state_dict_cpu


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient becomes
    ``g / ‖g‖ * max_norm`` when the global norm ``‖g‖ >= max_norm``, else
    stays.  Decided on the device (no host read).  Returns ``‖g‖``."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def to_tensors(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: integer arrays (actions) as
    int64 for ``gather``, floats as f32."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            a = np.asarray(v)
            v = torch.from_numpy(a if a.flags.writeable else a.copy())
        t = v.long() if not v.is_floating_point() else v.float()
        out[k] = t.to(device)
    return out


class Learner:
    """Minimal learner contract: autograd gradients plus the optax-exact
    update.

    Subclasses set ``self.device``, ``self.module`` (an ``nn.Module`` on
    that device), call :meth:`_init_optimizer`, and define
    ``_loss(batch) -> (loss, metrics)`` on a batch of device tensors.
    """

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    device: torch.device
    grad_clip: Optional[float] = None

    def _init_optimizer(self, lr: float, grad_clip: Optional[float] = None):
        self.grad_clip = grad_clip
        self.optimizer = adam(self.module.parameters(), lr)

    def _loss(self, batch):
        raise NotImplementedError

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return to_tensors(batch, self.device)

    def _grads(self, batch):
        """Backward of the loss on ``batch`` into the parameters' ``.grad``;
        returns the metrics as 0-d device tensors."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._loss(self._batch(batch))
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def _apply(self):
        if self.grad_clip is not None:
            grads = [p.grad for p in self.module.parameters() if p.grad is not None]
            clip_by_global_norm_(grads, self.grad_clip)
        self.optimizer.step()

    def compute_grads(self, batch):
        metrics = self._grads(batch)
        grads = {n: p.grad.detach().to("cpu", copy=True)
                 for n, p in self.module.named_parameters() if p.grad is not None}
        return grads, {k: float(v) for k, v in metrics.items()}

    def apply_grads(self, grads: Dict[str, torch.Tensor]):
        for n, p in self.module.named_parameters():
            p.grad = grads[n].to(p.device) if n in grads else None
        self._apply()

    def update(self, batch) -> Dict[str, float]:
        metrics = self._grads(batch)
        self._apply()
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return state_dict_cpu(self.module)

    def set_weights(self, weights) -> None:
        self.module.load_state_dict(weights)


def optimizer_state_cpu(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The optimizer's state dict with its tensors copied to the CPU."""
    sd = optimizer.state_dict()
    return {
        "state": {i: {k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
                      for k, v in s.items()} for i, s in sd["state"].items()},
        "param_groups": sd["param_groups"],
    }


@ray_tpu_torch.remote
class LearnerWorker:
    """One learner replica in its own process (on its leased card when the
    learner's device is ``"cuda"``)."""

    def __init__(self, factory):
        # one intra-op thread a leased CPU: more would contend with the
        # other learners and the runners on the host
        torch.set_num_threads(1)
        self.learner = factory()

    def compute_grads(self, batch):
        return self.learner.compute_grads(batch)

    def apply_grads(self, grads):
        self.learner.apply_grads(grads)
        return True

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w):
        self.learner.set_weights(w)
        return True

    def invoke(self, method, *args, **kwargs):
        return getattr(self.learner, method)(*args, **kwargs)


def _tree_mean(trees: List[Dict[str, torch.Tensor]]):
    return {k: sum(t[k] for t in trees) / len(trees) for k in trees[0]}


def _bcast_weights(inst, group_name: str, root: int, wire_dtype=None):
    """Runs INSIDE each LearnerWorker (via ``_apply``): one collective
    broadcast replaces the driver's N per-actor weight puts.

    With ``wire_dtype`` ("bf16"/"int8") the float32 tensors ride the
    block-quantized path; every replica INCLUDING the root adopts the
    decode of the one encoding, so replicas stay bit-identical to each
    other, the invariant the fp32 default guarantees exactly."""
    from ray_tpu_torch.util import collective as col

    rank = col.get_rank(group_name)
    w = col.broadcast_tree(
        inst.learner.get_weights() if rank == root else None,
        src_rank=root,
        group_name=group_name,
        wire_dtype=wire_dtype,
    )
    if rank != root or wire_dtype is not None:
        inst.learner.set_weights(w)
    return True


def node_gpus() -> float:
    """The cards of the node: the running cluster's ``GPU`` resource, or,
    before ``init``, what the node's detection finds (the
    ``gpu_count_override`` knob first)."""
    if ray_tpu_torch.is_initialized():
        return ray_tpu_torch.cluster_resources().get("GPU", 0)
    from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

    return GPUAcceleratorManager().num_gpus()


def check_learner_cards(num_learners: int, device, what: str = "") -> None:
    """Refuse, rather than wait on leases that cannot be had, learners on
    ``"cuda"`` (one card each) on a node with fewer cards: a group of
    ``num_learners >= 2`` (an in-process learner holds no lease), or, with
    ``what`` naming it, a lone learner actor of ``num_learners == 1``."""
    wanted = num_learners >= 2 or (what and num_learners >= 1)
    if wanted and torch.device(device).type == "cuda":
        have = node_gpus()
        if have < num_learners:
            what = what or f"a LearnerGroup of {num_learners} learners"
            raise RuntimeError(
                f"{what} on 'cuda' wants {num_learners} "
                f"GPU(s), one a learner; the node has {have:g}")


class LearnerGroup:
    """N-way data-parallel sgd steps with averaged gradients.

    ``device`` is the learners' (``"cuda"``: each learner actor leases one
    card).  ``weight_wire_dtype`` ("bf16"/"int8", default None = exact
    fp32) block-quantizes the weight-sync broadcasts (init sync and
    ``set_weights``); replicas remain bit-identical to EACH OTHER either
    way."""

    def __init__(self, factory: Callable[[], Learner], num_learners: int = 0,
                 weight_wire_dtype: Optional[str] = None, device="cuda"):
        self.num_learners = num_learners
        self.weight_wire_dtype = weight_wire_dtype
        check_learner_cards(num_learners, device)
        if num_learners <= 1:
            self.local: Optional[Learner] = factory()
            self.workers: List[Any] = []
        else:
            from ray_tpu_torch.util import collective as col

            self.local = None
            lease = ({"num_cpus": 1, "num_gpus": 1} if torch.device(device).type == "cuda"
                     else {"num_cpus": 1})
            self.workers = [
                LearnerWorker.options(**lease).remote(factory)
                for _ in range(num_learners)
            ]
            # weight sync rides a runtime collective group over the
            # learner actors instead of per-actor object puts
            self._col_group = f"learner-group-{uuid.uuid4().hex[:8]}"
            col.create_collective_group(
                self.workers, group_name=self._col_group
            )
            # all replicas must start from identical weights: collective
            # broadcast of replica 0's init
            self._broadcast_from_rank0()

    def _broadcast_from_rank0(self):
        ray_tpu_torch.get(
            [
                w._apply(_bcast_weights, self._col_group, 0,
                         self.weight_wire_dtype)
                for w in self.workers
            ],
            timeout=None,
        )

    @property
    def is_local(self) -> bool:
        return self.local is not None

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One sgd step on `batch` (dp-sharded when distributed)."""
        if self.local is not None:
            return self.local.update(batch)
        n = len(batch[next(iter(batch))])
        k = len(self.workers)
        shard = n // k
        assert shard > 0, f"batch of {n} too small for {k} learners"
        shards = [
            {key: v[i * shard:(i + 1) * shard] for key, v in batch.items()}
            for i in range(k)
        ]
        outs = ray_tpu_torch.get(
            [
                w.compute_grads.remote(s)
                for w, s in zip(self.workers, shards)
            ],
            timeout=None,
        )
        grads = _tree_mean([g for g, _ in outs])
        ray_tpu_torch.get(
            [w.apply_grads.remote(grads) for w in self.workers], timeout=None
        )
        metrics: Dict[str, float] = {}
        for _, m in outs:
            for key, v in m.items():
                metrics[key] = metrics.get(key, 0.0) + float(v) / len(outs)
        return metrics

    def get_weights(self):
        if self.local is not None:
            return self.local.get_weights()
        return ray_tpu_torch.get(self.workers[0].get_weights.remote(), timeout=None)

    def foreach_learner(self, method: str, *args, **kwargs) -> List[Any]:
        """Run a learner method on every replica (e.g. DQN sync_target)."""
        if self.local is not None:
            return [getattr(self.local, method)(*args, **kwargs)]
        return ray_tpu_torch.get(
            [w.invoke.remote(method, *args, **kwargs) for w in self.workers],
            timeout=None,
        )

    def set_weights(self, w):
        if self.local is not None:
            self.local.set_weights(w)
        else:
            # ship once to rank 0, then collective-broadcast to the rest
            ray_tpu_torch.get(
                self.workers[0].set_weights.remote(w), timeout=None
            )
            self._broadcast_from_rank0()

    def stop(self):
        if self.workers and getattr(self, "_col_group", None):
            from ray_tpu_torch.util import collective as col

            try:
                col.destroy_collective_group(
                    self._col_group, actors=self.workers
                )
            except Exception:
                pass  # a dead member mustn't block teardown
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
