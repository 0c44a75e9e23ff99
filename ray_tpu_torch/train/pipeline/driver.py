"""MPMD pipeline driver: stage gangs and the 1F1B dispatch loop (port of
``ray_tpu/train/pipeline/driver.py``).

``PipelineTrainer`` places each stage as a gang of ``dp`` long-lived actors
(one ``train.worker_group.WorkerGroup`` a stage: an atomic placement-group
reservation, node-aware lane ranks) and drives the 1F1B schedule over the
runtime's task plane.  Two data planes (``PipelineConfig.handoff``):

- ``"p2p"`` (default): adjacent stages stream activations and gradients over
  persistent per-lane channels (``util/collective/channel.py``) and the
  driver ships NO data per micro-op: ONE ``run_ops`` control call per stage
  per step carries the stage's whole 1F1B op list, the edge stages swap tail
  gradients over the lane "T" stream, and stage compute overlaps the
  transfers in flight.  Driver calls per step fall from O(micro-ops) to
  O(stages).
- ``"driver"``: every micro-op call's activation or gradient arrives as an
  ObjectRef through the runtime's object store.

The stages run on ``PipelineConfig.device``: "cuda" (the default) leases
each stage actor a card (bundle ``{"GPU": 1}``), and a cluster with fewer
cards than stages × lanes is refused at ``start()``; "cpu" leases a CPU.

``LocalPipelineRunner`` runs the SAME per-stage programs (same partition,
same accumulation order, same optimizer arithmetic) one after another in
one process: the single-gang reference the trainer is held to bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

import ray_tpu_torch
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.train.backend_executor import TrainWorkerGroupError
from ray_tpu_torch.train.pipeline import schedule as sched
from ray_tpu_torch.train.pipeline.partition import StagePrograms, get_partition
from ray_tpu_torch.train.pipeline.stage import PipelineStageActor


@dataclasses.dataclass
class PipelineConfig:
    """One MPMD pipeline run's shape."""

    model_config: Any
    model: str = "gpt2"
    n_stages: int = 2
    n_micro: int = 4
    micro_batch: int = 2       # rows per microbatch (global, split over dp)
    seq_len: int = 32
    dp: int = 1                # lanes per stage (ranks of the stage group)
    optimizer: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"name": "sgd", "lr": 0.1}
    )
    seed: int = 0
    name: str = "pipeline"
    collective_backend: str = "rpc"
    # the dp gradient all-reduce's data path: e.g. {"wire_dtype": "int8"}
    # block-quantizes the gradient vector, {"algorithm": "auto"} picks ring
    # or recursive doubling by size.  None keeps the f32 ring bit for bit,
    # which the dp parity depends on.
    collective_options: Optional[Dict[str, Any]] = None
    # in-flight micro-ops ride retries across a stage migration
    max_task_retries: int = 8
    get_timeout_s: float = 600.0
    # microbatch handoff plane: "p2p" or "driver" (see the module docstring)
    handoff: str = "p2p"
    # where the stages compute: "cuda" (a card a stage lane) unless the
    # caller asks for "cpu"
    device: str = "cuda"

    def __post_init__(self):
        if self.micro_batch % self.dp:
            raise ValueError(
                f"micro_batch {self.micro_batch} must divide over "
                f"dp {self.dp}"
            )
        if self.handoff not in ("p2p", "driver"):
            raise ValueError(
                f"handoff must be 'p2p' or 'driver', got "
                f"{self.handoff!r}"
            )
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")

    @property
    def scale(self) -> float:
        return 1.0 / float(self.n_micro * self.dp)

    @property
    def lane_mb(self) -> int:
        return self.micro_batch // self.dp

    def tokens_per_step(self) -> int:
        return self.n_micro * self.micro_batch * self.seq_len

    def stage_spec(self, stage_idx: int, lane: int) -> dict:
        return {
            "model": self.model,
            "model_config": self.model_config,
            "n_stages": self.n_stages,
            "stage_idx": stage_idx,
            "n_micro": self.n_micro,
            "dp": self.dp,
            "lane": lane,
            "optimizer": dict(self.optimizer),
            "scale": self.scale,
            "device": self.device,
            "group_name": f"{self.name}:stage{stage_idx}",
            "collective_backend": self.collective_backend,
            "collective_options": self.collective_options,
            "handoff": self.handoff,
            "lane_group": f"{self.name}:lane{lane}:pp",
        }


def synthetic_batches(config: PipelineConfig, steps: int,
                      seed: Optional[int] = None
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic token batches shared by the cluster run and the local
    reference: (tokens, targets) each (n_micro, micro_batch, seq_len) int32.
    numpy, so that the JAX package's pipeline sees the same tokens."""
    rng = np.random.default_rng(config.seed if seed is None else seed)
    vocab = config.model_config.vocab_size
    out = []
    for _ in range(steps):
        toks = rng.integers(
            0, vocab,
            (config.n_micro, config.micro_batch, config.seq_len + 1),
            dtype=np.int32,
        )
        out.append((toks[..., :-1], toks[..., 1:]))
    return out


def init_pp_params(config: PipelineConfig) -> nn.ModuleDict:
    """Driver-side model init and stage cut on the CPU, from a torch
    generator seeded with ``config.seed``.  All family knowledge comes from
    the partition registry (``models.pp.PARTITIONS``)."""
    part = get_partition(config.model, config.model_config)
    model = part.init(torch.Generator(device="cpu").manual_seed(config.seed), "cpu")
    return part.to_pp(model, config.n_stages)


def _long(a, device) -> torch.Tensor:
    """Token ids (a tensor or an array) as int64 on ``device``."""
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a)).to(device, torch.long)


def _state(module: nn.Module) -> dict:
    """A module's state dict as CPU copies (what a stage is shipped)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def _merged(config: PipelineConfig, stage_states, tail_state) -> nn.Module:
    """The full model on the CPU from each stage's and the tail's state
    dicts."""
    part = get_partition(config.model, config.model_config)
    pp = part.to_pp(part.empty("meta"), config.n_stages).to_empty(device="cpu")
    for stage, state in zip(pp["stages"], stage_states):
        stage.load_state_dict(state)
    pp["tail"].load_state_dict(tail_state)
    return part.from_pp(pp)


class PipelineTrainer:
    """Drives a 1F1B MPMD pipeline over stage actor gangs.

    Default placement: one WorkerGroup (placement group) of ``dp`` actors
    per stage, each leased ``bundle`` (``{"GPU": 1}`` for a "cuda" pipeline,
    ``{"CPU": 1}`` for "cpu").  ``stage_actor_options``, a [stage][lane]
    matrix of ``.options()`` dicts, creates the actors directly instead.
    """

    def __init__(self, config: PipelineConfig, *,
                 bundle: Optional[Dict[str, float]] = None,
                 placement_strategy: str = "PACK",
                 stage_actor_options: Optional[List[List[dict]]] = None):
        self.config = config
        self.bundle = bundle or ({"GPU": 1} if config.device == "cuda" else {"CPU": 1})
        self.placement_strategy = placement_strategy
        self.stage_actor_options = stage_actor_options
        self.actors: List[List[Any]] = []   # [stage][lane]
        self.worker_groups: List[Any] = []
        self.step = 0
        self.losses: List[float] = []

    # -- lifecycle -------------------------------------------------------
    def _check_cards(self) -> None:
        """Refuse, rather than wait on a reservation that cannot be had, a
        cluster with fewer cards than the stage lanes lease."""
        cfg = self.config
        want = self.bundle.get("GPU", 0) * cfg.n_stages * cfg.dp
        have = ray_tpu_torch.cluster_resources().get("GPU", 0)
        if want > have:
            raise RuntimeError(
                f"pipeline {cfg.name!r} wants {want:g} GPU(s) ({cfg.n_stages} stages x dp "
                f"{cfg.dp} x {self.bundle['GPU']:g}), the cluster has {have:g}")

    def start(self) -> None:
        cfg = self.config
        self._check_cards()
        actor_opts = {
            "max_task_retries": cfg.max_task_retries,
            # crash recovery is the trainer's gang restart; a drain's
            # MIGRATION consumes no restart budget
            "max_restarts": 0,
        }
        if self.stage_actor_options is not None:
            for s in range(cfg.n_stages):
                lanes = []
                for r in range(cfg.dp):
                    opts = dict(actor_opts)
                    opts.update(self.stage_actor_options[s][r])
                    lanes.append(PipelineStageActor.options(**opts).remote())
                self.actors.append(lanes)
        else:
            from ray_tpu_torch.train.worker_group import WorkerGroup

            for s in range(cfg.n_stages):
                wg = WorkerGroup(
                    cfg.dp, dict(self.bundle),
                    placement_strategy=self.placement_strategy,
                    actor_cls=PipelineStageActor,
                    actor_options=actor_opts,
                )
                self.worker_groups.append(wg)
                # lane = gang rank (node-grouped, deterministic)
                self.actors.append(
                    [w.actor for w in sorted(wg.workers, key=lambda w: w.rank)]
                )
        pp = init_pp_params(cfg)
        tail = _state(pp["tail"])
        refs = []
        for s in range(cfg.n_stages):
            blocks = _state(pp["stages"][s])
            for r in range(cfg.dp):
                refs.append(self.actors[s][r].configure.remote(
                    cfg.stage_spec(s, r), blocks,
                    tail if s in (0, cfg.n_stages - 1) else None,
                ))
        try:
            ray_tpu_torch.get(refs, timeout=cfg.get_timeout_s)
        except Exception as e:
            raise TrainWorkerGroupError(
                f"pipeline stage configure failed: {e}"
            ) from e

    def shutdown(self) -> None:
        for wg in self.worker_groups:
            try:
                wg.shutdown()
            except Exception:
                pass
        if not self.worker_groups:
            for lanes in self.actors:
                for a in lanes:
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:
                        pass
        self.actors = []
        self.worker_groups = []

    # -- the 1F1B dispatch loop -------------------------------------------
    def run_step(self, tokens: np.ndarray, targets: np.ndarray) -> float:
        """One training step: submit the whole 1F1B graph, wait for the
        applies, return the global mean loss.

        tokens/targets: (n_micro, micro_batch, seq_len) integer arrays; lane r
        takes the rows [r·lane_mb, (r+1)·lane_mb).
        """
        cfg = self.config
        S, M, dp, step = cfg.n_stages, cfg.n_micro, cfg.dp, self.step
        mb = cfg.lane_mb
        A = self.actors
        sink = []  # refs gathered only to surface errors
        if cfg.handoff == "p2p":
            # control only, O(1) calls per stage per step: one run_ops ships
            # a stage's whole 1F1B op list (and the edge stages' token and
            # target slices); the stages move every activation and gradient
            # between themselves on the lane channels
            for s in range(S):
                ops = sched.stage_ops(s, S, M)
                for r in range(dp):
                    rows = slice(r * mb, (r + 1) * mb)
                    sink.append(A[s][r].run_ops.remote(
                        step, ops,
                        tokens[:, rows] if s == 0 else None,
                        targets[:, rows] if s == S - 1 else None,
                    ))
            applies = [
                A[s][r].apply_gradients.remote(step)
                for r in range(dp) for s in range(S)
            ]
        else:
            h: Dict[Tuple[int, int, int], Any] = {}   # (s, m, r) -> ref
            g: Dict[Tuple[int, int, int], Any] = {}
            for s, kind, m in sched.submission_order(S, M):
                for r in range(dp):
                    rows = slice(r * mb, (r + 1) * mb)
                    if kind == "F":
                        if s == 0:
                            h[(0, m, r)] = A[0][r].forward.remote(step, m, tokens[m, rows])
                        elif s == S - 1:
                            # fused: the last stage's F returns the gradient
                            g[(s, m, r)] = A[s][r].forward.remote(
                                step, m, h[(s - 1, m, r)], targets[m, rows])
                        else:
                            h[(s, m, r)] = A[s][r].forward.remote(step, m, h[(s - 1, m, r)])
                    else:
                        ref = A[s][r].backward.remote(step, m, g[(s + 1, m, r)])
                        if s == 0:
                            sink.append(ref)
                        else:
                            g[(s, m, r)] = ref
            tg_first = [A[0][r].tail_grads.remote(step) for r in range(dp)]
            tg_last = [A[S - 1][r].tail_grads.remote(step) for r in range(dp)]
            applies = []
            for r in range(dp):
                applies.append(A[0][r].apply_gradients.remote(step, tg_last[r]))
                applies.append(A[S - 1][r].apply_gradients.remote(step, tg_first[r]))
                for s in range(1, S - 1):
                    applies.append(A[s][r].apply_gradients.remote(step))
        loss_refs = [A[S - 1][r].step_loss.remote(step) for r in range(dp)]
        try:
            ray_tpu_torch.get(sink + applies, timeout=cfg.get_timeout_s)
            lane_losses = ray_tpu_torch.get(loss_refs, timeout=cfg.get_timeout_s)
        except Exception as e:
            raise TrainWorkerGroupError(
                f"pipeline step {step} failed: {e}"
            ) from e
        loss = float(
            np.float32(np.sum(np.float32(lane_losses), dtype=np.float32)
                       / np.float32(dp))
        )
        self.step += 1
        self.losses.append(loss)
        return loss

    def train(self, batches) -> List[float]:
        return [self.run_step(x, y) for x, y in batches]

    # -- introspection ----------------------------------------------------
    def gather_params(self) -> nn.Module:
        """The merged full model, on the CPU, from lane 0 of every stage."""
        cfg = self.config
        per = ray_tpu_torch.get(
            [self.actors[s][0].get_params.remote() for s in range(cfg.n_stages)],
            timeout=cfg.get_timeout_s,
        )
        return _merged(cfg, [p["blocks"] for p in per], per[0]["tail"])

    def counters(self) -> List[List[dict]]:
        cfg = self.config
        return [
            ray_tpu_torch.get(
                [a.counters.remote() for a in lanes],
                timeout=cfg.get_timeout_s,
            )
            for lanes in self.actors
        ]

    def ideal_micro_ops(self, steps: int) -> int:
        """Micro-op executions over all stage lanes in ``steps`` clean
        steps: F and B per microbatch on each non-last stage, the fused F on
        the last, one apply per stage, times dp lanes."""
        cfg = self.config
        per_step = (2 * (cfg.n_stages - 1) + 1) * cfg.n_micro + cfg.n_stages
        return per_step * cfg.dp * steps


class LocalPipelineRunner:
    """The single-gang reference: same partition, same per-stage programs,
    same microbatch order, same optimizer arithmetic, in one process, on
    ``config.device`` (tensors stay there between stages; copies do not
    change bits).

    dp lanes run one after another; lane gradient sums use the 2-rank
    ring's operand order (elementwise a + b), so for dp <= 2 the trainer
    matches this runner bit for bit.  ``pp_params`` (a cut model) replaces
    the seeded init.
    """

    def __init__(self, config: PipelineConfig, pp_params: Optional[nn.ModuleDict] = None):
        self.config = config
        self.device = resolve_device(config.device)
        part = get_partition(config.model, config.model_config)
        S = config.n_stages
        self.progs = [
            StagePrograms(part, S, s, config.optimizer, config.scale)
            for s in range(S)
        ]
        pp = pp_params if pp_params is not None else init_pp_params(config)
        self.blocks, self.tails = [], {}
        for s in range(S):
            blocks, tail = part.stage_layout(S, s, self.device)
            blocks.load_state_dict(pp["stages"][s].state_dict())
            self.blocks.append(blocks)
            if s in (0, S - 1):
                tail.load_state_dict(pp["tail"].state_dict())
                self.tails[s] = tail
        self.opt_blocks = [self.progs[s].init_opt(self.blocks[s]) for s in range(S)]
        self.opt_tails = {s: self.progs[s].init_opt(t) for s, t in self.tails.items()}
        self.losses: List[float] = []

    def run_step(self, tokens: np.ndarray, targets: np.ndarray) -> float:
        cfg = self.config
        S, M, dp, mb = cfg.n_stages, cfg.n_micro, cfg.dp, cfg.lane_mb
        P = self.progs
        acc_b: List[List[Any]] = [[None] * S for _ in range(dp)]
        acc_t: List[Dict[int, Any]] = [{0: None, S - 1: None} for _ in range(dp)]
        lane_loss: List[List[np.float32]] = [[] for _ in range(dp)]
        tokens, targets = _long(tokens, self.device), _long(targets, self.device)

        def add(s, lane, g_blocks, g_tail=None):
            acc_b[lane][s] = (g_blocks if acc_b[lane][s] is None
                              else P[s].tree_add(acc_b[lane][s], g_blocks))
            if g_tail is not None:
                acc_t[lane][s] = (g_tail if acc_t[lane][s] is None
                                  else P[s].tree_add(acc_t[lane][s], g_tail))

        for m in range(M):
            for lane in range(dp):
                rows = slice(lane * mb, (lane + 1) * mb)
                toks, tgt = tokens[m, rows], targets[m, rows]
                stash = {0: toks}
                h = P[0].fwd(self.blocks[0], self.tails[0], toks)
                for s in range(1, S - 1):
                    stash[s] = h
                    h = P[s].fwd(self.blocks[s], h)
                loss, (gb, gt, gh) = P[S - 1].fwd_loss(self.blocks[S - 1], self.tails[S - 1], h, tgt)
                lane_loss[lane].append(np.float32(loss.item()))
                add(S - 1, lane, gb, gt)
                gdown = gh
                for s in range(S - 2, 0, -1):
                    gb, gdown = P[s].bwd(self.blocks[s], stash[s], gdown)
                    add(s, lane, gb)
                gb, gt = P[0].bwd(self.blocks[0], self.tails[0], stash[0], gdown)
                add(0, lane, gb, gt)

        # lane reduction: elementwise sum in lane order (the 2-rank ring's
        # a + b); dp == 1 skips it, as the trainer does
        for s in range(S):
            g = acc_b[0][s]
            for lane in range(1, dp):
                g = P[s].tree_add(g, acc_b[lane][s])
            P[s].apply(self.blocks[s], self.opt_blocks[s], P[s].tree_scale(g))
        # tail: (first_side, last_side) per lane, then the lane reduction
        for s in (0, S - 1):
            gt = P[s].tree_add(acc_t[0][0], acc_t[0][S - 1])
            for lane in range(1, dp):
                gt = P[s].tree_add(gt, P[s].tree_add(acc_t[lane][0], acc_t[lane][S - 1]))
            P[s].apply(self.tails[s], self.opt_tails[s], P[s].tree_scale(gt))
        lane_means = [
            float(np.float32(np.array(l, dtype=np.float32).sum() / np.float32(len(l))))
            for l in lane_loss
        ]
        loss = float(
            np.float32(np.sum(np.float32(lane_means), dtype=np.float32)
                       / np.float32(dp))
        )
        self.losses.append(loss)
        return loss

    def train(self, batches) -> List[float]:
        return [self.run_step(x, y) for x, y in batches]

    def gather_params(self) -> nn.Module:
        """The merged full model, on the CPU."""
        return _merged(self.config, [_state(b) for b in self.blocks], _state(self.tails[0]))
