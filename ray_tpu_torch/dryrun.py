"""A dry run of the multi-GPU paths (port of ``__graft_entry__.dryrun_multichip``).

``dryrun_multigpu(n)`` starts ``n`` ranks (one process each) in a process
group and runs, on tiny shapes, one sharded step of each layout the
reference's dry run covers:

1. GPT-2 with ring attention over a mesh using every axis it can (tp, sp,
   fsdp, dp), inputs sharded over the data axes and the sequence over sp;
2. GPT-2 with experts over a mesh with a real ep axis;
3. (n >= 2) pipeline parallelism: GPipe microbatching over a pp mesh of 4
   stages (2 where n < 4), the activations passed on by a ring permute, one
   forward, backward and update;
4. (n >= 8, n % 4 == 0) GPT-2 cut into 2 pipeline stages on the six-axis
   mesh, composed with dp and tp (dp2 x pp2 x tp2 at n = 8);
5. (n >= 8) a multi-slice mesh, data parallel over dcn;
6. (n >= 4) tp-sharded Llama serving: a cached prefill and two row-wise
   decode steps;
7. (n % 4 == 0) ViT over fsdp × tp;
8. (n >= 2) RLlib: a PPO learner's update data parallel over a dp mesh of
   every rank, the batch sharded, the parameters replicated and the
   gradients averaged (the LearnerGroup's arithmetic in one program);
9. the gang's cross-process sum.

Where the reference fails on an involuntary rematerialisation in
XLA's partitioner, each pass here checks that every parameter, and the
optimizer's state of each, is sharded as the rule table says.

By default the ranks form an NCCL group, one card a rank, and the dry run
raises where fewer than ``n`` cards are visible; ``device_type="cpu"`` asks
for a gloo group on the CPU, as the tests and a one-card machine do.  Each
pass's ``OK`` line is printed by the caller's process; the losses are CPU
numbers when the ranks run there.

Run it as ``python -m ray_tpu_torch.dryrun [n] [--cpu]``.
"""

from __future__ import annotations

import math
from typing import List


def _mesh_config(n: int):
    """Factor n into (dp, fsdp, sp, tp), using every axis it can."""
    from ray_tpu_torch.parallel.mesh import MeshConfig

    rem = n
    tp = 2 if rem % 2 == 0 else 1
    rem //= tp
    sp = 2 if rem % 2 == 0 else 1
    rem //= sp
    fsdp = 2 if rem % 2 == 0 else 1
    rem //= fsdp
    return MeshConfig(dp=rem, fsdp=fsdp, sp=sp, tp=tp)


def _mesh_config_ep(n: int):
    """A mesh with a real ep axis (plus dp/tp where the ranks allow)."""
    from ray_tpu_torch.parallel.mesh import MeshConfig

    if n % 2 != 0:
        return None
    rem = n // 2
    tp = 2 if rem % 2 == 0 else 1
    return MeshConfig(dp=rem // tp, ep=2, tp=tp)


def _check_layout(mesh, model, logical, optimizer=None):
    """Every parameter, and each of its optimizer states that is shaped
    like it, is sharded as the active rule table says."""
    from ray_tpu_torch.parallel import spmd

    bad = spmd.layout_errors(mesh, model, logical, optimizer)
    if bad:
        raise AssertionError(f"not laid out as the rules say (name, placements, rules'): {bad}")


def _train_once(mesh, init_fn, logical, loss_fn, batch, shard_seq=False):
    """One sharded AdamW step; checks the layout after it; the loss."""
    from ray_tpu_torch.parallel import spmd

    state = spmd.sharded_init(mesh, init_fn, logical)
    opt = spmd.adamw(state.params.parameters(), 1e-3)
    step = spmd.compile_train_step(loss_fn, opt)
    state, metrics = step(state, spmd.shard_batch(mesh, batch, shard_seq=shard_seq))
    loss = metrics["loss"].item()
    if not math.isfinite(loss) or not math.isfinite(metrics["grad_norm"].item()):
        raise AssertionError(f"non-finite loss or gradient norm: {metrics}")
    _check_layout(mesh, state.params, logical, opt)
    return loss


def _batch_size(mc):
    shards = mc.dp * mc.fsdp
    return ((4 + shards - 1) // shards) * shards


def _gpipe_pass(n: int, dev: str, seeded) -> str:
    """Pass 3 (every rank calls it): tanh(x @ w + b) stages of width 16,
    Adam(1e-2), 4 microbatches of 2 rows, on the first 4 ranks (2 where
    n < 4); the others take the loss from rank 0."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.parallel import pipeline as pl
    from ray_tpu_torch.parallel import spmd

    n_stages = 4 if n >= 4 else 2
    width = 16
    g = seeded(2)
    w = torch.stack([torch.randn((width, width), generator=g, device=dev) * 0.5
                     for _ in range(n_stages)])
    stacked = {"w": w, "b": torch.zeros((n_stages, width), device=dev)}
    x = torch.randn((4, 2, width), generator=seeded(3), device=dev)
    y = torch.randn((4, 2, width), generator=seeded(4), device=dev)
    mesh = pl.make_pp_mesh(n_stages, device_type=dev)
    loss = torch.zeros((1,), device=dev)
    if mesh is not None:
        params = {k: torch.nn.Parameter(distribute_tensor(v, mesh.torch_mesh, pl.stage_sharding(mesh),
                                                          src_data_rank=None))
                  for k, v in stacked.items()}
        opt = spmd.adam(params.values(), 1e-2)
        step = pl.pipeline_train_step(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                                      lambda o, t: ((o - t) ** 2).mean(), opt, mesh, n_micro=4)
        loss += step(params, x, y)
        if not math.isfinite(loss.item()):
            raise AssertionError(f"non-finite pipeline loss {loss.item()}")
    dist.broadcast(loss, 0)
    return f"dryrun_multigpu pipeline OK: {n_stages} stages, loss={loss.item():.4f}"


def rl_batch(n: int) -> dict:
    """Pass 8's batch, the reference's: 4 rows a rank, zero observations,
    actions and behavior logp, unit advantages and returns."""
    import torch

    B = 4 * n
    return {"obs": torch.zeros((B, 4)), "actions": torch.zeros((B,), dtype=torch.long),
            "logp": torch.zeros((B,)), "advantages": torch.ones((B,)), "returns": torch.ones((B,))}


def rllib_dp_update(rank: int, n: int, dev: str, weights=None, batch=None):
    """Pass 8 on ``rank`` of ``n``: the PPO loss (``PPOConfig(hidden=(32,
    32))``, CartPole's shapes) of this rank's block of ``batch`` (default
    :func:`rl_batch`) over a dp mesh of every rank, its gradients summed
    over dp and divided by n, one Adam(3e-4) step (the reference's pass
    takes no clip).  The module starts from ``weights`` (a state dict) or
    from seed 11 on every rank.  Returns (the whole batch's loss, the
    updated weights on the CPU), the same on every rank."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.catalog import get_module_config
    from ray_tpu_torch.parallel import mesh as mesh_mod
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.rllib import core
    from ray_tpu_torch.rllib.ppo import PPOConfig, ppo_loss

    cfg = PPOConfig(hidden=(32, 32), learner_device=dev)
    mc = get_module_config((4,), 2, {"hidden": (32, 32)})
    module = core.module_init(mc, torch.Generator().manual_seed(11), dev)
    if weights is not None:
        module.load_state_dict(weights)
    opt = spmd.adam(module.parameters(), 3e-4)
    mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(dp=n), device_type=dev)
    local = {k: v.to_local() for k, v in spmd.shard_batch(mesh, batch or rl_batch(n)).items()}
    loss, _ = ppo_loss(module, local, cfg)
    loss.backward()
    group = mesh.group("dp")
    for p in module.parameters():
        dist.all_reduce(p.grad, group=group)
        p.grad /= n
    opt.step()
    loss = loss.detach().reshape(1)
    dist.all_reduce(loss, group=group)
    mesh_mod.set_current_mesh(None)
    return loss.item() / n, core.state_dict_cpu(module)


def _dryrun_rank(rank: int, n: int, device_type: str) -> List[str]:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2, llama, vit
    from ray_tpu_torch.parallel import mesh as mesh_mod
    from ray_tpu_torch.parallel import spmd

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dev = device_type
    lines = []

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # 1: ring attention over sp, with fsdp, tp and dp.
    config = gpt2.GPTConfig.tiny(attention_impl="ring")
    mc = _mesh_config(n)
    mesh = mesh_mod.make_mesh(mc, device_type=dev)
    tokens = torch.zeros((_batch_size(mc), config.max_seq_len), dtype=torch.long)
    loss = _train_once(mesh, lambda: gpt2.init(config, seeded(0), dev), gpt2.param_logical_axes(config),
                       gpt2.loss_fn, {"inputs": tokens, "targets": tokens}, shard_seq=True)
    lines.append(f"dryrun_multigpu OK: mesh={mc.describe()} over {n} ranks, 1 train step, "
                 f"loss={loss:.4f}")

    # 2: expert parallelism.
    mc_ep = _mesh_config_ep(n)
    if mc_ep is not None:
        mesh = mesh_mod.make_mesh(mc_ep, device_type=dev)
        cfg = gpt2.GPTConfig.tiny(num_experts=max(2, mc_ep.ep))
        toks = torch.zeros((_batch_size(mc_ep), 64), dtype=torch.long)
        loss = _train_once(mesh, lambda: gpt2.init(cfg, seeded(1), dev), gpt2.param_logical_axes(cfg),
                           gpt2.loss_fn, {"inputs": toks, "targets": toks})
        lines.append(f"dryrun_multigpu MoE OK: mesh={mc_ep.describe()}, experts={cfg.num_experts}, "
                     f"loss={loss:.4f}")

    # 3: pipeline parallelism: GPipe over a pp mesh, the stacked stage
    # parameters split over pp (stage_sharding).
    if n >= 2:
        lines.append(_gpipe_pass(n, dev, seeded))

    # 4: GPT-2 cut into pipeline stages on the six-axis mesh, with dp and tp.
    if n >= 8 and n % 4 == 0:
        from ray_tpu_torch.models import pp

        mc_pp = mesh_mod.MeshConfig(dp=-1, pp=2, tp=2).resolve(n)
        mesh = mesh_mod.make_mesh(mc_pp, device_type=dev)
        cfg = gpt2.GPTConfig.tiny()  # 2 layers -> 2 stages
        part = pp.gpt2_partition(cfg)
        logical = part.param_logical_axes()
        params = pp.shard_pp_params(mesh, part.to_pp(gpt2.init(cfg, seeded(5), dev), 2), logical)
        opt = spmd.adam(params.parameters(), 1e-3)
        step = pp.gpt2_pp_train_step(cfg, mesh, opt, n_micro=4)
        toks = torch.zeros((4, max(2, mc_pp.dp), 33), dtype=torch.long, device=dev)
        loss = step(params, toks[..., :-1], toks[..., 1:]).item()
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite pipeline loss {loss}")
        stage = params["stages"][0]
        _check_layout(mesh, stage, pp.stage_logical_axes(logical, len(stage)), opt)
        _check_layout(mesh, params["tail"], pp.tail_logical_axes(logical), opt)
        lines.append(f"dryrun_multigpu gpt2-pp OK: mesh={mc_pp.describe()}, loss={loss:.4f}")
        mesh_mod.set_current_mesh(None)

    # 5: a multi-slice mesh: data parallelism over dcn, tp inside a slice.
    if n >= 8 and n % 2 == 0:
        per_slice = n // 2
        mc_ms = mesh_mod.MeshConfig(dp=-1, tp=2 if per_slice % 2 == 0 else 1)
        mesh = mesh_mod.make_multislice_mesh(2, mc_ms, device_type=dev)
        cfg = gpt2.GPTConfig.tiny()
        loss = _train_once(mesh, lambda: gpt2.init(cfg, seeded(6), dev), gpt2.param_logical_axes(cfg),
                           gpt2.loss_fn, {"tokens": torch.zeros((8, 33), dtype=torch.long)})
        lines.append(f"dryrun_multigpu multislice OK: dcn=2 x ici[{mc_ms.resolve(per_slice).describe()}], "
                     f"loss={loss:.4f}")

    # 6: the serving path, tp-sharded Llama: a cached prefill and two
    # row-wise decode steps.
    if n >= 4:
        mc_dec = mesh_mod.MeshConfig(dp=-1, tp=2).resolve(n)
        mesh = mesh_mod.make_mesh(mc_dec, device_type=dev)
        cfg = llama.LlamaConfig.tiny()
        model = spmd.shard_module(llama.init(cfg, seeded(7), dev), mesh, llama.param_logical_axes(cfg))
        _check_layout(mesh, model, llama.param_logical_axes(cfg))
        B, S0, total = 2, 5, 12
        cache = llama.init_cache(cfg, B, total, dev, mesh=mesh)
        logits, cache = llama.forward_cached(model, torch.zeros((B, S0), dtype=torch.long, device=dev),
                                             cache, 0)
        nxt = logits.argmax(dim=-1)
        pos = [S0] * B
        for _ in range(2):
            logits, cache = llama.decode_step_rowwise(model, nxt, cache, pos)
            nxt = logits.argmax(dim=-1)
            pos = [p + 1 for p in pos]
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite decode logits")
        lines.append(f"dryrun_multigpu decode OK: mesh={mc_dec.describe()}, "
                     f"tp-sharded prefill + 2 rowwise decode steps")
    mesh_mod.set_current_mesh(None)

    # 7: ViT over fsdp x tp.
    if n >= 4 and n % 4 == 0:
        cfg = vit.ViTConfig.tiny()
        mc_v = mesh_mod.MeshConfig(dp=-1, fsdp=2, tp=2).resolve(n)
        mesh = mesh_mod.make_mesh(mc_v, device_type=dev)
        bsz = _batch_size(mc_v)
        batch = {"images": torch.zeros((bsz, cfg.image_size, cfg.image_size, 3)),
                 "labels": torch.zeros((bsz,), dtype=torch.long)}
        loss = _train_once(mesh, lambda: vit.init(cfg, seeded(8), dev), vit.param_logical_axes(cfg),
                           vit.loss_fn, batch)
        lines.append(f"dryrun_multigpu vit OK: mesh={mc_v.describe()}, loss={loss:.4f}")
    mesh_mod.set_current_mesh(None)

    # 8: RLlib, the PPO learner's update dp-sharded over every rank; the
    # parameters' sum of squares shows every replica took the same step.
    if n >= 2:
        loss, weights = rllib_dp_update(rank, n, dev)
        sq = sum(float(w.double().square().sum()) for w in weights.values())
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite PPO loss {loss}")
        lines.append(f"dryrun_multigpu rllib OK: PPO learner update dp-sharded over {n} ranks, "
                     f"loss={loss:.4f}, sum of squared params {sq:.6f}")

    # 9: the gang itself, a cross-process sum over every rank.
    x = torch.full((1,), rank + 1.0, device=dev)
    dist.all_reduce(x)
    if x.item() != n * (n + 1) / 2:
        raise AssertionError(f"cross-process sum {x.item()}, expected {n * (n + 1) / 2}")
    lines.append(f"dryrun_multigpu distributed OK: {n}-process {dist.get_backend()} gang, "
                 f"cross-process sum correct ({x.item():.0f})")
    return lines


def dryrun_multigpu(n: int, device_type: str = "cuda") -> List[str]:
    """Run the dry run on ``n`` ranks and print each pass's ``OK`` line;
    returns the lines.  Every rank must print the same ones (the same
    losses): a rank that differs, fails or outlasts 900 s raises.  The
    ranks hold a card each unless the caller asks for ``"cpu"``."""
    from ray_tpu_torch.parallel.launch import run_ranks

    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type is 'cuda' or 'cpu', not {device_type!r}")
    if device_type == "cuda":
        import torch

        if torch.cuda.device_count() < n:
            raise RuntimeError(f"dryrun_multigpu({n}, 'cuda') needs {n} cards, "
                               f"{torch.cuda.device_count()} are visible")
    per_rank = run_ranks(_dryrun_rank, n, n, device_type,
                         backend="nccl" if device_type == "cuda" else "gloo", timeout=900.0)
    for rank, lines in enumerate(per_rank):
        if lines != per_rank[0]:
            raise AssertionError(f"rank {rank} saw {lines}, rank 0 {per_rank[0]}")
    for line in per_rank[0]:
        print(line, flush=True)
    return per_rank[0]


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8)")
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the CPU instead of one card a rank")
    args = parser.parse_args()
    dryrun_multigpu(args.n, device_type="cpu" if args.cpu else "cuda")
