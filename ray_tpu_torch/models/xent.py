"""Chunked cross-entropy for LM heads (port of ``ray_tpu/models/xent.py``).

The lm_head product and logsumexp run one sequence chunk at a time, so only
one chunk's (B, C, V) f32 logits is alive at once.  As the reference does
with ``jax.checkpoint``, each chunk runs under ``torch.utils.checkpoint``
when gradients are taken: its logits are recomputed in the backward pass
instead of living through the whole step.

For a model sharded over a mesh the features are this rank's block of the
batch (and of the sequence, over sp); the loss is the mean over the whole
batch, its sums and counts summed over those axes, on every rank.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.common import matmul_f32
from ray_tpu_torch.parallel.collectives import allreduce_mean, allreduce_sum
from ray_tpu_torch.parallel.mesh import SP_AXIS
from ray_tpu_torch.parallel.spmd import mesh_of


def _chunk_ll(xc, w, tc):
    """Per-token log-likelihood (B, C) of one chunk: target logit − lse."""
    logits = matmul_f32(xc, w)  # (B, C, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    return torch.gather(logits, -1, tc[..., None].long())[..., 0] - lse


def chunked_xent(x, head_weight, targets, mask, chunk: int, dtype, total=lambda t: t):
    """Mean negative log-likelihood with a chunked head.

    x: (B, S, E) features; head_weight: (V, E); targets: (B, S) int;
    mask: optional (B, S); chunk must divide S.  ``total`` sums a local
    sum over the ranks that hold the rest of the batch.
    """
    S = targets.shape[1]
    w = head_weight.to(dtype).t()
    ll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        args = (x[:, c0:c0 + chunk], w, targets[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            ll = checkpoint(_chunk_ll, *args, use_reentrant=False)
        else:
            ll = _chunk_ll(*args)
        if mask is None:
            ll_sum = ll_sum + ll.sum()
            m_sum = m_sum + ll.numel()
        else:
            mc = mask[:, c0:c0 + chunk].float()
            ll_sum = ll_sum + (ll * mc).sum()
            m_sum = m_sum + mc.sum()
    return -total(ll_sum) / torch.clamp(total(m_sum), min=1.0)


def split_batch(batch):
    """(inputs, targets, mask) of a language-model batch: {"tokens": (B,
    S+1)} or {"inputs", "targets"} each (B, S), with an optional (B, S)
    "mask" (None without one)."""
    if "tokens" in batch:
        inputs = batch["tokens"][:, :-1]
        targets = batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    return inputs, targets, batch.get("mask")


def head_loss(model, x, targets, mask):
    """Mean next-token negative log-likelihood of features ``x`` (B, S, E)
    through ``model``'s head (``head`` and ``head_weight``); with
    config.xent_chunk set (and S divisible by it) the head and softmax run
    per sequence chunk."""
    c = model.config
    mesh = mesh_of(model)
    data = (*mesh.data_axes, SP_AXIS)

    def total(t):
        return allreduce_sum(t, data, mesh=mesh)

    if c.xent_chunk and targets.shape[1] % c.xent_chunk == 0:
        return chunked_xent(x, model.head_weight, targets, mask, c.xent_chunk, c.dtype, total)
    logits = model.head(x)
    # lse − target_logit in f32
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0] - lse
    if mask is None:
        # every rank holds as many tokens: the mean of the ranks' means
        return allreduce_mean(-ll.mean(), data, mesh=mesh)
    mask = mask.float()
    return -total((ll * mask).sum()) / torch.clamp(total(mask.sum()), min=1.0)


def next_token_loss(model, batch):
    """Next-token cross-entropy of a language model with ``features``,
    ``head`` and ``head_weight`` (GPT-2 and Llama); batch as
    :func:`split_batch` reads it."""
    inputs, targets, mask = split_batch(batch)
    return head_loss(model, model.features(inputs), targets, mask)
