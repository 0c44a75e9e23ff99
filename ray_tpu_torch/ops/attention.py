"""Dense causal attention (plain PyTorch).

The model's attention path when the sequence length does not suit the
flash kernel, and the oracle the kernel is checked against.  Port of
``ray_tpu/ops/attention.py`` ``dense_attention``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def dense_attention(q, k, v, *, start_pos: int = 0, window: int = 0):
    """Causal attention, f32 softmax.  q: (B, Sq, H, D); k, v: (B, Sk, H, D).

    ``start_pos`` offsets query positions (queries are a suffix of the key
    sequence).  ``window`` > 0 limits each query to the last ``window`` keys:
    position t attends to (t - window, t].  Scores are taken in f32 from the
    inputs as they are; the probabilities are cast to ``q.dtype`` before the
    product with ``v``, as the reference does.
    """
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + start_pos
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = q_pos >= k_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
