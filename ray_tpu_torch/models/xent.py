"""Chunked cross-entropy for LM heads, forward value (port of
``ray_tpu/models/xent.py``).

The lm_head product and logsumexp run one sequence chunk at a time, so only
one chunk's (B, C, V) f32 logits is alive at once.  The reference also
recomputes each chunk in its backward pass; the port has no backward yet.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.models.common import matmul_f32


def chunked_xent(x, head_weight, targets, mask, chunk: int, dtype):
    """Mean negative log-likelihood with a chunked head.

    x: (B, S, E) features; head_weight: (V, E); targets: (B, S) int;
    mask: optional (B, S); chunk must divide S.
    """
    S = targets.shape[1]
    w = head_weight.to(dtype).t()
    ll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        logits = matmul_f32(x[:, c0:c0 + chunk], w)  # (B, C, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        tc = targets[:, c0:c0 + chunk]
        ll = torch.gather(logits, -1, tc[..., None].long())[..., 0] - lse
        if mask is None:
            ll_sum = ll_sum + ll.sum()
            m_sum = m_sum + ll.numel()
        else:
            mc = mask[:, c0:c0 + chunk].float()
            ll_sum = ll_sum + (ll * mc).sum()
            m_sum = m_sum + mc.sum()
    return -ll_sum / torch.clamp(m_sum, min=1.0)
