"""Forward entry point on the flagship model (port of ``__graft_entry__.entry``)."""

from __future__ import annotations

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models import gpt2


def entry(device="cuda", attention_impl: str = "dense"):
    """(fn, example_args): a forward step on GPT-2 124M with random weights
    from seed 0 and zero tokens of shape (4, 512).  ``fn(model, tokens)``
    returns f32 logits (4, 512, 50304)."""
    device = resolve_device(device)
    config = gpt2.GPTConfig.gpt2_124m(attention_impl=attention_impl)
    model = gpt2.init(
        config, torch.Generator(device=device).manual_seed(0), device
    )
    tokens = torch.zeros((4, 512), dtype=torch.int64, device=device)

    def fwd(model, tokens):
        with torch.inference_mode():
            return model(tokens)

    return fwd, (model, tokens)
