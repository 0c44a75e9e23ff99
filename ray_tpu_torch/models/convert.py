"""Weights from the reference package into the port's GPT-2.

The reference keeps GPT-2's parameters as a pytree: ``wte`` (V, E), ``wpe``
(S, E), ``lnf_scale``/``lnf_bias`` (E,) and ``blocks``, whose every leaf is
stacked over layers with a leading L.  The port's modules keep the same
per-layer shapes, so layer i of each leaf is copied as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.gpt2 import GPT2, GPTConfig

_TOP = ("wte", "wpe", "lnf_scale", "lnf_bias")


def gpt2_params_from_jax(np_params, config: GPTConfig, device="cuda") -> GPT2:
    """A :class:`GPT2` on ``device`` holding ``np_params``: the reference's
    pytree of arrays, each convertible by ``np.asarray`` (numpy arrays, or
    JAX arrays fetched to the host)."""
    model = GPT2(config, device)

    def copy(dst: torch.Tensor, src, name: str):
        arr = np.array(src, dtype=np.float32)  # a writable copy
        if arr.shape != tuple(dst.shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))

    blocks = np_params["blocks"]
    expected = {n for n, _ in model.blocks[0].named_parameters()}
    if set(blocks) != expected:
        raise ValueError(
            f"block params {sorted(blocks)} do not match the port's {sorted(expected)}"
        )
    with torch.no_grad():
        for name in _TOP:
            copy(getattr(model, name), np_params[name], name)
        for name, stacked in blocks.items():
            stacked = np.asarray(stacked, dtype=np.float32)
            if stacked.shape[0] != config.num_layers:
                raise ValueError(
                    f"blocks.{name}: {stacked.shape[0]} layers, expected {config.num_layers}"
                )
            for i, blk in enumerate(model.blocks):
                copy(getattr(blk, name), stacked[i], f"blocks.{name}[{i}]")
    return model
