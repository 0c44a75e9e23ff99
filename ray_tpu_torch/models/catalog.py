"""RLlib model catalog: obs space -> module family (port of
``ray_tpu/models/catalog.py``).

Role-equivalent of ray: rllib/models/catalog.py (ModelCatalog) +
rllib/models/torch/visionnet.py: the CNN family for image observations and
the dispatch that picks MLP or CNN from the observation's shape.

Modules take FLAT observations (B, prod(obs_shape)) and reshape them with
the static config, so rollout fragments stay flat through buffers and
minibatches.  The reference runs its convolutions NHWC with HWIO kernels
and flattens the last one's NHWC output; here the convolutions are
``F.conv2d`` (NCHW, OIHW kernels, VALID padding, the configured strides),
so the observation is reshaped to NHWC, permuted to NCHW for the
convolutions and permuted back to NHWC before the flatten: the first dense
layer then sees its rows in the reference's order, and a converted weight
matrix means the same thing in both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib import core


@dataclasses.dataclass(frozen=True)
class CNNModuleConfig:
    obs_shape: Tuple[int, int, int]  # (H, W, C)
    num_actions: int
    # (out_channels, kernel, stride) per conv layer (reference default
    # vision-net filters, scaled down)
    conv_filters: Tuple[Tuple[int, int, int], ...] = (
        (16, 8, 4),
        (32, 4, 2),
    )
    hidden: Tuple[int, ...] = (256,)


def _conv_out_hw(h: int, w: int,
                 filters: Tuple[Tuple[int, int, int], ...]) -> Tuple[int, int]:
    for _, k, s in filters:
        h = (h - k) // s + 1
        w = (w - k) // s + 1
    return h, w


class Conv(nn.Module):
    """A VALID convolution: ``w`` (cout, cin, k, k) (OIHW), ``b`` (cout,)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.stride = stride
        self.w = nn.Parameter(torch.zeros((cout, cin, k, k)))
        self.b = nn.Parameter(torch.zeros((cout,)))

    def forward(self, x):
        return F.conv2d(x, self.w, self.b, stride=self.stride)


class CNNModule(nn.Module):
    def __init__(self, config: CNNModuleConfig):
        super().__init__()
        self.config = config
        H, W, C = config.obs_shape
        self.conv = nn.ModuleList()
        cin = C
        for cout, k, s in config.conv_filters:
            self.conv.append(Conv(cin, cout, k, s))
            cin = cout
        oh, ow = _conv_out_hw(H, W, config.conv_filters)
        self.layers = core.dense_layers(oh * ow * cin, config.hidden)
        last = config.hidden[-1] if config.hidden else oh * ow * cin
        self.pi = core.Dense(last, config.num_actions)
        self.vf = core.Dense(last, 1)

    def forward(self, obs):
        H, W, C = self.config.obs_shape
        # the observation in the parameters' dtype (f32, as the reference casts it)
        x = obs.reshape((-1, H, W, C)).to(self.pi.w.dtype).permute(0, 3, 1, 2)
        for conv in self.conv:
            x = F.relu(conv(x))
        # back to NHWC before the flatten: the reference's row order
        x = x.permute(0, 2, 3, 1).reshape((x.shape[0], -1))
        return core.heads(self, x)


def cnn_init(cfg: CNNModuleConfig, generator: Optional[torch.Generator] = None,
             device="cuda") -> CNNModule:
    """He-normal convolutions and dense layers (fan-in k·k·cin for a
    convolution), zero biases, the reference's head scales."""
    dev = resolve_device(device)
    g = core.default_generator(generator)
    module = CNNModule(cfg).to(g.device)
    with torch.no_grad():
        for conv in module.conv:
            cout, cin, k, _ = conv.w.shape
            conv.w.normal_(generator=g).mul_(math.sqrt(2.0 / (k * k * cin)))
    core.init_heads(module, g)
    return module.to(dev)


core.register_module_family(CNNModuleConfig, cnn_init)


def get_module_config(obs_shape, num_actions: int, model_config=None):
    """Pick a module family from the obs shape (ray: ModelCatalog
    get_model_v2 dispatch): rank-3 obs -> CNN, else MLP."""
    model_config = model_config or {}
    if len(obs_shape) == 3:
        return CNNModuleConfig(
            obs_shape=tuple(obs_shape),
            num_actions=num_actions,
            conv_filters=tuple(
                tuple(f) for f in model_config.get(
                    "conv_filters", ((16, 8, 4), (32, 4, 2))
                )
            ),
            hidden=tuple(model_config.get("hidden", (256,))),
        )
    return core.MLPModuleConfig(
        obs_dim=int(np.prod(obs_shape)),
        num_actions=num_actions,
        hidden=tuple(model_config.get("hidden", (64, 64))),
    )
