"""RLModule: the policy/value network on PyTorch (port of
``ray_tpu/rllib/core.py``).

The reference keeps a module functional (a params pytree in, ``(logits,
value)`` out) so that one function serves CPU inference in the env runners
and jitted training in the learner.  Here a module family is an
``nn.Module`` whose ``forward(obs)`` returns ``(logits (B, A), value
(B,))``; the same module class runs in a runner on the CPU and in a
learner on the card.  Parameters keep the reference's names (``layers.i.w``
/ ``b`` of shape (din, dout) / (dout,), ``pi.w``/``b``, ``vf.w``/``b``), so
converting a reference pytree is a rename (``models/convert.py``).

Initialisation draws from a ``torch.Generator`` (on the CPU unless the
caller passes one on another device) with the reference's distributions
and then moves the module to ``device``, so a seed gives the same weights
on the CPU and on the card; it cannot reproduce ``jax.random``'s stream.
Sampling likewise draws from a caller's generator: sampled actions repeat
for a given seed, not across the two packages (greedy readouts do).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPModuleConfig:
    obs_dim: int
    num_actions: int
    hidden: Tuple[int, ...] = (64, 64)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` of shape (din, dout), the reference's layout."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((din, dout)))
        self.b = nn.Parameter(torch.zeros((dout,)))

    def forward(self, x):
        return x @ self.w + self.b


def dense_layers(din: int, hidden: Tuple[int, ...]) -> nn.ModuleList:
    layers = nn.ModuleList()
    for dout in hidden:
        layers.append(Dense(din, dout))
        din = dout
    return layers


def heads(module: nn.Module, x):
    """The shared trunk end: tanh layers, then the policy and value heads."""
    for layer in module.layers:
        x = torch.tanh(layer(x))
    return module.pi(x), module.vf(x)[..., 0]


class MLPModule(nn.Module):
    def __init__(self, config: MLPModuleConfig):
        super().__init__()
        self.layers = dense_layers(config.obs_dim, config.hidden)
        last = config.hidden[-1] if config.hidden else config.obs_dim
        self.pi = Dense(last, config.num_actions)
        self.vf = Dense(last, 1)

    def forward(self, obs):
        """obs (B, obs_dim) -> (logits (B, A), value (B,))."""
        return heads(self, obs)


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or a CPU generator seeded 0 when None."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def init_heads(module: nn.Module, g: torch.Generator) -> None:
    """He-normal dense layers, zero biases; the policy head at 0.01 and the
    value head at 1.0 of a unit normal (the reference's ``init``)."""
    with torch.no_grad():
        for layer in module.layers:
            layer.w.normal_(generator=g).mul_(math.sqrt(2.0 / layer.w.shape[0]))
        module.pi.w.normal_(generator=g).mul_(0.01)
        module.vf.w.normal_(generator=g)


def init(config: MLPModuleConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> MLPModule:
    """An :class:`MLPModule` on ``device`` with weights drawn from
    ``generator`` (a CPU generator seeded 0 when None)."""
    dev = resolve_device(device)
    g = default_generator(generator)
    module = MLPModule(config).to(g.device)
    init_heads(module, g)
    return module.to(dev)


def sample_actions(module: nn.Module, obs, generator: torch.Generator):
    """Categorical sample, its logp and the value (env-runner inference)."""
    logits, value = module(obs)
    logp_all = F.log_softmax(logits, dim=-1)
    action = torch.multinomial(logp_all.exp(), 1, generator=generator)[:, 0]
    logp = logp_all.gather(1, action[:, None])[:, 0]
    return action, logp, value


def sample_actions_epsilon(module: nn.Module, obs, generator: torch.Generator, epsilon: float):
    """ε-greedy over the logits head read as Q-values (DQN).

    Same module, another readout: the "pi" head is the Q function and the
    value slot carries max-Q.  The returned logp is 0: off-policy methods
    do not use it."""
    q, _ = module(obs)
    B, A = q.shape
    explore = torch.rand((B,), generator=generator, device=q.device) < epsilon
    rand = torch.randint(0, A, (B,), generator=generator, device=q.device)
    action = torch.where(explore, rand, q.argmax(dim=-1))
    return action, torch.zeros((B,), device=q.device), q.max(dim=-1).values


# ---------------------------------------------------------------------------
# Module families (catalog dispatch)
# ---------------------------------------------------------------------------

# config type -> init_fn(config, generator, device) -> nn.Module; the
# catalog's CNN family registers itself here (models/catalog.py).
MODULE_FAMILIES: Dict[type, Callable] = {}


def register_module_family(config_cls, init_fn) -> None:
    """Plug a new module family (CNN, ...) into the shared init dispatch
    (ray: rllib/models/catalog.py role).  The reference registers an init
    and a forward; here the module's own ``forward`` is the forward."""
    MODULE_FAMILIES[config_cls] = init_fn


def module_init(config, generator: Optional[torch.Generator] = None, device="cuda") -> nn.Module:
    """Family-dispatching init (falls back to the builtin MLP)."""
    return MODULE_FAMILIES.get(type(config), init)(config, generator, device)


def state_dict_cpu(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters as detached CPU copies: what crosses a
    process (the store's tensor reducer, ``broadcast_tree``) or a
    checkpoint."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}
