"""HuggingFace Transformers weights into the port's models (port of
``ray_tpu/models/hf.py``).

Each function takes a ``transformers`` model instance (a loaded checkpoint
or a config-built model) and reads only its ``.config`` and
``.state_dict()``; this module never imports ``transformers``.  The weights
are laid out as the reference's stacked pytree and copied into the port's
module by ``models/convert.py``.

Layout notes:
- GPT-2: HF Conv1D stores (in, out), as the einsum kernels do, so only the
  qkv head split reshapes: c_attn is (E, 3E) = [q|k|v] and becomes
  (E, 3H, D).  The vocab pads with zero rows to a multiple of
  ``pad_vocab_to``.
- Llama: HF Linear stores (out, in), so every projection transposes, and
  q, k and o reshape their flat head dim into (heads, head_dim).  HF
  checkpoints use the rotate-half RoPE convention the model implements, so
  no head permutation is needed.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.models.convert import gpt2_params_from_jax, llama_params_from_jax
from ray_tpu_torch.models.gpt2 import GPT2, GPTConfig
from ray_tpu_torch.models.llama import Llama, LlamaConfig


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _state(model) -> Dict[str, np.ndarray]:
    """The state dict as f32 numpy arrays (bf16 has no numpy dtype)."""
    return {k: v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}


def _stacker(sd, num_layers: int):
    def stacked(fmt: str) -> np.ndarray:
        return np.stack([sd[fmt.format(i=i)] for i in range(num_layers)], axis=0)
    return stacked


def config_from_hf(hf_config, *, pad_vocab_to: int = 128, **overrides) -> GPTConfig:
    """Map a transformers GPT2Config onto GPTConfig."""
    kwargs: Dict[str, Any] = dict(
        vocab_size=_round_up(hf_config.vocab_size, pad_vocab_to),
        max_seq_len=hf_config.n_positions,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        embed_dim=hf_config.n_embd,
        dtype=torch.bfloat16,
    )
    kwargs.update(overrides)
    return GPTConfig(**kwargs)


def params_from_hf(model, *, pad_vocab_to: int = 128, device="cuda",
                   **config_overrides) -> GPT2:
    """A :class:`GPT2` on ``device`` holding a transformers GPT2LMHeadModel's
    weights (its config at ``.config``)."""
    config = config_from_hf(model.config, pad_vocab_to=pad_vocab_to, **config_overrides)
    sd = _state(model)
    L, E, H, D = config.num_layers, config.embed_dim, config.num_heads, config.head_dim
    stacked = _stacker(sd, L)
    wte = sd["transformer.wte.weight"]
    wte = np.concatenate([wte, np.zeros((config.vocab_size - wte.shape[0], E), wte.dtype)])
    tree = {
        "wte": wte,
        "wpe": sd["transformer.wpe.weight"],
        "blocks": {
            "ln1_scale": stacked("transformer.h.{i}.ln_1.weight"),
            "ln1_bias": stacked("transformer.h.{i}.ln_1.bias"),
            # (L, E, 3E) -> (L, E, 3, H, D) -> (L, E, 3H, D)
            "qkv_kernel": stacked("transformer.h.{i}.attn.c_attn.weight").reshape(L, E, 3 * H, D),
            "qkv_bias": stacked("transformer.h.{i}.attn.c_attn.bias").reshape(L, 3 * H, D),
            "proj_kernel": stacked("transformer.h.{i}.attn.c_proj.weight").reshape(L, H, D, E),
            "proj_bias": stacked("transformer.h.{i}.attn.c_proj.bias"),
            "ln2_scale": stacked("transformer.h.{i}.ln_2.weight"),
            "ln2_bias": stacked("transformer.h.{i}.ln_2.bias"),
            "fc_kernel": stacked("transformer.h.{i}.mlp.c_fc.weight"),
            "fc_bias": stacked("transformer.h.{i}.mlp.c_fc.bias"),
            "out_kernel": stacked("transformer.h.{i}.mlp.c_proj.weight"),
            "out_bias": stacked("transformer.h.{i}.mlp.c_proj.bias"),
        },
        "lnf_scale": sd["transformer.ln_f.weight"],
        "lnf_bias": sd["transformer.ln_f.bias"],
    }
    return gpt2_params_from_jax(tree, config, device)


def llama_config_from_hf(hf_config, **overrides) -> LlamaConfig:
    """Map a transformers LlamaConfig onto LlamaConfig."""
    kwargs: Dict[str, Any] = dict(
        vocab_size=hf_config.vocab_size,
        max_seq_len=hf_config.max_position_embeddings,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        embed_dim=hf_config.hidden_size,
        mlp_dim=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rms_eps=hf_config.rms_norm_eps,
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        dtype=torch.bfloat16,
    )
    kwargs.update(overrides)
    return LlamaConfig(**kwargs)


def llama_params_from_hf(model, device="cuda", **config_overrides) -> Llama:
    """A :class:`Llama` on ``device`` holding a transformers
    LlamaForCausalLM's weights (its config at ``.config``)."""
    config = llama_config_from_hf(model.config, **config_overrides)
    sd = _state(model)
    L, E, H, KV, D = (config.num_layers, config.embed_dim, config.num_heads,
                      config.num_kv_heads, config.head_dim)
    stacked = _stacker(sd, L)

    def linear(name: str) -> np.ndarray:
        """(L, out, in) HF Linear weights as (L, in, out)."""
        return stacked(f"model.layers.{{i}}.{name}.weight").transpose(0, 2, 1)

    tree = {
        "tok_embed": sd["model.embed_tokens.weight"],
        "blocks": {
            "attn_norm": stacked("model.layers.{i}.input_layernorm.weight"),
            "wq": linear("self_attn.q_proj").reshape(L, E, H, D),
            "wk": linear("self_attn.k_proj").reshape(L, E, KV, D),
            "wv": linear("self_attn.v_proj").reshape(L, E, KV, D),
            "wo": linear("self_attn.o_proj").reshape(L, H, D, E),
            "mlp_norm": stacked("model.layers.{i}.post_attention_layernorm.weight"),
            "w_gate": linear("mlp.gate_proj"),
            "w_up": linear("mlp.up_proj"),
            "w_down": linear("mlp.down_proj"),
        },
        "final_norm": sd["model.norm.weight"],
    }
    if not config.tie_embeddings:
        tree["lm_head"] = sd["lm_head.weight"]
    return llama_params_from_jax(tree, config, device)
