"""Weights from config-built tiny transformers models (no download) through
the port's ``models/hf.py`` against the reference's conversions, parameter
by parameter, and the converted Llama's logits against the transformers
model's own.

Marked slow: importing transformers' model classes takes 5-15 s on the CPU,
more than the port's tier-1 tests may spend.  Run with
``python -m pytest tests/test_zz_torch_hf.py -m slow``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref, np.float32), **tol)


class TestHF:

    @pytest.fixture(scope="class")
    def transformers(self):
        return pytest.importorskip("transformers")

    def _check(self, model, ref_params):
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] == "blocks":
                ref = np.asarray(ref_params["blocks"][parts[2]])[int(parts[1])]
            else:
                ref = np.asarray(ref_params[name])
            np.testing.assert_array_equal(p.detach().float().numpy(), ref.astype(np.float32),
                                          err_msg=name)

    def test_llama_params_from_hf(self, transformers):
        from ray_tpu.models.hf import llama_params_from_hf as jax_from_hf
        from ray_tpu_torch.models.hf import llama_params_from_hf

        torch.manual_seed(0)
        hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
            rms_norm_eps=1e-5, tie_word_embeddings=False, attention_dropout=0.0,
        )).eval()
        model = llama_params_from_hf(hf, device="cpu", dtype=torch.float32, remat=False)
        ref_params, ref_cfg = jax_from_hf(hf, dtype=jnp.float32, remat=False)
        assert (model.config.num_kv_heads, model.config.mlp_dim) == (ref_cfg.num_kv_heads, ref_cfg.mlp_dim)
        self._check(model, ref_params)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 13)))
        with torch.inference_mode():
            _close(model(tokens), hf(tokens).logits, dict(atol=2e-4, rtol=2e-4))

    def test_gpt2_params_from_hf(self, transformers):
        from ray_tpu.models.hf import params_from_hf as jax_from_hf
        from ray_tpu_torch.models.hf import params_from_hf

        torch.manual_seed(0)
        hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=200, n_positions=32, n_embd=32, n_layer=2, n_head=4,
        )).eval()
        model = params_from_hf(hf, device="cpu", dtype=torch.float32)
        ref_params, ref_cfg = jax_from_hf(hf, dtype=jnp.float32)
        assert model.config.vocab_size == ref_cfg.vocab_size == 256
        self._check(model, ref_params)
