"""The port's attention ops (ray_tpu_torch.ops) against the JAX package.

Inputs come from a numpy seed and go through both.  On the CPU the JAX side
runs its Pallas kernel in interpret mode, and the port's wrapper runs the
kernel's plain version (the CUDA kernel itself is checked on the card by
chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu.ops.attention import dense_attention as jax_dense
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops.attention import dense_attention

# f32 on both sides, the tolerance of tests/test_flash_attention.py.
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


class TestFlashForward:
    # 128: one block; 384: three 128-wide blocks, so the reference's
    # online-softmax merge runs.
    @pytest.mark.parametrize("S", [128, 384])
    def test_matches_jax_fwd(self, S):
        q, k, v = _qkv((1, 2, S, 64), seed=S)
        scale = 1.0 / math.sqrt(64)
        o_j, lse_j = jfa._fwd(q, k, v, scale)
        o_t, lse_t = tfa.flash_attention_fwd(*_t(q, k, v))
        assert o_t.dtype == torch.float32 and lse_t.shape == (1, 2, S)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32_TOL)
        np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32_TOL)

    def test_causality(self):
        """Changing future keys/values must not change earlier outputs."""
        q, k, v = _t(*_qkv((1, 2, 128, 64), seed=7))
        o1, lse1 = tfa.flash_attention_fwd(q, k, v)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, 64:] = 0.0
        v2[:, :, 64:] = 9.0
        o2, lse2 = tfa.flash_attention_fwd(q, k2, v2)
        torch.testing.assert_close(o1[:, :, :64], o2[:, :, :64], atol=1e-6, rtol=0)
        torch.testing.assert_close(lse1[:, :, :64], lse2[:, :, :64], atol=1e-6, rtol=0)
        assert not torch.allclose(o1[:, :, 64:], o2[:, :, 64:])

    def test_seq_len_must_divide_128(self):
        q, k, v = _t(*_qkv((1, 2, 100, 64), seed=1))
        with pytest.raises(ValueError, match="divisible by 128"):
            tfa.flash_attention_fwd(q, k, v)
        with pytest.raises(ValueError, match="divisible by 128"):
            jfa._block_sizes(100)

    def test_forward_only(self):
        q, k, v = _t(*_qkv((1, 2, 128, 64), seed=2))
        with pytest.raises(NotImplementedError, match="forward-only"):
            tfa.flash_attention_bhsd(q.requires_grad_(), k, v)

    def test_bshd_adapter_reads_strided_views(self):
        """(B, S, H, D) in, through transposed views, equals the dense path;
        the scale argument reaches the softmax."""
        q, k, v = _t(*_qkv((2, 256, 3, 64), seed=4))
        o = tfa.flash_attention(q, k, v)
        assert o.shape == (2, 256, 3, 64)
        torch.testing.assert_close(o, dense_attention(q, k, v), **F32_TOL)
        o_half = tfa.flash_attention(q, k, v, scale=0.5 / math.sqrt(64))
        torch.testing.assert_close(o_half, dense_attention(q * 0.5, k, v), **F32_TOL)


class TestDenseAttention:
    @pytest.mark.parametrize("start_pos,window", [(0, 0), (0, 5), (3, 0), (3, 5)])
    def test_matches_jax(self, start_pos, window):
        rng = np.random.default_rng(start_pos * 10 + window)
        q = rng.standard_normal((2, 13 - start_pos, 4, 16)).astype(np.float32)
        k, v = [rng.standard_normal((2, 13, 4, 16)).astype(np.float32) for _ in range(2)]
        ref = jax_dense(q, k, v, start_pos=start_pos, window=window)
        out = dense_attention(*_t(q, k, v), start_pos=start_pos, window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)

    def test_bf16_matches_jax(self):
        """bf16 inputs, f32 softmax, probs cast to bf16 before the product
        with v.  Both sides round the same f32 values to bf16 at the cast and
        the output, so they may differ by a bf16 ulp (2^-8 relative) there:
        atol/rtol 1e-2."""
        q, k, v = _qkv((2, 64, 4, 16), seed=5)
        bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
        ref = np.asarray(jax_dense(*bf).astype(jnp.float32))
        out = dense_attention(*[torch.from_numpy(a).bfloat16() for a in (q, k, v)])
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=1e-2)
