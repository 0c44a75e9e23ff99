"""The port's attention ops (ray_tpu_torch.ops) against the JAX package.

Inputs come from a numpy seed and go through both.  On the CPU the JAX side
runs its Pallas kernels in interpret mode, and the port's wrappers run the
kernels' plain versions (the CUDA kernels themselves are checked on the card
by chip_smoke.py).
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

    def test_bshd_adapter_reads_strided_views(self):
        """(B, S, H, D) in, through transposed views, equals the dense path;
        the scale argument reaches the softmax."""
        q, k, v = _t(*_qkv((2, 256, 3, 64), seed=4))
        o = tfa.flash_attention(q, k, v)
        assert o.shape == (2, 256, 3, 64)
        torch.testing.assert_close(o, dense_attention(q, k, v), **F32_TOL)
        o_half = tfa.flash_attention(q, k, v, scale=0.5 / math.sqrt(64))
        torch.testing.assert_close(o_half, dense_attention(q * 0.5, k, v), **F32_TOL)


class TestFlashBackward:
    @staticmethod
    def _jax_bwd(S, dtype, seed, D=64):
        """(q, k, v, o, lse, do) as numpy and the reference's (dq, dk, dv)
        from its forward and backward Pallas kernels in interpret mode."""
        q, k, v = _qkv((1, 2, S, D), seed=seed)
        do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
        jq, jk, jv, jdo = [jnp.asarray(a, dtype) for a in (q, k, v, do)]
        scale = 1.0 / math.sqrt(D)
        o, lse = jfa._fwd(jq, jk, jv, scale)
        grads = jfa._bwd(jq, jk, jv, o, lse, jdo, scale)
        as_np = lambda a: np.array(a.astype(jnp.float32))  # writable
        return [as_np(a) for a in (jq, jk, jv, o, lse, jdo)], [as_np(g) for g in grads]

    # 128: one block; 384: three 128-wide blocks, so the reference's dq is
    # summed over kv blocks and its dk, dv over q blocks.
    @pytest.mark.parametrize("S", [128, 384])
    def test_matches_jax_bwd(self, S):
        inputs, ref = self._jax_bwd(S, jnp.float32, seed=S)
        out = tfa.flash_attention_bwd(*_t(*inputs))
        for name, o_t, r in zip(("dq", "dk", "dv"), out, ref):
            assert o_t.dtype == torch.float32 and o_t.shape == (1, 2, S, 64), name
            np.testing.assert_allclose(o_t.numpy(), r, **F32_TOL, err_msg=name)

    # Both head widths the kernels take: GPT-2's 64, and 128, which the
    # bf16 kernels tile differently on the card.
    @pytest.mark.parametrize("D", [64, 128])
    def test_bf16_matches_jax_bwd(self, D):
        """bf16 at S=384.  The reference adds each of its three blocks'
        contributions into a bf16 output, rounding after each (2^-9 of a
        running sum that may exceed the final value); the port sums in f32
        and rounds once.  Both round p and ds to bf16 before their products,
        where a summation-order difference can flip a rounding.  Those few
        roundings stay within 2e-2 of the value plus 2e-2 (|grads| up to 4)."""
        inputs, ref = self._jax_bwd(384, jnp.bfloat16, seed=3, D=D)
        out = tfa.flash_attention_bwd(*[torch.from_numpy(a).to(
            torch.float32 if i == 4 else torch.bfloat16) for i, a in enumerate(inputs)])
        for name, o_t, r in zip(("dq", "dk", "dv"), out, ref):
            assert o_t.dtype == torch.bfloat16, name
            np.testing.assert_allclose(o_t.float().numpy(), r, atol=2e-2, rtol=2e-2,
                                       err_msg=name)

    def test_gradcheck_f64(self):
        """The autograd Function's backward (the plain dq and dk/dv versions
        on saved o and lse) against finite differences, in f64."""
        rng = np.random.default_rng(11)
        q, k, v = [torch.from_numpy(rng.standard_normal((1, 1, 128, 16))).requires_grad_()
                   for _ in range(3)]
        assert torch.autograd.gradcheck(tfa.flash_attention_bhsd, (q, k, v), fast_mode=True)

    def test_autograd_matches_dense(self):
        """Gradients of the (B, S, H, D) adapter, through strided views,
        against autograd of the dense path, f32."""
        q, k, v = [t.requires_grad_() for t in _t(*_qkv((2, 256, 3, 64), seed=12))]
        do = torch.from_numpy(np.random.default_rng(13).standard_normal((2, 256, 3, 64))
                              .astype(np.float32))
        grads = torch.autograd.grad(tfa.flash_attention(q, k, v), (q, k, v), do)
        ref = torch.autograd.grad(dense_attention(q, k, v), (q, k, v), do)
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            torch.testing.assert_close(g, r, **F32_TOL, msg=name)


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


@pytest.mark.parametrize("D,dtype,refused", [
    (16, torch.bfloat16, True),
    (32, torch.float32, True),
    (64, torch.float16, True),
    (64, torch.bfloat16, False),
    (128, torch.float32, False),
])
def test_kernel_input_check_refuses_what_the_kernels_do_not_take(D, dtype, refused):
    """The check a CUDA tensor passes before its kernel launches: head dim
    64 or 128 in f32 or bf16, else a ValueError, never a quiet fallback."""
    q = torch.zeros(2, 4, 128, D, dtype=dtype)
    if refused:
        with pytest.raises(ValueError, match="head dim|float32 or bfloat16"):
            tfa._check_kernel_inputs(q, q, q)
    else:
        tfa._check_kernel_inputs(q, q, q)
