"""Block-quantized wire codecs for runtime collectives (Collectives v2).

EQuARX-style (arxiv 2506.17615) payload compression: a float32 tensor
is encoded per contiguous *block* into a compact wire format and
decoded back to float32 at the receiving hop, trading a bounded
per-block error for 2x (bf16) or ~4x (int8) fewer wire bytes.  Opt-in
per group (``GroupOptions.wire_dtype``) or per op
(``allreduce(..., wire_dtype="int8")``); the default path never
imports this module's kernels and ships raw fp32 bytes bit-for-bit.

Codec contract (all arrays are 1-D contiguous):

- ``encode(flat_f32) -> uint8 wire buffer`` — deterministic: the same
  input always produces the same bytes (round-half-even, no RNG), so
  every receiver of one encoding decodes bit-identical values.
- ``decode(wire_u8, n_elems) -> float32`` — total: any buffer of the
  right size decodes (garbage in, garbage out, never a crash).
- ``encoded_nbytes(n_elems)`` — exact wire size, known to both sides
  up front (the chunked transport needs the expected byte count).
- ``error_bound(flat_f32) -> float`` — max |x - decode(encode(x))|
  guaranteed element-wise for FINITE input; the property tests hold
  every codec to it on adversarial distributions.

Non-finite input (inf/nan) is REJECTED at encode: a quantized scale
derived from an inf absmax silently zeroes the whole block, which is a
training-quality bug worth failing loudly over.

int8 layout: ``[n_blocks x f32 scale][n_elems x int8]`` — per-block
absmax/127 scales, round-half-even quantization.  Error bound per
element: ``scale/2`` of its block = ``absmax_block / 254``.

bf16 layout: ``[n_elems x u16]`` — round-to-nearest-even truncation of
the f32 bit pattern (pure bit math, no ml_dtypes dependency).  Error
bound per element: ``|x| * 2**-8`` (one ulp of an 8-bit mantissa,
conservative).
"""

from __future__ import annotations

import ctypes
from typing import Optional

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.util.collective.types import CollectiveError


def _qlib():
    """The fused native kernels (ray_tpu_torch/_native/quant.cc), or None
    when the image has no compiler — numpy paths below are the
    bit-identical fallback."""
    from ray_tpu_torch._native import quant

    return quant.lib()


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i8ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _u16ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def _u32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _require_f32(flat):
    import numpy as np

    a = np.ascontiguousarray(flat).reshape(-1)
    if a.dtype != np.float32:
        raise CollectiveError(
            f"wire_dtype quantization needs float32 tensors, got "
            f"{a.dtype} — cast explicitly or drop wire_dtype for the "
            f"raw path (any dtype)"
        )
    return a


def _reject_non_finite():
    raise CollectiveError(
        "non-finite values (inf/nan) in a tensor bound for a "
        "quantized collective: block scales would be poisoned and "
        "the whole block silently zeroed.  Clean the tensor or use "
        "the fp32 path."
    )


class Int8BlockCodec:
    """Per-block absmax int8: ~3.9x smaller on the wire at block=2048.

    Kernels are written for a CPU-bound host (every pass competes with
    the transport's memcpys for the same cores): full blocks run
    vectorized with ONE large temporary (the scaled f32 view), the
    int8 cast lands straight into the wire buffer via ``np.copyto``,
    and the non-finite check rides the per-block max/min reductions
    (NaN/inf propagate through max) instead of a full-size
    ``isfinite`` pass.
    """

    name = "int8"

    def __init__(self, block: Optional[int] = None):
        self.block = int(block or cfg.collective_quant_block)
        self._scratch = {}  # shape -> f32 work buffer (encode temp)

    def _n_blocks(self, n_elems: int) -> int:
        return max((n_elems + self.block - 1) // self.block, 0)

    def encoded_nbytes(self, n_elems: int) -> int:
        return 4 * self._n_blocks(n_elems) + n_elems

    def _block_encode(self, b2, scales, q2):
        """Encode ``b2`` (nb, block) into scales + int8 rows in place."""
        import numpy as np

        # absmax via max/min reductions: no |a|-sized temporary, and
        # NaN/inf propagate so the finite check is O(n_blocks)
        mx = b2.max(axis=1)
        np.negative(b2.min(axis=1), out=scales)
        np.maximum(scales, mx, out=scales)
        if scales.size and not np.isfinite(scales).all():
            _reject_non_finite()
        recip = np.divide(
            np.float32(127.0), scales,
            out=np.zeros_like(scales), where=scales > 0.0,
        )  # zero blocks encode to zeros (scale 0), no divide warning
        scales /= np.float32(127.0)
        scaled = self._scratch.get(b2.shape)
        if scaled is None:
            if len(self._scratch) > 8:  # bound the cache (odd sizes)
                self._scratch.clear()
            scaled = self._scratch[b2.shape] = np.empty(
                b2.shape, np.float32
            )
        np.multiply(b2, recip[:, None], out=scaled)
        # round-half-even (np.rint): deterministic, matches IEEE
        # default.  |scaled| <= 127*(1+eps) by construction, so the
        # int8 cast cannot overflow — no clip pass needed.
        np.rint(scaled, out=scaled)
        np.copyto(q2, scaled, casting="unsafe")

    def encode(self, flat, out=None):
        """Encode to the wire buffer.  ``out`` (uint8, exact encoded
        size) lets ring hops reuse one buffer instead of re-faulting a
        fresh allocation per hop — chunk sends complete before the
        caller's next reuse (every chunk rpc is awaited)."""
        import numpy as np

        a = _require_f32(flat)
        n = a.size
        nb = self._n_blocks(n)
        if out is None:
            out = np.empty(self.encoded_nbytes(n), dtype=np.uint8)
        if not n:
            return out
        scales = out[: 4 * nb].view(np.float32)
        q = out[4 * nb:].view(np.int8)
        lib = _qlib()
        if lib is not None:
            if lib.rt_quant_int8_encode(
                _fptr(a), n, self.block, _fptr(scales), _i8ptr(q)
            ):
                _reject_non_finite()
            return out
        full = n // self.block
        if full:
            self._block_encode(
                a[: full * self.block].reshape(full, self.block),
                scales[:full], q[: full * self.block].reshape(full, -1),
            )
        if nb > full:  # ragged tail block (tiny)
            tail = a[full * self.block:]
            self._block_encode(
                tail.reshape(1, -1), scales[full:],
                q[full * self.block:].reshape(1, -1),
            )
        return out

    def decode_into(self, wire, out) -> None:
        """Decode straight into a writable contiguous f32 view (ring
        hops decode into the result tensor's segment — no intermediate
        allocation or copy pass)."""
        import numpy as np

        buf = np.ascontiguousarray(wire).reshape(-1).view(np.uint8)
        n_elems = out.size
        nb = self._n_blocks(n_elems)
        if buf.size != self.encoded_nbytes(n_elems):
            raise CollectiveError(
                f"int8 wire buffer is {buf.size} bytes, expected "
                f"{self.encoded_nbytes(n_elems)} for {n_elems} elems"
            )
        if not n_elems:
            return
        scales = buf[: 4 * nb].view(np.float32)
        q = buf[4 * nb:].view(np.int8)
        lib = _qlib()
        if lib is not None:
            lib.rt_quant_int8_decode(
                _fptr(scales), _i8ptr(q), n_elems, self.block, _fptr(out)
            )
            return
        full = n_elems // self.block
        if full:
            o2 = out[: full * self.block].reshape(full, self.block)
            np.copyto(
                o2, q[: full * self.block].reshape(full, -1),
                casting="unsafe",
            )  # int8 -> f32 straight into the output
            o2 *= scales[:full, None]
        if nb > full:
            tail = out[full * self.block:]
            np.copyto(tail, q[full * self.block:], casting="unsafe")
            tail *= scales[full]

    def decode_add_into(self, wire, acc) -> None:
        """``acc += decode(wire)`` in one pass — the ring reduce-scatter
        accumulation fused with the decode (SUM/MEAN fast path)."""
        import numpy as np

        buf = np.ascontiguousarray(wire).reshape(-1).view(np.uint8)
        n_elems = acc.size
        nb = self._n_blocks(n_elems)
        if buf.size != self.encoded_nbytes(n_elems):
            raise CollectiveError(
                f"int8 wire buffer is {buf.size} bytes, expected "
                f"{self.encoded_nbytes(n_elems)} for {n_elems} elems"
            )
        if not n_elems:
            return
        lib = _qlib()
        if lib is not None:
            lib.rt_quant_int8_decode_add(
                _fptr(buf[: 4 * nb].view(np.float32)),
                _i8ptr(buf[4 * nb:].view(np.int8)),
                n_elems, self.block, _fptr(acc),
            )
            return
        scratch = self._scratch.get(("dec", n_elems))
        if scratch is None:
            if len(self._scratch) > 8:
                self._scratch.clear()
            scratch = self._scratch[("dec", n_elems)] = np.empty(
                n_elems, np.float32
            )
        self.decode_into(buf, scratch)
        np.add(acc, scratch, out=acc)

    def decode(self, wire, n_elems: int):
        import numpy as np

        out = np.empty(n_elems, dtype=np.float32)
        self.decode_into(wire, out)
        return out

    def error_bound(self, flat) -> float:
        import numpy as np

        a = _require_f32(flat)
        if not a.size:
            return 0.0
        nb = self._n_blocks(a.size)
        pad = nb * self.block - a.size
        blocks = (np.pad(a, (0, pad)) if pad else a).reshape(nb, self.block)
        # scale/2 per block + fp slop for the divide/multiply round trip
        bound = np.abs(blocks).max(axis=1) / 254.0
        return float(bound.max() * (1.0 + 1e-5) + 1e-30)


class Bf16Codec:
    """Round-to-nearest-even f32 -> bf16 truncation: 2x smaller."""

    name = "bf16"

    def __init__(self, block: Optional[int] = None):
        self._scratch = {}  # size -> u32 work buffer

    def encoded_nbytes(self, n_elems: int) -> int:
        return 2 * n_elems

    def encode(self, flat, out=None):
        import numpy as np

        a = _require_f32(flat)
        if out is None:
            out = np.empty(2 * a.size, dtype=np.uint8)
        if not a.size:
            return out
        bits = a.view(np.uint32)
        lib = _qlib()
        if lib is not None:
            if lib.rt_quant_bf16_encode(
                _u32ptr(bits), a.size, _u16ptr(out.view(np.uint16))
            ):
                _reject_non_finite()
            return out
        if not (np.isfinite(a.max()) and np.isfinite(a.min())):
            # reductions propagate NaN/inf: no full-size isfinite pass
            _reject_non_finite()
        rounded = self._scratch.get(a.size)
        if rounded is None:
            if len(self._scratch) > 8:
                self._scratch.clear()
            rounded = self._scratch[a.size] = np.empty(a.size, np.uint32)
        # round to nearest even on the dropped 16 bits
        np.right_shift(bits, np.uint32(16), out=rounded)
        rounded &= np.uint32(1)
        rounded += bits
        rounded += np.uint32(0x7FFF)
        rounded >>= np.uint32(16)
        np.copyto(out.view(np.uint16), rounded, casting="unsafe")
        return out

    def decode_into(self, wire, out) -> None:
        import numpy as np

        buf = np.ascontiguousarray(wire).reshape(-1).view(np.uint8)
        if buf.size != 2 * out.size:
            raise CollectiveError(
                f"bf16 wire buffer is {buf.size} bytes, expected "
                f"{2 * out.size} for {out.size} elems"
            )
        if not out.size:
            return
        lib = _qlib()
        if lib is not None:
            lib.rt_quant_bf16_decode(
                _u16ptr(buf.view(np.uint16)), out.size,
                _u32ptr(out.view(np.uint32)),
            )
            return
        u32 = out.view(np.uint32)
        np.copyto(u32, buf.view(np.uint16), casting="unsafe")
        u32 <<= np.uint32(16)

    def decode_add_into(self, wire, acc) -> None:
        """``acc += decode(wire)`` fused (SUM/MEAN ring fast path)."""
        import numpy as np

        buf = np.ascontiguousarray(wire).reshape(-1).view(np.uint8)
        if buf.size != 2 * acc.size:
            raise CollectiveError(
                f"bf16 wire buffer is {buf.size} bytes, expected "
                f"{2 * acc.size} for {acc.size} elems"
            )
        if not acc.size:
            return
        lib = _qlib()
        if lib is not None:
            lib.rt_quant_bf16_decode_add(
                _u16ptr(buf.view(np.uint16)), acc.size, _fptr(acc)
            )
            return
        scratch = self._scratch.get(("dec", acc.size))
        if scratch is None:
            if len(self._scratch) > 8:
                self._scratch.clear()
            scratch = self._scratch[("dec", acc.size)] = np.empty(
                acc.size, np.float32
            )
        self.decode_into(buf, scratch)
        np.add(acc, scratch, out=acc)

    def decode(self, wire, n_elems: int):
        import numpy as np

        out = np.empty(n_elems, dtype=np.float32)
        self.decode_into(wire, out)
        return out

    def error_bound(self, flat) -> float:
        import numpy as np

        a = _require_f32(flat)
        if not a.size:
            return 0.0
        return float(np.abs(a).max() * 2.0 ** -8 + 1e-30)


_CODECS = {"int8": Int8BlockCodec, "bf16": Bf16Codec}


def get_codec(wire_dtype: Optional[str], block: Optional[int] = None):
    """The codec instance for ``wire_dtype`` — or None for the raw
    fp32 path (None or "fp32"), which must never pay a codec call."""
    if wire_dtype is None or wire_dtype == "fp32":
        return None
    cls = _CODECS.get(wire_dtype)
    if cls is None:
        raise CollectiveError(
            f"unknown wire_dtype {wire_dtype!r}; known: "
            f"{['fp32'] + sorted(_CODECS)}"
        )
    return cls(block)
