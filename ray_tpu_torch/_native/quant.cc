// Fused block-quantization kernels for the collective wire codecs
// (ray_tpu/util/collective/quantize.py).
//
// The numpy reference implementation is 5+ full-size memory passes per
// encode (max/min reductions, scaled multiply, rint, cast-copy); on a
// CPU-bound host those passes compete with the transport's memcpys for
// the same cores and dominate the quantized ring's wall clock.  These
// kernels fuse each direction into the minimum number of passes:
//
//   int8 encode  = 1 read pass (absmax + finite check) +
//                  1 read/write pass (scale, round-half-even, cast)
//   int8 decode  = 1 pass (cast + scale), optionally fused with the
//                  ring reduce-scatter accumulation (decode_add)
//   bf16 encode  = 1 pass (round-to-nearest-even bit math + finite)
//   bf16 decode  = 1 pass (shift), optionally fused with accumulate
//
// Numerics are kept bit-identical to the numpy path: float32 ops in
// the same order (scale = absmax/127, q = roundeven(a * (127/absmax)),
// out = q * scale), compiled with -ffp-contract=off so no FMA
// contraction sneaks in — a fleet mixing native and numpy ranks must
// produce identical wire bytes and identical decodes.
//
// Non-finite input returns 1 (the Python layer raises); note NaN never
// survives a `v > amax` comparison, so the finite check is an explicit
// `!(v <= FLT_MAX)` per element, which catches NaN and +/-inf alike.

#include <cstdint>
#include <cmath>
#include <algorithm>

namespace {
constexpr float kFltMax = 3.402823466e38f;
}

extern "C" {

int rt_quant_int8_encode(const float* a, int64_t n, int64_t block,
                         float* scales, int8_t* q) {
    if (n <= 0) return 0;
    int64_t nb = (n + block - 1) / block;
    for (int64_t b = 0; b < nb; ++b) {
        const int64_t lo = b * block;
        const int64_t hi = std::min(n, lo + block);
        float amax = 0.0f;
        int bad = 0;  // branchless accumulation keeps the loop SIMD
        for (int64_t i = lo; i < hi; ++i) {
            float v = std::fabs(a[i]);
            bad |= !(v <= kFltMax);  // catches NaN (compare false) + inf
            amax = v > amax ? v : amax;
        }
        if (bad) return 1;
        const float scale = amax / 127.0f;
        const float recip = amax > 0.0f ? 127.0f / amax : 0.0f;
        scales[b] = scale;
        for (int64_t i = lo; i < hi; ++i) {
            // round-half-even (lrintf under the default FE_TONEAREST ==
            // np.rint; vectorizes to cvtps2dq); |a*recip| <= 127(1+eps)
            q[i] = (int8_t)lrintf(a[i] * recip);
        }
    }
    return 0;
}

void rt_quant_int8_decode(const float* scales, const int8_t* q,
                          int64_t n, int64_t block, float* out) {
    if (n <= 0) return;
    int64_t nb = (n + block - 1) / block;
    for (int64_t b = 0; b < nb; ++b) {
        const int64_t lo = b * block;
        const int64_t hi = std::min(n, lo + block);
        const float s = scales[b];
        for (int64_t i = lo; i < hi; ++i) {
            out[i] = (float)q[i] * s;
        }
    }
}

void rt_quant_int8_decode_add(const float* scales, const int8_t* q,
                              int64_t n, int64_t block, float* acc) {
    if (n <= 0) return;
    int64_t nb = (n + block - 1) / block;
    for (int64_t b = 0; b < nb; ++b) {
        const int64_t lo = b * block;
        const int64_t hi = std::min(n, lo + block);
        const float s = scales[b];
        for (int64_t i = lo; i < hi; ++i) {
            acc[i] += (float)q[i] * s;
        }
    }
}

int rt_quant_bf16_encode(const uint32_t* bits, int64_t n, uint16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t b = bits[i];
        if ((b & 0x7f800000u) == 0x7f800000u) return 1;  // NaN/inf
        out[i] = (uint16_t)((b + 0x7fffu + ((b >> 16) & 1u)) >> 16);
    }
    return 0;
}

void rt_quant_bf16_decode(const uint16_t* in, int64_t n, uint32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = ((uint32_t)in[i]) << 16;
    }
}

void rt_quant_bf16_decode_add(const uint16_t* in, int64_t n, float* acc) {
    for (int64_t i = 0; i < n; ++i) {
        union { uint32_t u; float f; } v;
        v.u = ((uint32_t)in[i]) << 16;
        acc[i] += v.f;
    }
}

}  // extern "C"
