// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// ray_tpu/ops/flash_attention.py (launched by `_fwd`).  Same function:
//   o   = softmax(q k^T * scale, causal) v        in q's dtype
//   lse = m + log(l)                              (B, H, S) float32
// with masked scores at -1e30, l clamped at >= 1e-30, and kv tiles above the
// diagonal skipped.
//
// What bounds it on an H100: at the GPT-2 shape (B=8, H=12, S=1024, D=64,
// bf16) the function must move ~51 MB (q, k, v, o once each, plus lse), which
// is ~15 us at 3.35 TB/s, and do ~12.9 GFLOP of causal products, ~13 us at the
// bf16 tensor-core peak: it is bytes-bound on paper, with the products close
// behind.  What the design does about the bytes: every q, k and v element is
// read from device memory once per tile that needs it, the (S, S) scores never
// leave the SM, and o is written once at the end.  About the products: bf16
// inputs go through the tensor cores (mma.sync m16n8k16, f32 accumulation);
// wgmma, TMA and a pipelined producer warp, which the full rate needs, are
// left for a later version.
//
// Design (not the TPU's): the TPU walks the kv grid axis in order and keeps
// its accumulator in the output block, rounding it to q's dtype after every kv
// block.  Here one thread block owns one (b, h, 64-row q tile) and loops over
// the kv tiles up to the diagonal itself, keeping the online softmax (running
// max m, running sum l) and the o accumulator in float32 registers; o rounds
// once, when it is stored.  Blocks are scheduled heaviest q tile first, which
// evens out the causal triangle's load across the SMs.  q, k and v are
// addressed through (batch, head, seq) strides with a unit stride along D, so
// the model's strided (B, S, 3H, D) projection output is read in place; o and
// lse are contiguous.  Two kernels, chosen by dtype:
//   - bf16: 4 warps, each owning 16 q rows.  q, k and v^T tiles are staged in
//     shared memory (rows padded by 8 elements so fragment reads hit distinct
//     banks); each warp keeps its q fragments in registers, computes
//     s = q k^T with mma.sync, and reuses the s accumulators, rounded to bf16,
//     as the A operand of p v (as the Pallas kernel rounds p to v's dtype).
//   - float32 (the reference tests' type): the same tiling on the CUDA cores,
//     tiles staged as float32; thread (r, c) = (tid / 16, tid % 16) owns q rows
//     8r .. 8r+7 and columns c + 16j, and p never leaves float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kLdv = kBlockK + 8;  // row length of the v^T tile

template <int D>
constexpr size_t mma_smem_bytes() {
  // q and k tiles (rows of D + 8), v^T tile (D rows of kBlockK + 8)
  return sizeof(bf16) * (size_t)((kBlockQ + kBlockK) * (D + 8) + D * kLdv);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b, one 16x8x16 tile: a row-major 16x16 bf16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 rows of D bf16 into dst[row][ld], 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          int64_t row_stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

// 64 rows of D bf16, stored transposed: dst[d][row], row length kLdv.
template <int D>
__device__ __forceinline__ void load_rows_transposed(
    bf16* dst, const bf16* __restrict__ src, int64_t row_stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    uint4 v = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * kLdv + r] = e[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int S, Strides qs,
                         Strides ks, Strides vs, float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;       // k-steps of q k^T
  constexpr int NS = kBlockK / 8;  // 8-column blocks of s
  constexpr int NO = D / 8;        // 8-column blocks of o

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBlockQ * LD;
  bf16* Vt = Ks + kBlockK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group, column pair
  const int r0 = (threadIdx.x / 32) * 16 + g;  // this thread's rows: r0, r0 + 8

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  load_rows<D>(Qs, LD, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s);
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const bf16* p = Qs + r0 * LD + kd * 16 + t4 * 2;
    qf[kd][0] = ld32(p);
    qf[kd][1] = ld32(p + 8 * LD);
    qf[kd][2] = ld32(p + 8);
    qf[kd][3] = ld32(p + 8 * LD + 8);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int last_kt = (q0 + kBlockQ - 1) / kBlockK;  // causal: tiles 0..last
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers of Ks and Vt are done
    load_rows<D>(Ks, LD, kb + k0 * ks.s, ks.s);
    load_rows_transposed<D>(Vt, vb + k0 * vs.s, vs.s);
    __syncthreads();

    // s = q k^T: element e of block n is (row r0 + 8 (e / 2),
    // column n * 8 + t4 * 2 + e % 2).
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const bf16* p = Ks + (n * 8 + g) * LD + kd * 16 + t4 * 2;
        mma_bf16(s[n], qf[kd], ld32(p), ld32(p + 8));
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q_pos = q0 + r0 + 8 * (e / 2);
        const int k_pos = k0 + n * 8 + t4 * 2 + e % 2;
        s[n][e] = q_pos >= k_pos ? s[n][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e / 2]);
        sum[e / 2] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // o += p v: the s accumulators of blocks 2j and 2j + 1 are, element for
    // element, the A fragment of k-step j.
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* p = Vt + (n * 8 + g) * kLdv + j * 16 + t4 * 2;
        mma_bf16(acc[n], a, ld32(p), ld32(p + 8));
      }
    }
  }

  const int64_t bh = (int64_t)b * H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = q0 + r0 + 8 * i;
    const float lc = fmaxf(l[i], 1e-30f);
    bf16* orow = o + (bh * S + q_pos) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    if (t4 == 0) lse[bh * S + q_pos] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRowsPerThread = kBlockQ / (kThreads / 16);  // 8
constexpr int kColsPerThread = kBlockK / 16;               // 4

template <int D>
constexpr size_t f32_smem_bytes() {
  // q, k, v tiles (rows of D + 1 floats) and the p tile (rows of 65 floats)
  return sizeof(float) *
         (size_t)((kBlockQ + 2 * kBlockK) * (D + 1) + kBlockQ * (kBlockK + 1));
}

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int64_t row_stride) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] = src[r * row_stride + c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int S, Strides qs,
                         Strides ks, Strides vs, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlockK + 1;
  constexpr int DC = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int row0 = tr * kRowsPerThread;  // first local q row of this thread

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  load_tile_f32<D>(Qs, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s);

  float acc[kRowsPerThread][DC];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < DC; ++d) acc[i][d] = 0.f;
  }

  const int last_kt = (q0 + kBlockQ - 1) / kBlockK;  // causal: tiles 0..last
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    load_tile_f32<D>(Ks, kb + k0 * ks.s, ks.s);
    load_tile_f32<D>(Vs, vb + k0 * vs.s, vs.s);
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;

#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) kv[j] = Ks[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float qv = Qs[(row0 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int q_pos = q0 + row0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int k_pos = k0 + tc + 16 * j;
        s[i][j] = q_pos >= k_pos ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(row0 + i) * LDP + tc + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = m_new;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int d = 0; d < DC; ++d) acc[i][d] *= corr;
    }
    __syncthreads();  // the whole p tile is in shared memory

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[DC];
#pragma unroll
      for (int d = 0; d < DC; ++d) vv[d] = Vs[j * LD + tc + 16 * d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float p = Ps[(row0 + i) * LDP + j];
#pragma unroll
        for (int d = 0; d < DC; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }

  const int64_t bh = (int64_t)b * H + h;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int q_pos = q0 + row0 + i;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + (bh * S + q_pos) * D;
#pragma unroll
    for (int d = 0; d < DC; ++d) orow[tc + 16 * d] = acc[i][d] / lc;
    if (tc == 0) lse[bh * S + q_pos] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* q, const void* k,
                   const void* v, void* o, float* lse, int B, int H, int S,
                   Strides qs, Strides ks, Strides vs, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, S, qs, ks, vs,
      scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; D's is 1.  The
// bf16 kernel reads rows 16 bytes at a time: pointers 16-byte aligned and
// strides multiples of 8.  Returns a cudaError_t (0 on success).  Launches on
// `stream`, does not synchronise and allocates nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int H, int S,
                                   int D, int64_t q_sb, int64_t q_sh,
                                   int64_t q_ss, int64_t k_sb, int64_t k_sh,
                                   int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                   int64_t v_ss, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % kBlockQ != 0) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch<bf16>(flash_fwd_mma_kernel<64>, mma_smem_bytes<64>(), q, k, v,
                        o, l, B, H, S, qs, ks, vs, scale, st);
  if (dtype == 1 && D == 128)
    return launch<bf16>(flash_fwd_mma_kernel<128>, mma_smem_bytes<128>(), q, k,
                        v, o, l, B, H, S, qs, ks, vs, scale, st);
  if (dtype == 0 && D == 64)
    return launch<float>(flash_fwd_f32_kernel<64>, f32_smem_bytes<64>(), q, k,
                         v, o, l, B, H, S, qs, ks, vs, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float>(flash_fwd_f32_kernel<128>, f32_smem_bytes<128>(), q,
                         k, v, o, l, B, H, S, qs, ks, vs, scale, st);
  return cudaErrorInvalidValue;
}
