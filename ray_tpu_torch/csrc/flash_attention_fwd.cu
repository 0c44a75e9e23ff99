// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// ray_tpu/ops/flash_attention.py (launched by `_fwd`).  Same function:
//   o   = softmax(q k^T * scale, causal) v        in q's dtype
//   lse = m + log(l)                              (B, H, S) float32
// with masked scores contributing 0, l clamped at >= 1e-30, and kv tiles
// above the diagonal skipped.
//
// What bounds it on an H100: at the GPT-2 shape (B=8, H=12, S=1024, D=64,
// bf16) the function must move ~51 MB (q, k, v, o once each, plus lse), ~15 us
// at 3.35 TB/s, and do ~12.9 GFLOP of causal products, ~13 us at the bf16
// tensor-core peak: bytes-bound on paper, the products close behind, so the
// design has to keep both the memory system and the tensor cores busy at once.
//
// Design (not the TPU's).  The TPU walks the kv grid axis in order and keeps
// its accumulator in the output block, rounding it to q's dtype after every
// kv block.  Here a thread block owns a (b, h, 128-row q tile) at a time and
// walks the kv tiles up to the diagonal itself, keeping the online softmax and
// the o accumulator in f32 registers; o rounds once, when it is stored.
//   - bf16 (`flash_fwd_wgmma_kernel`): persistent, one block per SM, each
//     walking its share of the q tiles, heaviest first in a snake order
//     (hopper::snake_tile), so one tile's last products and stores overlap the
//     next tile's loads.  Three warpgroups.  Warpgroup 0 is the producer: one
//     thread issues TMA loads (csrc/hopper.cuh) of each q tile and of each
//     128-row k and v tile into a ring of 3 stages, tracked by a full and an
//     empty mbarrier per stage (and a pair for q).  Warpgroups 1 and 2 are
//     the consumers, 64 q rows each: s = q k^T is one SS wgmma (m64n128k16)
//     per 16 columns of D; p = exp2(s scale log2(e) - m scale log2(e)), one
//     FMA before ex2.approx (lse goes back to natural log at the end); the
//     causal compare runs on the diagonal tile only; o += p v is an RS wgmma
//     with p taken straight from the s accumulators rounded to bf16 (the f32
//     accumulator layout is the A-register layout) and v read from its
//     row-major tile with the transpose flag.  Two overlaps, both FA3's:
//     within a warpgroup, the softmax of kv tile j runs while p v of tile
//     j - 1 is on the tensor cores; between the two warpgroups, named
//     barriers make them take turns to issue their products, so one's
//     softmax runs while the other's products run.  setmaxnreg gives the
//     producer 40 registers and the consumers 232.  q, k and v are read
//     through (batch, head, seq) strides by 4-D tensor maps, so the model's
//     strided (B, S, 3H, D) views are read in place.  o and lse are
//     contiguous and stored from registers.
//   - float32 (the reference tests' type): one block per 64-row q tile on the
//     CUDA cores, tiles staged as float32; thread (r, c) = (tid / 16,
//     tid % 16) owns q rows 8r .. 8r+7 and columns c + 16j, and p never
//     leaves float32.

#include "hopper.cuh"


namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockQ = 64;  // float32 kernel tiles
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  static constexpr int kRows = 128;               // q rows of a block, kv rows of a tile
  static constexpr int kConsumers = 2;            // warpgroups of 64 q rows
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kStages = 3;  // k/v ring depth
  static constexpr uint32_t kTileBytes = kRows * D * 2;  // one q, k or v tile
  static constexpr uint32_t kBoxBytes = kRows * 128;     // one 64-column box of it
  // q tile, then per stage a k tile and a v tile; 1024 of slack to align
  static constexpr size_t kSmem = (size_t)kTileBytes * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           bf16* __restrict__ o, float* __restrict__ lse, int B,
                           int H, int S, float scale) {
  using namespace hopper;
  using C = Fwd<D>;
  constexpr int R = C::kRows, NST = C::kStages;

  __shared__ __align__(8) uint64_t q_full, q_empty, kv_full[NST], kv_empty[NST];
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t base = (smem_addr(smem_tiles) + 1023) & ~1023u;
  const uint32_t q_tile = base;
  auto k_tile = [&](int st) { return base + C::kTileBytes * (1 + 2 * st); };
  // Tile t: q tile S / R - 1 - t / (B H) of head t % (B H), heaviest first.
  const int n_tiles = (S / R) * B * H, n_qt = S / R;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, 4 * C::kConsumers);  // one arrival a consumer warp
    for (int st = 0; st < NST; ++st) {
      mbar_init(&kv_full[st], 1);
      mbar_init(&kv_empty[st], 4 * C::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      int it = 0;  // kv tiles loaded so far: ring stage it % NST
      for (int r = 0, t; (t = snake_tile(r, n_tiles)) >= 0; ++r) {
        const int qt = n_qt - 1 - t / (B * H), bh = t % (B * H), b = bh / H, h = bh % H;
        mbar_wait(&q_empty, (r & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full, C::kTileBytes);
        tma_load_rows<D>(q_tile, &qmap, &q_full, R, qt * R, h, b);
        for (int kt = 0; kt <= qt; ++kt, ++it) {
          const int st = it % NST;
          mbar_wait(&kv_empty[st], ((it / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&kv_full[st], 2 * C::kTileBytes);
          tma_load_rows<D>(k_tile(st), &kmap, &kv_full[st], R, kt * R, h, b);
          tma_load_rows<D>(k_tile(st) + C::kTileBytes, &vmap, &kv_full[st], R, kt * R, h, b);
        }
      }
    }
    return;
  }

  regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;  // consumer warpgroup: q rows 64c ..
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = 64 * c + 16 * w + g;  // this thread's rows of a tile: r0, r0 + 8
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const uint32_t q_rows = q_tile + 64 * c * 128;  // this warpgroup's q rows

  float acc[D / 2];
  float m[2], l[2], corr[2];
  // s = q k^T of one kv tile: element (row g or g + 8, column 8 j + 2 t4 +
  // {0, 1}) of this warp's 16 rows is s[4 j + {0, 1}] or s[4 j + {2, 3}].
  float s[R / 2];
  uint32_t pa[R / 16][4];  // the previous tile's p, as A fragments

  auto issue_s = [&](int it) {  // s = q k^T of the kv tile in stage it % NST
    const uint32_t kk_tile = k_tile(it % NST);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<R, 0>(s, desc_k_major(q_rows, C::kBoxBytes, kk),
                     desc_k_major(kk_tile, C::kBoxBytes, kk), kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int it) {  // o += p v of the kv tile in stage it % NST
    const uint32_t v_tile = k_tile(it % NST) + C::kTileBytes;
#pragma unroll
    for (int j = 0; j < R / 16; ++j)
      wgmma_rs<D, 1>(acc, pa[j], desc_mn_major(v_tile, C::kBoxBytes, j), 1);
    wgmma_commit();
  };
  // The online softmax of s in place: p = exp2(s sl2 - m sl2), with the
  // causal compare on the diagonal tile only; sets corr, the factor that
  // rescales o and l to the new row maxima.
  auto softmax = [&](bool diagonal) {
    if (diagonal) {
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t4 + (e & 1) > r0 + 8 * (e >> 1)) s[4 * j + e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY}, neg[2];
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2_ftz((m[i] - m_new) * sl2);
      neg[i] = -m_new * sl2;
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = exp2_ftz(fmaf(s[4 * j + e], sl2, neg[e >> 1]));
        l[e >> 1] += s[4 * j + e];
      }
  };
  auto arrive = [&](uint64_t* bar) {  // this warp is done with what bar guards
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Ping-pong (FA3): the two warpgroups take turns to issue their products,
  // so one's softmax runs while the other's products hold the tensor cores.
  // Each takes the same number of turns, so the turns stay paired.
  auto turn_take = [&] { named_sync(1 + c, 256); };
  auto turn_give = [&] { named_arrive(2 - c, 256); };
  if (c == 1) named_arrive(1, 256);  // warpgroup 0 goes first

  int it = 0;  // kv tiles consumed so far: ring stage it % NST
  for (int r = 0, t; (t = snake_tile(r, n_tiles)) >= 0; ++r) {
    const int qt = n_qt - 1 - t / (B * H), n_kt = qt + 1;  // kv tiles 0 .. qt, qt diagonal
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) m[i] = -INFINITY, l[i] = 0.f;

    // Software pipeline (FA3's intra-warpgroup overlap): while o += p v of
    // kv tile kt - 1 runs on the tensor cores, the softmax of tile kt runs on
    // the CUDA cores; p of tile kt - 1 waits in pa as bf16 A fragments.
    mbar_wait(&q_full, r & 1);
    mbar_wait(&kv_full[it % NST], (it / NST) & 1);
    turn_take();
    wgmma_fence();
    issue_s(it);
    turn_give();
    wgmma_wait<0>();
    fence_regs(s);
    if (n_kt == 1) arrive(&q_empty);
    softmax(n_kt == 1);
    acc_to_a<R>(pa, s);
    for (int kt = 1; kt < n_kt; ++kt, ++it) {
      mbar_wait(&kv_full[(it + 1) % NST], ((it + 1) / NST) & 1);
      turn_take();
      wgmma_fence();
      issue_s(it + 1);
      issue_pv(it);
      turn_give();
      wgmma_wait<1>();  // s of tile kt has landed; p v of tile kt - 1 may run on
      fence_regs(s);
      if (kt == n_kt - 1) arrive(&q_empty);  // q is read by no later product
      softmax(kt == n_kt - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      arrive(&kv_empty[it % NST]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
      acc_to_a<R>(pa, s);
    }
    turn_take();
    wgmma_fence();
    issue_pv(it);
    turn_give();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    arrive(&kv_empty[it % NST]);
    ++it;

    const int64_t row0 = (int64_t)(t % (B * H)) * S + qt * R + r0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const float lc = fmaxf(l[i], 1e-30f), inv = 1.f / lc;
      bf16* orow = o + (row0 + 8 * i) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      if (t4 == 0) lse[row0 + 8 * i] = m[i] * scale + logf(lc);
    }
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

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int S, Strides qs, Strides ks,
                         Strides vs, float scale, cudaStream_t stream) {
  using C = Fwd<D>;
  if (S % C::kRows != 0) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err = hopper::make_map(&qm, q, B, H, S, D, qs.b, qs.h, qs.s, C::kRows);
  if (!err) err = hopper::make_map(&km, k, B, H, S, D, ks.b, ks.h, ks.s, C::kRows);
  if (!err) err = hopper::make_map(&vm, v, B, H, S, D, vs.b, vs.h, vs.s, C::kRows);
  if (err) return static_cast<cudaError_t>(err);
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  int device, sms;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  const int n_tiles = B * H * (S / C::kRows);
  // One block per SM (at most), each walking its share of the tiles.
  kernel<<<n_tiles < sms ? n_tiles : sms, C::kThreads, C::kSmem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), lse, B, H, S, scale);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, size_t smem, const void* q, const void* k,
                       const void* v, void* o, float* lse, int B, int H, int S,
                       Strides qs, Strides ks, Strides vs, float scale,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, S, qs, ks,
      vs, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; D's is 1.  The
// bf16 kernel reads q, k and v through TMA: pointers 16-byte aligned, strides
// multiples of 8, and S a multiple of 128.  Returns a cudaError_t (0 on
// success), or hopper::kTensorMapError + a CUresult when the driver refuses a
// tensor map.  Launches on `stream`, does not synchronise and allocates
// nothing.
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
    return launch_wgmma<64>(q, k, v, o, l, B, H, S, qs, ks, vs, scale, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, o, l, B, H, S, qs, ks, vs, scale, st);
  if (dtype == 0 && D == 64)
    return launch_f32(flash_fwd_f32_kernel<64>, f32_smem_bytes<64>(), q, k, v,
                      o, l, B, H, S, qs, ks, vs, scale, st);
  if (dtype == 0 && D == 128)
    return launch_f32(flash_fwd_f32_kernel<128>, f32_smem_bytes<128>(), q, k,
                      v, o, l, B, H, S, qs, ks, vs, scale, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a launch of the kernel for (D, dtype) asks for.
extern "C" int flash_attention_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 1) return D == 64 ? (int)Fwd<64>::kSmem : (int)Fwd<128>::kSmem;
  return D == 64 ? (int)f32_smem_bytes<64>() : (int)f32_smem_bytes<128>();
}
