// Causal flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of `_bwd` in
// ray_tpu/ops/flash_attention.py:
//   - `_dq_kernel`  -> flash_attention_bwd_dq:  dq = sum_kv ds k
//   - `_dkv_kernel` -> flash_attention_bwd_dkv: dv = sum_q p^T do,
//                                               dk = sum_q ds^T q
// with, for each (q row i, kv column j) on or below the diagonal,
//   p  = exp(s - lse_i),  s = (q_i . k_j) * scale
//   dp = do_i . v_j                          (f32)
//   ds = p (dp - delta_i) * scale,  delta = rowsum(do * o) (computed outside)
// Entries above the diagonal have p = 0 (the reference masks s at -1e30).
// Roundings are the reference's: p is rounded to do's dtype before p^T do and
// ds to q's/k's dtype before ds k and ds^T q; every sum is f32.
//
// What bounds them on an H100: at the GPT-2 shape (B=8, H=12, S=1024, D=64,
// bf16) the dq pass does 3 causal products (~19.3 GFLOP, ~20 us at the bf16
// tensor-core peak) and moves ~64 MB (~19 us at 3.35 TB/s); the dk/dv pass
// does 4 products (~25.8 GFLOP, ~26 us) and moves ~76 MB (~23 us): both are
// bound by operations on paper, with the bytes close behind.  The recomputed
// p and ds never leave the registers, and each output is written once.
//
// Design (not the TPU's): the TPU walks one grid axis in order and adds each
// block's contribution into an output held in the inputs' dtype, so bf16
// rounds between blocks.  Here a block owns its output tile and loops over the
// other axis itself, keeping the sums in f32 registers and rounding once at
// the store; blocks run in any order, and with no atomics two runs give the
// same bits.  The split into a dq pass and a dk/dv pass is the reference's.
//   - dk/dv, bf16 (`flash_dkv_wgmma_kernel`): persistent, one block per SM,
//     each walking its share of the (b, h, 128-row kv tile)s, heaviest (kv
//     tile 0) first in a snake order.  Three warpgroups.  Warpgroup 0 is the
//     producer: one thread loads each kv tile's k and v once by TMA
//     (csrc/hopper.cuh), then streams the q and do tiles (64 rows at D = 64,
//     32 at D = 128) with their lse and delta rows, from the diagonal to the
//     end, through a ring of 3 stages tracked by full and empty mbarriers;
//     the next kv tile's k and v load as soon as the last q tile's scores
//     are done.  Warpgroups 1 and 2 own 64 kv rows each: s^T = k q^T and
//     dp^T = v do^T are SS wgmmas with q and do as K-major B operands, so
//     p^T and ds^T come out of the accumulators in the A-register layout and
//     feed dv += p^T do and dk += ds^T q, rounded to bf16, as RS wgmmas that
//     read do and q from their row-major tiles with the transpose flag.
//     p = exp2(s scale log2(e) - lse log2(e)), one FMA before ex2.approx; the
//     causal compare runs only on the q tiles that reach below a
//     warpgroup's diagonal, and tiles wholly above it are skipped.  The two
//     warpgroups take turns (named barriers) to issue their products, so
//     one's exp2 and ds run while the other's products run (FA3's
//     ping-pong).  dk and dv stay in f32 registers; setmaxnreg gives the
//     producer 40 registers and the consumers 232.
//   - dq, bf16 (`flash_dq_mma_kernel`): one block per (b, h, 64-row q tile),
//     heaviest tile first, looping over kv tiles up to the diagonal on
//     mma.sync m16n8k16 with one tile in flight; kT as the B operand of ds k
//     is read with ldmatrix.trans from the row-major k tile.  Its Hopper
//     redesign is the next step.
// q, k, v and do are addressed through (batch, head, seq) strides with a unit
// stride along D (through 4-D tensor maps in the wgmma kernel); lse, delta and
// the outputs are contiguous.  float32 (the reference tests' type) runs the
// same tilings on the CUDA cores (64-row tiles; the dk/dv pass takes 32-row q
// tiles at D = 128), with p and ds staged in shared memory and never rounded.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlock = 64;  // q rows of a dq block, kv rows of an f32 dk/dv block
constexpr int kThreads = 128;

struct Strides {
  int64_t b, h, s;
};

// q tile rows of the f32 dk/dv pass
template <int D>
__host__ __device__ constexpr int dkv_block_q() {
  return D == 64 ? 64 : 32;
}

// ---------------------------------------------------------------------------
// bf16 dq: mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

using hopper::pack_bf16;

// d += a b, one 16x8x16 tile: a row-major 16x16 bf16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 x 16) whose thread-owned element pair starts at
// tile[row][col] (row = 16-row base + g, col = 16-column base + 2 t4).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int row, int col) {
  const bf16* p = tile + row * ld + col;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragments of d += a B for B = tile[k0 .. k0+15][n0 .. n0+15], a
// row-major [k][n] tile in shared memory: (r[0], r[1]) for columns n0..n0+7,
// (r[2], r[3]) for n0+8..n0+15.  ldmatrix.trans hands each thread the
// column pairs an mma B operand wants.
__device__ __forceinline__ void b_frags_trans(uint32_t (&r)[4],
                                              const bf16* tile, int ld, int k0,
                                              int n0) {
  const int lane = threadIdx.x % 32;
  const bf16* p =
      tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// ROWS rows of D bf16 into dst[row][ld], 16 bytes per thread per step.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld,
                                          const bf16* __restrict__ src,
                                          int64_t row_stride) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // q, do, k, v tiles, rows of D + 8 (so fragment reads hit distinct banks)
  return sizeof(bf16) * (size_t)(4 * kBlock * (D + 8));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int H, int S, Strides qs, Strides ks, Strides vs,
                        Strides dos, float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;      // k-steps of q k^T and do v^T
  constexpr int NS = kBlock / 8;  // 8-column blocks of s (kv)
  constexpr int ND = D / 8;       // 8-column blocks of dq

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kBlock * LD;
  bf16* Ks = dOs + kBlock * LD;
  bf16* Vs = Ks + kBlock * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBlock;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group, column pair
  const int r0 = (threadIdx.x / 32) * 16 + g;  // this thread's rows: r0, r0 + 8
  const int64_t bh = (int64_t)b * H + h;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  load_rows<D, kBlock>(Qs, LD, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s);
  load_rows<D, kBlock>(dOs, LD, dO + b * dos.b + h * dos.h + q0 * dos.s, dos.s);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = lse[bh * S + q0 + r0 + 8 * i];
    delta_r[i] = delta[bh * S + q0 + r0 + 8 * i];
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {  // causal: kv tiles up to the diagonal
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's readers of Ks and Vs are done
    load_rows<D, kBlock>(Ks, LD, kb + k0 * ks.s, ks.s);
    load_rows<D, kBlock>(Vs, LD, vb + k0 * vs.s, vs.s);
    __syncthreads();

    // s = q k^T and dp = do v^T: element e of block n is (row r0 + 8 (e / 2),
    // kv column n * 8 + t4 * 2 + e % 2).
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4], da[4];
      a_frag(qa, Qs, LD, r0, kd * 16 + t4 * 2);
      a_frag(da, dOs, LD, r0, kd * 16 + t4 * 2);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* pk = Ks + (n * 8 + g) * LD + kd * 16 + t4 * 2;
        mma_bf16(s[n], qa, ld32(pk), ld32(pk + 8));
        const bf16* pv = Vs + (n * 8 + g) * LD + kd * 16 + t4 * 2;
        mma_bf16(dp[n], da, ld32(pv), ld32(pv + 8));
      }
    }

    // ds = p (dp - delta) scale, into s
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q_pos = q0 + r0 + 8 * (e / 2);
        const int k_pos = k0 + n * 8 + t4 * 2 + e % 2;
        const float p =
            q_pos >= k_pos ? expf(s[n][e] * scale - lse_r[e / 2]) : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[e / 2]) * scale;
      }

    // dq += ds k: the ds accumulators of blocks 2j and 2j + 1 are, element
    // for element, the A fragment of k-step j; k is B, read transposed.
#pragma unroll
    for (int j = 0; j < kBlock / 16; ++j) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bk[4];
        b_frags_trans(bk, Ks, LD, j * 16, n * 8);
        mma_bf16(acc[n], a, bk[0], bk[1]);
        mma_bf16(acc[n + 1], a, bk[2], bk[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = dq + (bh * S + q0 + r0 + 8 * i) * D + t4 * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dk/dv: TMA ring, wgmma
// ---------------------------------------------------------------------------

template <int D>
struct Dkv {
  static constexpr int kRowsK = 128;              // kv rows of a block
  static constexpr int kConsumers = 2;            // warpgroups of 64 kv rows
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kRowsQ = D == 64 ? 64 : 32;  // q rows of a ring stage
  static constexpr int kStages = 3;
  static constexpr uint32_t kKBytes = kRowsK * D * 2;  // the k or the v tile
  static constexpr uint32_t kQBytes = kRowsQ * D * 2;  // a q or a do tile
  static constexpr uint32_t kRowBytes = kRowsQ * 4;    // its lse or delta
  // bytes that land in one stage
  static constexpr uint32_t kStageTx = 2 * kQBytes + 2 * kRowBytes;
  // k, v; then per stage q, do; then per stage lse, delta; 1024 to align
  static constexpr size_t kSmem =
      2 * (size_t)kKBytes + kStages * (2 * (size_t)kQBytes + 2 * kRowBytes) + 1024;
};

template <int D>
__global__ void __launch_bounds__(Dkv<D>::kThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                           int H, int S, float scale) {
  using namespace hopper;
  using C = Dkv<D>;
  constexpr int BQ = C::kRowsQ, NST = C::kStages, RK = C::kRowsK;
  constexpr uint32_t kBoxK = RK * 128, kBoxQ = BQ * 128;

  __shared__ __align__(8) uint64_t kv_full, kv_empty, full[NST], empty[NST];
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t base = (smem_addr(smem_tiles) + 1023) & ~1023u;
  unsigned char* const sbase = smem_tiles + (base - smem_addr(smem_tiles));
  const uint32_t k_tile = base, v_tile = base + C::kKBytes;
  auto q_tile = [&](int st) { return base + 2 * C::kKBytes + 2 * C::kQBytes * st; };
  auto rows_at = [&](int st) {  // lse of stage st; delta follows it
    return reinterpret_cast<float*>(sbase + 2 * C::kKBytes + 2 * C::kQBytes * NST +
                                    2 * C::kRowBytes * st);
  };
  // Tile t: kv tile t / (B H) of head t % (B H), heaviest (most q tiles) first.
  const int n_tiles = (S / RK) * B * H;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    mbar_init(&kv_empty, 4 * C::kConsumers);  // one arrival a consumer warp
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * C::kConsumers);
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
      tma_prefetch(&domap);
      int it = 0;  // q tiles loaded so far: ring stage it % NST
      for (int r = 0, t; (t = snake_tile(r, n_tiles)) >= 0; ++r) {
        const int k0 = t / (B * H) * RK, bh = t % (B * H), b = bh / H, h = bh % H;
        const int64_t bhS = (int64_t)bh * S;
        mbar_wait(&kv_empty, (r & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full, 2 * C::kKBytes);
        tma_load_rows<D>(k_tile, &kmap, &kv_full, RK, k0, h, b);
        tma_load_rows<D>(v_tile, &vmap, &kv_full, RK, k0, h, b);
        for (int q0 = k0; q0 < S; q0 += BQ, ++it) {  // the diagonal to the end
          const int st = it % NST;
          mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], C::kStageTx);
          tma_load_rows<D>(q_tile(st), &qmap, &full[st], BQ, q0, h, b);
          tma_load_rows<D>(q_tile(st) + C::kQBytes, &domap, &full[st], BQ, q0, h, b);
          const uint32_t rows = smem_addr(rows_at(st));
          bulk_load(rows, lse + bhS + q0, C::kRowBytes, &full[st]);
          bulk_load(rows + C::kRowBytes, delta + bhS + q0, C::kRowBytes, &full[st]);
        }
      }
    }
    return;
  }

  regs_inc<232>();
  const int c = threadIdx.x / 128 - 1;  // consumer warpgroup: kv rows 64c ..
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  const uint32_t k_rows = k_tile + 64 * c * 128, v_rows = v_tile + 64 * c * 128;

  float dk_acc[D / 2], dv_acc[D / 2];
  auto arrive = [&](uint64_t* bar) {  // this warp is done with what bar guards
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Ping-pong (FA3): the two warpgroups take turns to issue their products,
  // so one's exp2 and ds run while the other's products hold the tensor
  // cores.  Each takes two turns a q tile, skipped or not, so they stay paired.
  auto turn_take = [&] { named_sync(1 + c, 256); };
  auto turn_give = [&] { named_arrive(2 - c, 256); };
  if (c == 1) named_arrive(1, 256);  // warpgroup 0 goes first

  int it = 0;  // q tiles consumed so far: ring stage it % NST
  for (int r = 0, t; (t = snake_tile(r, n_tiles)) >= 0; ++r) {
    const int k0 = t / (B * H) * RK;
    const int kr0 = k0 + 64 * c;      // this warpgroup's first kv row
    const int kr = kr0 + 16 * w + g;  // this thread's kv rows: kr, kr + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(&kv_full, r & 1);
    for (int q0 = k0; q0 < S; q0 += BQ, ++it) {
      const int st = it % NST;
      mbar_wait(&full[st], (it / NST) & 1);
      const bool last = q0 + BQ == S;  // k and v are read by no later product
      // A q tile wholly above this warpgroup's diagonal adds nothing.
      if (q0 + BQ <= kr0) {
        turn_take();
        turn_give();
        turn_take();
        turn_give();
        arrive(&empty[st]);
        continue;
      }
      const uint32_t qs = q_tile(st), dos = qs + C::kQBytes;
      // s^T = k q^T and dp^T = v do^T: element (kv row g or g + 8, q column
      // 8 j + 2 t4 + {0, 1}) is s[4 j + {0, 1}] or s[4 j + {2, 3}].
      float s[BQ / 2], dp[BQ / 2];
      turn_take();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss<BQ, 0>(s, desc_k_major(k_rows, kBoxK, kk), desc_k_major(qs, kBoxQ, kk), kk > 0);
        wgmma_ss<BQ, 0>(dp, desc_k_major(v_rows, kBoxK, kk), desc_k_major(dos, kBoxQ, kk), kk > 0);
      }
      wgmma_commit();
      turn_give();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (last) arrive(&kv_empty);

      // p^T into s, ds^T into dp; the causal compare only where the q tile
      // reaches below this warpgroup's diagonal.
      const float* lse_s = rows_at(st);
      const float* delta_s = lse_s + BQ;
      const bool diagonal = q0 < kr0 + 64;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int qc = 8 * j + 2 * t4;
        const float2 L = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 Dl = *reinterpret_cast<const float2*>(delta_s + qc);
        const float nl[2] = {-L.x * 1.4426950408889634f, -L.y * 1.4426950408889634f};
        const float dl[2] = {Dl.x, Dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(s[4 * j + e], sl2, nl[e & 1]));
          if (diagonal && q0 + qc + (e & 1) < kr + 8 * (e >> 1)) p = 0.f;
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - dl[e & 1]) * scale;
        }
      }

      // dv += p^T do and dk += ds^T q, with do and q read MN-major.
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      acc_to_a<BQ>(pa, s);
      acc_to_a<BQ>(da, dp);
      turn_take();
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        wgmma_rs<D, 1>(dv_acc, pa[j], desc_mn_major(dos, kBoxQ, j), 1);
        wgmma_rs<D, 1>(dk_acc, da[j], desc_mn_major(qs, kBoxQ, j), 1);
      }
      wgmma_commit();
      turn_give();
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(da);
      arrive(&empty[st]);
    }

    const int64_t off0 = ((int64_t)(t % (B * H)) * S + kr) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t off = off0 + 8 * i * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
            pack_bf16(dk_acc[4 * j + 2 * i], dk_acc[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack_bf16(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
// Thread (tr, tc) = (tid / 16, tid % 16) owns the block's rows 8 tr .. 8 tr + 7,
// the columns tc + 16 j of each score tile and the columns tc + 16 c of its
// output rows.

constexpr int kRowsPerThread = kBlock / (kThreads / 16);  // 8

template <int D, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int64_t row_stride) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] = src[r * row_stride + c];
  }
}

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  // q, do, k, v tiles (rows of D + 1) and the ds tile (rows of kBlock + 1)
  return sizeof(float) *
         (size_t)(4 * kBlock * (D + 1) + kBlock * (kBlock + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int H, int S, Strides qs, Strides ks, Strides vs,
                        Strides dos, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDS = kBlock + 1;
  constexpr int NC = kBlock / 16;  // score columns per thread
  constexpr int DC = D / 16;       // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlock * LD;
  float* Ks = dOs + kBlock * LD;
  float* Vs = Ks + kBlock * LD;
  float* dSs = Vs + kBlock * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBlock;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int row0 = tr * kRowsPerThread;
  const int64_t bh = (int64_t)b * H + h;

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  load_tile_f32<D, kBlock>(Qs, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s);
  load_tile_f32<D, kBlock>(dOs, dO + b * dos.b + h * dos.h + q0 * dos.s, dos.s);
  float lse_r[kRowsPerThread], delta_r[kRowsPerThread];
  float acc[kRowsPerThread][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    lse_r[i] = lse[bh * S + q0 + row0 + i];
    delta_r[i] = delta[bh * S + q0 + row0 + i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's readers of Ks, Vs, dSs are done
    load_tile_f32<D, kBlock>(Ks, kb + k0 * ks.s, ks.s);
    load_tile_f32<D, kBlock>(Vs, vb + k0 * vs.s, vs.s);
    __syncthreads();

    float s[kRowsPerThread][NC], dp[kRowsPerThread][NC];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[NC], vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        kv[j] = Ks[(tc + 16 * j) * LD + d];
        vv[j] = Vs[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float qv = Qs[(row0 + i) * LD + d];
        const float ov = dOs[(row0 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          s[i][j] = fmaf(qv, kv[j], s[i][j]);
          dp[i][j] = fmaf(ov, vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kc = tc + 16 * j;
        const float p =
            q0 + row0 + i >= k0 + kc ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(row0 + i) * LDS + kc] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    __syncthreads();  // the whole ds tile is in shared memory

#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float kk[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kk[c] = Ks[j * LD + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float ds = dSs[(row0 + i) * LDS + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kk[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    float* row = dq + (bh * S + q0 + row0 + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tc + 16 * c] = acc[i][c];
  }
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  constexpr int BQ = dkv_block_q<D>();
  // k, v tiles (kBlock rows of D + 1), q, do tiles (BQ rows of D + 1), the p
  // and ds tiles (kBlock rows of BQ + 1), lse and delta of the q tile
  return sizeof(float) * (size_t)(2 * kBlock * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * kBlock * (BQ + 1) + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dO,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H,
                         int S, Strides qs, Strides ks, Strides vs, Strides dos,
                         float scale) {
  constexpr int BQ = dkv_block_q<D>();
  constexpr int LD = D + 1;
  constexpr int LDP = BQ + 1;
  constexpr int NC = BQ / 16;  // score columns (q) per thread
  constexpr int DC = D / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + kBlock * LDP;
  float* Ls = dSs + kBlock * LDP;
  float* Ds = Ls + BQ;

  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int row0 = tr * kRowsPerThread;  // first kv row of this thread
  const int64_t bh = (int64_t)b * H + h;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dO + b * dos.b + h * dos.h;
  load_tile_f32<D, kBlock>(Ks, k + b * ks.b + h * ks.h + k0 * ks.s, ks.s);
  load_tile_f32<D, kBlock>(Vs, v + b * vs.b + h * vs.h + k0 * vs.s, vs.s);

  float dk_acc[kRowsPerThread][DC], dv_acc[kRowsPerThread][DC];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = k0; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile_f32<D, BQ>(Qs, qb + q0 * qs.s, qs.s);
    load_tile_f32<D, BQ>(dOs, dob + q0 * dos.s, dos.s);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      Ls[i] = lse[bh * S + q0 + i];
      Ds[i] = delta[bh * S + q0 + i];
    }
    __syncthreads();

    float s[kRowsPerThread][NC], dp[kRowsPerThread][NC];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[NC], ov[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        qv[j] = Qs[(tc + 16 * j) * LD + d];
        ov[j] = dOs[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float kk = Ks[(row0 + i) * LD + d];
        const float vv = Vs[(row0 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          s[i][j] = fmaf(kk, qv[j], s[i][j]);
          dp[i][j] = fmaf(vv, ov[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int qc = tc + 16 * j;
        const float p =
            q0 + qc >= k0 + row0 + i ? expf(s[i][j] * scale - Ls[qc]) : 0.f;
        Ps[(row0 + i) * LDP + qc] = p;
        dSs[(row0 + i) * LDP + qc] = p * (dp[i][j] - Ds[qc]) * scale;
      }
    __syncthreads();  // the whole p and ds tiles are in shared memory

#pragma unroll 4
    for (int j = 0; j < BQ; ++j) {
      float ov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        ov[c] = dOs[j * LD + tc + 16 * c];
        qv[c] = Qs[j * LD + tc + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float p = Ps[(row0 + i) * LDP + j];
        const float ds = dSs[(row0 + i) * LDP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(p, ov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t off = (bh * S + k0 + row0 + i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tc + 16 * c] = dk_acc[i][c];
      dv[off + tc + 16 * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  int B, H, S;
  Strides qs, ks, vs, dos;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename Kernel>
cudaError_t launch_dq(Kernel kernel, size_t smem, const Args& a, void* dq) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kBlock, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dO), a.lse, a.delta,
      static_cast<T*>(dq), a.H, a.S, a.qs, a.ks, a.vs, a.dos, a.scale);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch_dkv_f32(Kernel kernel, size_t smem, const Args& a, void* dk,
                           void* dv) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kBlock, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse,
      a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.S,
      a.qs, a.ks, a.vs, a.dos, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  using C = Dkv<D>;
  if (a.S % C::kRowsK != 0) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom;
  int err = hopper::make_map(&qm, a.q, a.B, a.H, a.S, D, a.qs.b, a.qs.h, a.qs.s, C::kRowsQ);
  if (!err) err = hopper::make_map(&km, a.k, a.B, a.H, a.S, D, a.ks.b, a.ks.h, a.ks.s, C::kRowsK);
  if (!err) err = hopper::make_map(&vm, a.v, a.B, a.H, a.S, D, a.vs.b, a.vs.h, a.vs.s, C::kRowsK);
  if (!err) err = hopper::make_map(&dom, a.dO, a.B, a.H, a.S, D, a.dos.b, a.dos.h, a.dos.s, C::kRowsQ);
  if (err) return static_cast<cudaError_t>(err);
  auto kernel = flash_dkv_wgmma_kernel<D>;
  cudaError_t e = prepare(kernel, C::kSmem);
  if (e != cudaSuccess) return e;
  int device, sms;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  const int n_tiles = a.B * a.H * (a.S / C::kRowsK);
  // One block per SM (at most), each walking its share of the tiles.
  kernel<<<n_tiles < sms ? n_tiles : sms, C::kThreads, C::kSmem, a.stream>>>(
      qm, km, vm, dom, a.lse, a.delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a.B, a.H, a.S, a.scale);
  return cudaGetLastError();
}

bool valid(int B, int H, int S) {
  return B > 0 && H > 0 && S > 0 && S % kBlock == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, do: (B, H, S, D) addressed
// through (batch, head, seq) strides in elements, D's stride 1; lse and delta:
// contiguous (B, H, S) float32; outputs contiguous (B, H, S, D) in the
// inputs' dtype.  The bf16 kernels read rows 16 bytes at a time: pointers
// 16-byte aligned and strides multiples of 8.  Each returns a cudaError_t (0
// on success), launches on `stream`, does not synchronise and allocates
// nothing.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* delta, void* dq, int B, int H, int S, int D,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,
    int64_t do_sh, int64_t do_ss, float scale, int dtype, void* stream) {
  if (!valid(B, H, S)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dO,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, H, S,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {do_sb, do_sh, do_ss}, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 1 && D == 64)
    return launch_dq<bf16>(flash_dq_mma_kernel<64>, dq_mma_smem_bytes<64>(), a, dq);
  if (dtype == 1 && D == 128)
    return launch_dq<bf16>(flash_dq_mma_kernel<128>, dq_mma_smem_bytes<128>(), a, dq);
  if (dtype == 0 && D == 64)
    return launch_dq<float>(flash_dq_f32_kernel<64>, dq_f32_smem_bytes<64>(), a, dq);
  if (dtype == 0 && D == 128)
    return launch_dq<float>(flash_dq_f32_kernel<128>, dq_f32_smem_bytes<128>(), a, dq);
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int S, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t do_sb, int64_t do_sh, int64_t do_ss, float scale, int dtype,
    void* stream) {
  if (!valid(B, H, S)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dO,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, H, S,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {do_sb, do_sh, do_ss}, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 1 && D == 64) return launch_dkv_wgmma<64>(a, dk, dv);
  if (dtype == 1 && D == 128) return launch_dkv_wgmma<128>(a, dk, dv);
  if (dtype == 0 && D == 64)
    return launch_dkv_f32(flash_dkv_f32_kernel<64>, dkv_f32_smem_bytes<64>(), a, dk, dv);
  if (dtype == 0 && D == 128)
    return launch_dkv_f32(flash_dkv_f32_kernel<128>, dkv_f32_smem_bytes<128>(), a, dk, dv);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a launch of the dk/dv kernel for (D, dtype) asks for.
extern "C" int flash_attention_bwd_dkv_smem_bytes(int D, int dtype) {
  if (dtype == 1) return D == 64 ? (int)Dkv<64>::kSmem : (int)Dkv<128>::kSmem;
  return D == 64 ? (int)dkv_f32_smem_bytes<64>() : (int)dkv_f32_smem_bytes<128>();
}
