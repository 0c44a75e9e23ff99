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
// bf16) the dq pass does 3 causal products (~19.35 GFLOP, ~19.6 us at the
// bf16 tensor-core peak) and moves ~64 MB (~19 us at 3.35 TB/s); the dk/dv
// pass does 4 products (~25.8 GFLOP, ~26 us) and moves ~76 MB (~23 us): both
// are bound by operations on paper, with the bytes close behind.  The
// recomputed p and ds never leave the registers, and each output is written
// once.
//
// Design (not the TPU's): the TPU walks one grid axis in order and adds each
// block's contribution into an output held in the inputs' dtype, so bf16
// rounds between blocks.  Here a block owns its output tile and loops over the
// other axis itself, keeping the sums in f32 registers and rounding once at
// the store; blocks run in any order, and with no atomics two runs give the
// same bits.  The split into a dq pass and a dk/dv pass is the reference's.
// Both bf16 kernels share one shape (csrc/hopper.cuh: TMA, mbarriers, wgmma):
// persistent, one 384-thread block per SM walking its share of the output
// tiles, heaviest first in a snake order.  Warpgroup 0 is the producer: one
// thread loads the output tile's own operands once by TMA, with their own
// full/empty mbarrier pair, then streams the other axis's tiles through a
// ring of stages tracked by full and empty mbarriers; setmaxnreg moves its
// registers to the two consumer warpgroups.  p = exp2(s scale log2(e) - lse
// log2(e)), one FMA before ex2.approx; the causal compare runs only on the
// tiles that reach a warpgroup's diagonal, and tiles wholly beyond it are
// skipped.  The two consumers take turns (named barriers) to issue their
// products, so one's exp2 and ds run while the other's products run (FA3's
// ping-pong); a consumer that skips a tile still takes and gives its turns.
//   - dk/dv (`flash_dkv_wgmma_kernel`): 128-row kv tiles, heaviest is kv tile
//     0.  Each kv tile's k and v load once; the q and do tiles (64 rows at
//     D = 64, 32 at D = 128) with their lse and delta rows stream from the
//     diagonal to the end, 3 stages deep; 40 registers for the producer, 232
//     for the consumers.  Consumers own 64 kv rows each: s^T = k q^T and
//     dp^T = v do^T are SS wgmmas with q and do as K-major B operands, so
//     p^T and ds^T come out of the accumulators in the A-register layout and
//     feed dv += p^T do and dk += ds^T q, rounded to bf16, as RS wgmmas that
//     read do and q from their row-major tiles with the transpose flag.
//   - dq (`flash_dq_wgmma_kernel`): 128-row q tiles, heaviest is the last q
//     tile.  Each q tile's q and do load once, with its lse and delta rows
//     (which the consumers keep in registers), into one of two buffers at
//     D = 64 (one at D = 128, where shared memory has no room for two), so
//     the next q tile loads while the last one's final products run; the k
//     and v tiles (128 rows at D = 64, 64 at D = 128) stream from kv tile 0
//     to the diagonal, 4 stages deep.  24 registers for the producer, 240
//     for the consumers: at 232 ptxas spilled at D = 64.
//     Consumers own 64 q rows each: s = q k^T and dp = do v^T are SS wgmmas
//     with k and v as K-major B operands; ds comes out of the accumulators in
//     the A-register layout and feeds dq += ds k, rounded to bf16, as an RS
//     wgmma that reads the same k tile MN-major (transpose flag), so a ring
//     stage is released only once that product has retired.  Within a
//     consumer, ds of kv tile j is computed while ds k of tile j - 1 runs
//     (FA3's intra-warpgroup overlap), its A fragments waiting in registers.
//     At D = 64 the diagonal kv tile is computed whole by both consumers:
//     the products do ~12% more than the causal triangle needs.
// q, k, v and do are addressed through (batch, head, seq) strides with a unit
// stride along D (through 4-D tensor maps in the wgmma kernels); lse, delta
// and the outputs are contiguous.  float32 (the reference tests' type) runs
// one block per 64-row tile on the CUDA cores (the dk/dv pass takes 32-row q
// tiles at D = 128), with p and ds staged in shared memory and never rounded.

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlock = 64;  // tile rows of the f32 kernels (q for dq, kv for dk/dv)
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
// bf16 dq: TMA ring, wgmma
// ---------------------------------------------------------------------------

template <int D>
struct Dq {
  static constexpr int kRowsQ = 128;                // q rows of a block
  static constexpr int kConsumers = 2;              // warpgroups of 64 q rows
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kRowsK = D == 64 ? 128 : 64;  // kv rows of a ring stage
  static constexpr int kStages = 4;
  // q tiles in flight: two where shared memory has room for them, so the
  // next q tile loads while the last one's final products run.
  static constexpr int kQBufs = D == 64 ? 2 : 1;
  static constexpr uint32_t kQBytes = kRowsQ * D * 2;  // the q or the do tile
  static constexpr uint32_t kKBytes = kRowsK * D * 2;  // a k or a v tile
  static constexpr uint32_t kRowBytes = kRowsQ * 4;    // lse or delta of the q tile
  // bytes that land with a q tile
  static constexpr uint32_t kQTx = 2 * kQBytes + 2 * kRowBytes;
  // per q buffer q, do; then per stage k, v; then per q buffer lse, delta;
  // 1024 to align
  static constexpr size_t kSmem = kQBufs * (2 * (size_t)kQBytes + 2 * kRowBytes) +
                                  kStages * 2 * (size_t)kKBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int B, int H, int S, float scale) {
  using namespace hopper;
  using C = Dq<D>;
  constexpr int RQ = C::kRowsQ, RK = C::kRowsK, NST = C::kStages, NQB = C::kQBufs;
  constexpr uint32_t kBoxQ = RQ * 128, kBoxK = RK * 128;

  __shared__ __align__(8) uint64_t q_full[NQB], q_empty[NQB], kv_full[NST], kv_empty[NST];
  extern __shared__ __align__(1024) unsigned char smem_tiles[];
  const uint32_t base = (smem_addr(smem_tiles) + 1023) & ~1023u;
  unsigned char* const sbase = smem_tiles + (base - smem_addr(smem_tiles));
  // q buffer qb holds the q tile (do follows it) of q tiles r with r % NQB == qb
  auto q_tile = [&](int qb) { return base + 2 * C::kQBytes * qb; };
  auto k_tile = [&](int st) { return base + 2 * C::kQBytes * NQB + 2 * C::kKBytes * st; };
  auto lse_at = [&](int qb) {  // lse of q buffer qb; delta follows it
    return reinterpret_cast<const float*>(sbase + 2 * C::kQBytes * NQB + 2 * C::kKBytes * NST +
                                          2 * C::kRowBytes * qb);
  };
  // Tile t: q tile S / RQ - 1 - t / (B H) of head t % (B H), heaviest (most
  // kv tiles) first.
  const int n_tiles = (S / RQ) * B * H, n_qt = S / RQ;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < NQB; ++qb) {
      mbar_init(&q_full[qb], 1);
      mbar_init(&q_empty[qb], 4 * C::kConsumers);  // one arrival a consumer warp
    }
    for (int st = 0; st < NST; ++st) {
      mbar_init(&kv_full[st], 1);
      mbar_init(&kv_empty[st], 4 * C::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<24>();
    if (threadIdx.x == 0) {
      tma_prefetch(&qmap);
      tma_prefetch(&kmap);
      tma_prefetch(&vmap);
      tma_prefetch(&domap);
      int it = 0;  // kv tiles loaded so far: ring stage it % NST
      for (int r = 0, t; (t = snake_tile(r, n_tiles)) >= 0; ++r) {
        const int q0 = (n_qt - 1 - t / (B * H)) * RQ, bh = t % (B * H), b = bh / H,
                  h = bh % H, qb = r % NQB;
        const int64_t bhS = (int64_t)bh * S;
        mbar_wait(&q_empty[qb], ((r / NQB) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], C::kQTx);
        tma_load_rows<D>(q_tile(qb), &qmap, &q_full[qb], RQ, q0, h, b);
        tma_load_rows<D>(q_tile(qb) + C::kQBytes, &domap, &q_full[qb], RQ, q0, h, b);
        const uint32_t rows = smem_addr(lse_at(qb));
        bulk_load(rows, lse + bhS + q0, C::kRowBytes, &q_full[qb]);
        bulk_load(rows + C::kRowBytes, delta + bhS + q0, C::kRowBytes, &q_full[qb]);
        for (int k0 = 0; k0 < q0 + RQ; k0 += RK, ++it) {  // up to the diagonal
          const int st = it % NST;
          mbar_wait(&kv_empty[st], ((it / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&kv_full[st], 2 * C::kKBytes);
          tma_load_rows<D>(k_tile(st), &kmap, &kv_full[st], RK, k0, h, b);
          tma_load_rows<D>(k_tile(st) + C::kKBytes, &vmap, &kv_full[st], RK, k0, h, b);
        }
      }
    }
    return;
  }

  regs_inc<240>();
  const int c = threadIdx.x / 128 - 1;  // consumer warpgroup: q rows 64c ..
  const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int lr = 64 * c + 16 * w + g;  // this thread's rows of the tile: lr, lr + 8
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  uint32_t q_rows, do_rows;  // this warpgroup's rows of the q and do tiles

  float dq_acc[D / 2];
  // s = q k^T and dp = do v^T of one kv tile: element (row g or g + 8,
  // kv column 8 j + 2 t4 + {0, 1}) of this warp's 16 rows is s[4 j + {0, 1}]
  // or s[4 j + {2, 3}].
  float s[RK / 2], dp[RK / 2];
  uint32_t da[RK / 16][4];  // the previous kv tile's ds, as A fragments
  float nl[2], dl[2];       // -lse log2(e) and delta of rows lr, lr + 8

  auto issue_sdp = [&](int it) {  // s = q k^T, dp = do v^T of stage it % NST
    const uint32_t kt = k_tile(it % NST), vt = kt + C::kKBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<RK, 0>(s, desc_k_major(q_rows, kBoxQ, kk), desc_k_major(kt, kBoxK, kk), kk > 0);
      wgmma_ss<RK, 0>(dp, desc_k_major(do_rows, kBoxQ, kk), desc_k_major(vt, kBoxK, kk), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_dq = [&](int it) {  // dq += ds k, k of stage it % NST read MN-major
    const uint32_t kt = k_tile(it % NST);
#pragma unroll
    for (int j = 0; j < RK / 16; ++j)
      wgmma_rs<D, 1>(dq_acc, da[j], desc_mn_major(kt, kBoxK, j), 1);
    wgmma_commit();
  };
  // ds = p (dp - delta) scale into s, p = exp2(s scale log2(e) - lse log2(e)),
  // one FMA before ex2.approx; the causal compare, on a diagonal tile only,
  // takes `rel`, this thread's first q row less the kv tile's first row.
  auto grad = [&](bool diagonal, int rel) {
#pragma unroll
    for (int j = 0; j < RK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(s[4 * j + e], sl2, nl[e >> 1]));
        if (diagonal && 8 * j + 2 * t4 + (e & 1) > rel + 8 * (e >> 1)) p = 0.f;
        s[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]) * scale;
      }
  };
  auto arrive = [&](uint64_t* bar) {  // this warp is done with what bar guards
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // Ping-pong (FA3): the two warpgroups take turns to issue their products,
  // so one's exp2 and ds run while the other's products hold the tensor
  // cores.  Each takes one turn a kv tile and one more a q tile, skipped
  // tiles included, so the turns stay paired.
  auto turn_take = [&] { named_sync(1 + c, 256); };
  auto turn_give = [&] { named_arrive(2 - c, 256); };
  if (c == 1) named_arrive(1, 256);  // warpgroup 0 goes first

  int it = 0;  // kv tiles consumed so far: ring stage it % NST
  for (int r = 0, t; (t = snake_tile(r, n_tiles)) >= 0; ++r) {
    const int q0 = (n_qt - 1 - t / (B * H)) * RQ, qb = r % NQB;
    const int qr0 = q0 + 64 * c;  // this warpgroup's first q row
    // kv tiles 0 .. n_kt - 1 reach the tile's diagonal; this warpgroup's
    // rows see the first n_mine of them, the rest lie wholly above its rows.
    const int n_kt = (q0 + RQ) / RK, n_mine = (qr0 + 64 + RK - 1) / RK;
    const int qr = qr0 + 16 * w + g;  // this thread's q rows: qr, qr + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(&q_full[qb], (r / NQB) & 1);
    q_rows = q_tile(qb) + 64 * c * 128;
    do_rows = q_rows + C::kQBytes;
    const float* const lse_s = lse_at(qb);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      nl[i] = -lse_s[lr + 8 * i] * 1.4426950408889634f;
      dl[i] = lse_s[RQ + lr + 8 * i];
    }

    // Software pipeline (FA3's intra-warpgroup overlap): while dq += ds k of
    // kv tile kt - 1 runs on the tensor cores, ds of tile kt is computed on
    // the CUDA cores; ds of tile kt - 1 waits in da as bf16 A fragments.
    mbar_wait(&kv_full[it % NST], (it / NST) & 1);
    turn_take();
    wgmma_fence();
    issue_sdp(it);
    turn_give();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (n_mine == 1) arrive(&q_empty[qb]);  // q and do are read by no later product
    grad(RK - 1 > qr0, qr);
    acc_to_a<RK>(da, s);
    for (int kt = 1; kt < n_mine; ++kt, ++it) {
      const int k0 = kt * RK;
      mbar_wait(&kv_full[(it + 1) % NST], ((it + 1) / NST) & 1);
      turn_take();
      wgmma_fence();
      issue_sdp(it + 1);
      issue_dq(it);
      turn_give();
      wgmma_wait<1>();  // s and dp of tile kt have landed; ds k of tile kt - 1 may run on
      fence_regs(s);
      fence_regs(dp);
      if (kt == n_mine - 1) arrive(&q_empty[qb]);
      grad(k0 + RK - 1 > qr0, qr - k0);
      wgmma_wait<0>();
      fence_regs(dq_acc);
      fence_regs(da);
      arrive(&kv_empty[it % NST]);  // k is read by no later product
      acc_to_a<RK>(da, s);
    }
    turn_take();
    wgmma_fence();
    issue_dq(it);
    turn_give();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(da);
    arrive(&kv_empty[it % NST]);
    ++it;
    // A kv tile wholly above this warpgroup's rows adds nothing, but its
    // turn is still taken and given.
    for (int kt = n_mine; kt < n_kt; ++kt, ++it) {
      mbar_wait(&kv_full[it % NST], (it / NST) & 1);
      turn_take();
      turn_give();
      arrive(&kv_empty[it % NST]);
    }

    const int64_t off0 = ((int64_t)(t % (B * H)) * S + qr) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t off = off0 + 8 * i * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dq + off + 8 * j) =
            pack_bf16(dq_acc[4 * j + 2 * i], dq_acc[4 * j + 2 * i + 1]);
    }
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

template <typename Kernel>
cudaError_t launch_dq_f32(Kernel kernel, size_t smem, const Args& a, void* dq) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / kBlock, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse,
      a.delta, static_cast<float*>(dq), a.H, a.S, a.qs, a.ks, a.vs, a.dos, a.scale);
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

// A persistent bf16 wgmma kernel with config C (Dq<D> or Dkv<D>): the
// tensor maps of q and do (boxes of C::kRowsQ rows) and of k and v
// (C::kRowsK), then one block per SM (at most), each walking its share of
// the B H S / `rows` output tiles.  Returns the first map's error code the
// driver refuses, or the launch's cudaError_t.
template <typename C, typename Kernel, typename... Out>
cudaError_t launch_wgmma(Kernel kernel, int D, int rows, const Args& a, Out*... out) {
  if (a.S % C::kRowsQ != 0 || a.S % C::kRowsK != 0) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dom;
  int err = hopper::make_map(&qm, a.q, a.B, a.H, a.S, D, a.qs.b, a.qs.h, a.qs.s, C::kRowsQ);
  if (!err) err = hopper::make_map(&km, a.k, a.B, a.H, a.S, D, a.ks.b, a.ks.h, a.ks.s, C::kRowsK);
  if (!err) err = hopper::make_map(&vm, a.v, a.B, a.H, a.S, D, a.vs.b, a.vs.h, a.vs.s, C::kRowsK);
  if (!err) err = hopper::make_map(&dom, a.dO, a.B, a.H, a.S, D, a.dos.b, a.dos.h, a.dos.s, C::kRowsQ);
  if (err) return static_cast<cudaError_t>(err);
  cudaError_t e = prepare(kernel, C::kSmem);
  if (e != cudaSuccess) return e;
  int device, sms;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  const int n_tiles = a.B * a.H * (a.S / rows);
  kernel<<<n_tiles < sms ? n_tiles : sms, C::kThreads, C::kSmem, a.stream>>>(
      qm, km, vm, dom, a.lse, a.delta, static_cast<bf16*>(out)..., a.B, a.H, a.S, a.scale);
  return cudaGetLastError();
}

// The shapes every kernel here takes; each wgmma launcher also checks that
// S is a multiple of its own tiles (the f32 kernels tile by kBlock).
bool valid(int B, int H, int S) {
  return B > 0 && H > 0 && S > 0 && S % kBlock == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, do: (B, H, S, D) addressed
// through (batch, head, seq) strides in elements, D's stride 1; lse and delta:
// contiguous (B, H, S) float32; outputs contiguous (B, H, S, D) in the
// inputs' dtype.  The bf16 kernels read q, k, v and do through TMA: pointers
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
    return launch_wgmma<Dq<64>>(flash_dq_wgmma_kernel<64>, 64, Dq<64>::kRowsQ, a, dq);
  if (dtype == 1 && D == 128)
    return launch_wgmma<Dq<128>>(flash_dq_wgmma_kernel<128>, 128, Dq<128>::kRowsQ, a, dq);
  if (dtype == 0 && D == 64)
    return launch_dq_f32(flash_dq_f32_kernel<64>, dq_f32_smem_bytes<64>(), a, dq);
  if (dtype == 0 && D == 128)
    return launch_dq_f32(flash_dq_f32_kernel<128>, dq_f32_smem_bytes<128>(), a, dq);
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
  if (dtype == 1 && D == 64)
    return launch_wgmma<Dkv<64>>(flash_dkv_wgmma_kernel<64>, 64, Dkv<64>::kRowsK, a, dk, dv);
  if (dtype == 1 && D == 128)
    return launch_wgmma<Dkv<128>>(flash_dkv_wgmma_kernel<128>, 128, Dkv<128>::kRowsK, a, dk, dv);
  if (dtype == 0 && D == 64)
    return launch_dkv_f32(flash_dkv_f32_kernel<64>, dkv_f32_smem_bytes<64>(), a, dk, dv);
  if (dtype == 0 && D == 128)
    return launch_dkv_f32(flash_dkv_f32_kernel<128>, dkv_f32_smem_bytes<128>(), a, dk, dv);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory a launch of the dq kernel for (D, dtype) asks for.
extern "C" int flash_attention_bwd_dq_smem_bytes(int D, int dtype) {
  if (dtype == 1) return D == 64 ? (int)Dq<64>::kSmem : (int)Dq<128>::kSmem;
  return D == 64 ? (int)dq_f32_smem_bytes<64>() : (int)dq_f32_smem_bytes<128>();
}

// Dynamic shared memory a launch of the dk/dv kernel for (D, dtype) asks for.
extern "C" int flash_attention_bwd_dkv_smem_bytes(int D, int dtype) {
  if (dtype == 1) return D == 64 ? (int)Dkv<64>::kSmem : (int)Dkv<128>::kSmem;
  return D == 64 ? (int)dkv_f32_smem_bytes<64>() : (int)dkv_f32_smem_bytes<128>();
}
