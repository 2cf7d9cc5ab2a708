// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels, in
// a normalized and a partial (ring-step) form.
//
// Replaces the Pallas TPU kernels of tensorflow_distributed_tpu/ops/
// flash_attention.py: _fwd_kernel (forward), _dq_kernel and _dkv_kernel
// (backward), and their partial-softmax twins _fwd_partial_kernel,
// _dq_partial_kernel and _dkv_partial_kernel (ring attention's local
// compute). Same function, same numerics:
//   s   = (q . k^T) * scale in f32, scale = 1/sqrt(D), masked to NEG_INF
//         outside the causal / sliding-window band (window_keep);
//   fwd : online softmax in f32, P cast to bf16 before P.V, emits
//         O = acc / l (bf16) and lse = m + log l (f32, flat [BH, L]);
//   bwd : P = exp(s - lse), dS = P * (dO.V^T - rowsum(dO*O)) * scale,
//         dS and P cast to bf16 before their products,
//         dQ = dS.K, dK = dS^T.Q, dV = P^T.dO.
// The partial form (template flag PARTIAL, the JAX _p_and_ds with
// (row_sub, row_add) = (m, +dl) instead of (lse, -delta)):
//   fwd : the same streaming loop without the lse fold; emits the
//         unnormalized acc (f32) and the row max m and exp-sum l (f32);
//   bwd : P = exp(s - m), dS = P * (dO.V^T + dl) * scale, with dO read
//         as f32 (the JAX bwd casts it so) and rounded to bf16, once, for
//         the tensor-core products; m carries no gradient (the merged
//         ring output does not depend on the stabilizer).
//
// Layout: q, o, dout, dq [BH, L, D]; k, v, dk, dv [BH, Lk, D]; all bf16,
// contiguous, except the partial form's o and dout (f32). lse, m, l, dl
// [BH, L] f32. D in {64, 128}; L and Lk multiples of 64.
//
// What bounds them on an H100: at GPT-2-small training shapes
// (BH = 96, L = 1024, D = 64) the tensor-core work (~13-26 GFLOP per
// call, causal) and the bytes each call must move (~50-90 MB) give
// bounds of the same order (~15-26 us), so both the matrix units and
// HBM matter. A ring step's half-block (GPT-2-small at S = 4: BH 96,
// 128 x 128) is a few MB and tens of MFLOP, a few microseconds of
// bound: there a CTA's fixed costs (its first loads, the pipeline's
// fill and drain) and the number of CTAs in flight set the time.
//
// The forward (tfd_flash_fwd, and tfd_flash_fwd_partial in its PARTIAL
// form) is flash_fwd_hopper<D, PARTIAL>: a CTA of 64 query rows per
// consumer warpgroup and a producer warpgroup; with one consumer, two
// CTAs to an SM (at D 64), so one CTA's prologue and epilogue run under
// the other's main loop. The producer (registers cut to 24 by
// setmaxnreg) has one thread issue TMA loads: the Q tile once, then the
// band's K/V tiles into a ring of 3 stages, each stage with a "full"
// mbarrier (TMA transaction bytes) and an "empty" one (one arrival per
// consumer warp). Each consumer (registers raised to 232, or 240 beside
// a second one) runs S = Q K^T as wgmma m64nBNk16 (BN the keys a stage)
// from shared memory into registers and the online softmax on those
// registers: the scale folds into the exponent's FMA, 2^x is one
// ex2.approx, the running max and sum stay in log2 units, a row lives in
// one quad (its max is two shfl.xor steps), and the band mask runs only
// on tiles that cross the band edge or the end of the keys. O += P V is
// a wgmma with P converted to bf16 in place as the register-A operand
// and V read MN-major (trans-b). The S product of tile j + 1 and the P V
// product of tile j are issued together, so the softmax of tile j + 1
// runs under P V; the two P register sets swap roles each tile (a copy
// would write registers an in-flight wgmma reads, and ptxas would
// serialize the wgmmas). O stays in registers for the whole loop and is
// written once. Q, K and V are 3-D tensor maps [BH, rows, D], so a box
// never reads into the next head and rows past L or Lk read as zeros.
// The two forms share all of this and differ in the epilogue and the
// tiles (Tiles<PARTIAL>):
//  - normalized (B1): O / l in bf16 and lse = (m + log2 l) ln 2; 64
//    rows a CTA, 128-key stages;
//  - partial (B7, the JAX _fwd_partial_kernel): O unnormalized in f32,
//    m in natural units (m ln 2; a row that saw no key keeps NEG_INF)
//    and l as summed (2^(s scale log2e - m log2e) = e^(s scale - m), so
//    l needs no conversion); its tiles chosen on the card at the ring's
//    half-blocks by scripts/torch_kernel_variants.py. The f32 o is the
//    larger part of its bytes (40% at a 128 x 128 half-block).

// The dK/dV kernel (tfd_flash_dkv, and tfd_flash_dkv_partial in its
// PARTIAL form) is built from the same pieces, flash_dkv_hopper<D,
// PARTIAL>: a CTA owns 64 key rows per consumer warpgroup (two, so each
// query tile loaded serves 128 keys) and has a producer warpgroup. The producer loads K and V once, then streams the
// band's query tiles through a ring of stages. Per tile each consumer
// runs S^T = K_w Q^T and dP^T = V_w dO^T (wgmma m64n64k16, all operands
// K-major), forms P^T = 2^(s scale log2e - row_sub log2e) and dS^T =
// P^T (dP^T + row_add) scale in registers (the band mask only on tiles
// that cross its edge), packs both to bf16 in place as register-A
// fragments and accumulates dV += P^T dO and dK += dS^T Q (dO and Q read
// MN-major, trans-b). dK and dV stay in registers (D / 2 each a thread)
// and are written once, bf16; a warpgroup whose 64 keys lie outside a
// tile's band skips the tile (it still waits for the tile before it
// releases it). The two forms differ in the stage and the row terms:
//  - normalized: a stage holds the Q, dO and O tiles (TMA), and each
//    consumer computes the tile's lse and delta = rowsum(dO * O) into
//    shared memory under its products (recomputed per tile from the O
//    and dO tiles, as the JAX _delta);
//  - partial: a stage holds Q (TMA), dO rounded to bf16, and the tile's
//    m log2e and dl scale. dO arrives in f32, and TMA cannot convert
//    types, so the producer's first thread lands the f32 tile by TMA in
//    a staging area of the stage and the producer's other three warps,
//    idle otherwise, round it to bf16 into the swizzled layout TMA would
//    have written (16-byte chunk index ^ row % 8), write the rows, fence
//    (fence.proxy.async: generic stores read by wgmma) and arrive on the
//    stage's full barrier beside TMA's transaction bytes. No O tile.
//
// The dQ kernel (tfd_flash_dq, and tfd_flash_dq_partial in its PARTIAL
// form) is the same pieces once more, flash_dq_hopper<D, PARTIAL>: a
// CTA owns 64 query rows per consumer warpgroup (two in the normalized
// form, one in the partial one) and a producer warpgroup that loads the
// Q tile once and streams the band's K/V tiles (64 keys in the
// normalized form, 128 in the partial one) through a ring of up to 4
// stages, so each K/V tile loaded serves all of the CTA's rows. A dQ CTA's rows
// are fixed, so each consumer reads its rows' terms once, under the
// first loads:
//  - normalized: dO comes by TMA with Q; lse and delta = rowsum(dO * O)
//    from global memory, a row in one quad, each thread a quarter of
//    the row's dO and O, two shfl.xor steps summing the quad (O needs no
//    shared memory);
//  - partial: m and dl, and the warpgroup's own 64 rows of f32 dO from
//    global memory (all loads in flight at once), rounded to bf16 into
//    the swizzled dO tile; a fence and a barrier of the warpgroup's
//    threads before its first wgmma reads them.
// Per K/V tile it runs S = Q K^T and dP = dO V^T (wgmma m64nBNk16, BN
// the keys a stage, from shared memory, all operands K-major, the two
// products' k-steps interleaved), forms P = 2^(s scale log2e - row_sub log2e) and dS = P
// (dP + row_add) scale in registers (the band mask only on tiles that
// cross its edge or the end of the keys), packs dS to bf16 in place as
// the register-A fragments and accumulates dQ += dS K with K read
// MN-major (trans-b) from the same swizzled tile. dQ stays in registers
// (D / 2 a thread) and is written once, bf16; a warpgroup whose rows see
// none of a tile's keys skips it. At GPT-2-small's shapes the bound is
// the bytes (~0.023 ms), against 3/4 of dK/dV's tensor-core work. Each
// form has its own tiles (rows a CTA, keys or rows a stage), chosen on
// the card by scripts/torch_kernel_variants.py: the normalized ones at
// L 1024, the partial ones at the ring's half-blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;  // large-finite, as the JAX kernels

// window_keep: the (row - window, row] causal band; window 0 = unlimited.
__device__ __forceinline__ bool keep(int row, int col, int causal, int window) {
  if (!causal) return true;
  return col <= row && (window == 0 || col > row - window);
}

// Allows a kernel `smem` bytes of dynamic shared memory (above 48 KB only
// so).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// --------------------------------------------------- forward, Hopper design
// Grid (BH, ceil(L / BM)); one CTA per (head, BM query rows), heaviest
// causal tiles first. See the note at the top of the file.

namespace hfwd {

// Tiles, for the normalized form (B1) and the partial one (B7) apart:
// consumer warpgroups of 64 query rows each, sharing each K/V stage, and
// keys a stage. One consumer: two CTAs to an SM (registers: 128 a thread
// at launch; the producer gives back down to 24, the consumer takes
// 232). Two: one CTA to an SM, 168 registers a thread at launch, the
// consumers raised to 240. scripts/torch_kernel_variants.py times the
// partial choices at the ring's half-blocks: one consumer and 64-key
// stages took the least time over a ring call's mix (PERF.md).
constexpr int CONSUMERS = 1;          // B1
constexpr int BN = 128;               // B1: key rows per stage
constexpr int PARTIAL_CONSUMERS = 1;  // B7
constexpr int PARTIAL_BN = 64;        // B7: key rows per stage
constexpr int ATOM = 128;       // bytes per swizzled row: 64 bf16 of D
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <bool PARTIAL>
struct Tiles {
  static constexpr int CONSUMERS = PARTIAL ? PARTIAL_CONSUMERS : hfwd::CONSUMERS;
  static constexpr int BN = PARTIAL ? PARTIAL_BN : hfwd::BN;
  static constexpr int BM = 64 * CONSUMERS;  // query rows per CTA
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int CTAS_PER_SM = CONSUMERS == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = CONSUMERS == 1 ? 232 : 240;
};

template <int D, bool PARTIAL>
struct Smem {
  using T = Tiles<PARTIAL>;
  static constexpr int ATOMS = D / 64;
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = T::BM * D * 2;
  static constexpr int KV_BYTES = T::BN * D * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "more shared memory than a block may have");
};

// Online softmax of one key tile on the S accumulator (m64nBN, a
// thread's rows r0 and r0 + 8, raw q.k): mask the band and the end of
// the keys where the tile crosses them, update the running max m and
// sum l in log2 units (alpha: the factor the old O and l take), and
// leave P = 2^(s scale_log2 - m) as bf16 register-A fragments in pa.
// The scale folds into the exponent's FMA (scale > 0 keeps the max).
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BN / 2], uint32_t (&pa)[BN / 16][4],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             int col0, int wrow0, int r0, int lane, int Lk,
                                             float scale_log2, int causal, int window) {
  const bool edge = col0 + BN > Lk ||
                    (causal && (col0 + BN - 1 > wrow0 || (window && col0 <= wrow0 + 63 - window)));
  if (edge) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int row = r0 + 8 * ((j % 4) / 2);
      const int col = col0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
      if (col >= Lk || !keep(row, col, causal, window)) sacc[j] = NEG_INF;
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) mx[(j % 4) / 2] = fmaxf(mx[(j % 4) / 2], sacc[j]);
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // A masked score is NEG_INF after scaling, as in the JAX kernel.
    const float m_new = fmaxf(m[h], mx[h] == NEG_INF ? NEG_INF : mx[h] * scale_log2);
    alpha[h] = hopper::exp2_approx(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
    neg_m[h] = -m_new;
  }
  if (edge) {  // a masked score is NEG_INF after scaling: 2^(NEG_INF - m)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j)
      sacc[j] = hopper::exp2_approx(sacc[j] == NEG_INF ? NEG_INF + neg_m[(j % 4) / 2]
                                                       : fmaf(sacc[j], scale_log2,
                                                              neg_m[(j % 4) / 2]));
  } else {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j)
      sacc[j] = hopper::exp2_approx(fmaf(sacc[j], scale_log2, neg_m[(j % 4) / 2]));
  }
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) l[(j % 4) / 2] += sacc[j];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = hopper::pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
}

// The normalized form writes o (bf16) and `stat` = lse; the partial form
// o (f32, unnormalized), `stat` = m and `l_out` = l (unused otherwise).
template <int D, bool PARTIAL>
__global__ void __launch_bounds__(Tiles<PARTIAL>::THREADS, Tiles<PARTIAL>::CTAS_PER_SM)
flash_fwd_hopper(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, void* __restrict__ o,
                 float* __restrict__ stat, float* __restrict__ l_out, int L, int Lk,
                 float scale_log2, int causal, int window) {
  using T = Tiles<PARTIAL>;
  using S = Smem<D, PARTIAL>;
  constexpr int CONSUMERS = T::CONSUMERS, BM = T::BM, BN = T::BN, STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled TMA tiles want 1024-byte-aligned shared addresses.
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.x;
  const int nq = (L + BM - 1) / BM, nk = (Lk + BN - 1) / BN;
  const int qt = nq - 1 - blockIdx.y;
  const int wg = threadIdx.x / 128;
  int lo = 0, hi = nk - 1;  // the band's key tiles (the JAX _kv_needed)
  if (causal) {
    hi = min(hi, (qt * BM + BM - 1) / BN);
    if (window) lo = max(qt * BM - window + 1, 0) / BN;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every load
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      hopper::mbar_expect_tx(qbar, S::Q_BYTES);
      for (int a = 0; a < S::ATOMS; ++a)
        hopper::tma_load_3d(smem + a * BM * ATOM, &mq, qbar, a * 64, qt * BM, bh);
      for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
        const int s = i % STAGES, phase = (i / STAGES) & 1;
        hopper::mbar_wait(&empty[s], phase ^ 1);  // the first round passes at once
        hopper::mbar_expect_tx(&full[s], S::STAGE_BYTES);
        unsigned char* kb = smem + S::Q_BYTES + s * S::STAGE_BYTES;
        for (int a = 0; a < S::ATOMS; ++a) {
          hopper::tma_load_3d(kb + a * BN * ATOM, &mk, &full[s], a * 64, kt * BN, bh);
          hopper::tma_load_3d(kb + S::KV_BYTES + a * BN * ATOM, &mv, &full[s], a * 64, kt * BN,
                              bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each. Per key tile j the S product of
    // tile j + 1 and the P.V product of tile j are issued together, and
    // the softmax of tile j + 1 runs on the CUDA cores while the tensor
    // cores do P.V; O is rescaled once that product is done.
    hopper::setmaxnreg_inc<T::CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int wrow0 = qt * BM + wg * 64;           // the warpgroup's first query row
    const int r0 = wrow0 + warp * 16 + lane / 4;   // this thread's rows: r0 and r0 + 8
    const unsigned char* sq = smem + wg * 64 * ATOM;

    float oacc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) oacc[j] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // log2-scaled running max, sum
    float alpha[2];
    float sacc[BN / 2];
    // P as bf16 register-A fragments: the tile in P.V and the next one,
    // swapping roles each tile (no copies, so no register is written
    // while a wgmma that reads it is in flight).
    uint32_t pa[BN / 16][4], pb[BN / 16][4];

    // S = Q K^T of the tile in stage s: both operands K-major, D / 16
    // steps of k16.
    auto issue_s = [&](int s) {
      const unsigned char* kb = smem + S::Q_BYTES + s * S::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<BN, 0>::ss(
            sacc, hopper::desc_sw128(sq + (kk / 4) * BM * ATOM + (kk % 4) * 32, 0),
            hopper::desc_sw128(kb + (kk / 4) * BN * ATOM + (kk % 4) * 32, 0), kk > 0);
    };
    // O += P V of the tile in stage s: V [keys, D] is B with N = D
    // contiguous (MN-major, trans-b); step kk reads keys 16 kk.. of every
    // 64-column atom.
    auto issue_pv = [&](int s, uint32_t(&p)[BN / 16][4]) {
      const unsigned char* vb = smem + S::Q_BYTES + s * S::STAGE_BYTES + S::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::Wgmma<D, 1>::rs(oacc, p[kk], hopper::desc_sw128(vb + kk * 16 * ATOM, BN * ATOM),
                                1);
    };
    // Tile kt (the i-th of the band, i >= 1): its S product and the
    // previous tile's P.V (from pc) in flight together, its softmax into
    // pn under the P.V, then O rescaled.
    auto step = [&](int kt, int i, uint32_t(&pc)[BN / 16][4], uint32_t(&pn)[BN / 16][4]) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      hopper::fence_operand(oacc);
      hopper::wgmma_fence();
      issue_s(s);
      hopper::wgmma_commit();
      issue_pv(sp, pc);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S of this tile; P.V of the last may still run
      hopper::fence_operand(sacc);
      softmax_tile<BN>(sacc, pn, m, l, alpha, kt * BN, wrow0, r0, lane, Lk, scale_log2, causal,
                       window);
      hopper::wgmma_wait<0>();
      hopper::fence_operand(pc);
      hopper::fence_operand(oacc);
      if (lane == 0) hopper::mbar_arrive(&empty[sp]);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) oacc[j] *= alpha[(j % 4) / 2];
    };
    // The last tile's P.V.
    auto finish = [&](uint32_t(&pc)[BN / 16][4]) {
      const int last = (hi - lo) % STAGES;
      hopper::fence_operand(oacc);
      hopper::wgmma_fence();
      issue_pv(last, pc);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(pc);
      hopper::fence_operand(oacc);
      if (lane == 0) hopper::mbar_arrive(&empty[last]);
    };

    hopper::mbar_wait(qbar, 0);
    hopper::mbar_wait(&full[0], 0);
    hopper::wgmma_fence();
    issue_s(0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(sacc);
    softmax_tile<BN>(sacc, pa, m, l, alpha, lo * BN, wrow0, r0, lane, Lk, scale_log2, causal,
                     window);
    int kt = lo + 1, i = 1;
    for (; kt + 1 <= hi; kt += 2, i += 2) {
      step(kt, i, pa, pb);
      step(kt + 1, i + 1, pb, pa);
    }
    if (kt <= hi) {
      step(kt, i, pa, pb);
      finish(pb);
    } else {
      finish(pa);
    }

    // Epilogue; rows >= L dropped. l summed over the row's quad.
    const size_t base = (size_t)bh * L;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    if constexpr (PARTIAL) {
      // O unnormalized in f32; m in natural units (a row that saw no key
      // keeps NEG_INF), l as summed: 2^(s scale log2e - m log2e) is
      // e^(s scale - m).
      float* of = static_cast<float*>(o);
#pragma unroll
      for (int j = 0; j < D / 2; j += 2) {
        const int h = (j % 4) / 2, row = r0 + 8 * h;
        const int col = 8 * (j / 4) + 2 * (lane % 4);
        if (row < L)
          *reinterpret_cast<float2*>(of + (base + row) * D + col) =
              make_float2(oacc[j], oacc[j + 1]);
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (r0 + 8 * h < L) {
            stat[base + r0 + 8 * h] = m[h] == NEG_INF ? NEG_INF : m[h] * LN2;
            l_out[base + r0 + 8 * h] = l[h];
          }
      }
    } else {
      // O / l in bf16, lse = (m + log2 l) ln 2.
      bf16* ob = static_cast<bf16*>(o);
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int j = 0; j < D / 2; j += 2) {
        const int h = (j % 4) / 2, row = r0 + 8 * h;
        const int col = 8 * (j / 4) + 2 * (lane % 4);
        if (row < L)
          *reinterpret_cast<uint32_t*>(ob + (base + row) * D + col) =
              hopper::pack_bf16(oacc[j] * inv[h], oacc[j + 1] * inv[h]);
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (r0 + 8 * h < L) stat[base + r0 + 8 * h] = (m[h] + log2f(l[h])) * LN2;
      }
    }
  }
}

// `stat` is lse (normalized) or m, and `l` null or l (partial).
template <int D, bool PARTIAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* stat, void* l,
                   int BH, int L, int Lk, float scale, int causal, int window,
                   cudaStream_t stream) {
  using T = Tiles<PARTIAL>;
  using S = Smem<D, PARTIAL>;
  CUtensorMap mq, mk, mv;
  const uint64_t qdims[3] = {D, (uint64_t)L, (uint64_t)BH};
  const uint64_t kdims[3] = {D, (uint64_t)Lk, (uint64_t)BH};
  const uint64_t qstr[2] = {D * 2, (uint64_t)L * D * 2};
  const uint64_t kstr[2] = {D * 2, (uint64_t)Lk * D * 2};
  const uint32_t qbox[3] = {64, T::BM, 1}, kbox[3] = {64, T::BN, 1};
  cudaError_t err = hopper::encode_bf16_map(&mq, q, 3, qdims, qstr, qbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mk, k, 3, kdims, kstr, kbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mv, v, 3, kdims, kstr, kbox);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_hopper<D, PARTIAL>;
  err = prepare(kernel, S::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (L + T::BM - 1) / T::BM), T::THREADS, S::BYTES, stream>>>(
      mq, mk, mv, o, (float*)stat, (float*)l, L, Lk, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

}  // namespace hfwd

// -------------------------------------------------------- dQ, Hopper design
// Grid (BH, ceil(L / BM)); one CTA per (head, BM query rows), heaviest
// causal tiles first. See the note at the top of the file.

namespace hdq {

// Tiles, for the normalized form (B2) and the partial one (B8) apart:
// consumer warpgroups of 64 query rows each, sharing each K/V stage, and
// keys a stage. Two consumers: one CTA to an SM, 168 registers a thread
// at launch, the consumers raised to 240; one: two CTAs to an SM, as B1
// (128 at launch, 232). scripts/torch_kernel_variants.py times both; at
// the ring's 128 x 128 half-block one consumer (192 CTAs for B.H 96)
// and 128-key stages won (PERF.md).
constexpr int CONSUMERS = 2;          // B2
constexpr int BN = 64;                // B2: key rows per stage
constexpr int PARTIAL_CONSUMERS = 1;  // B8
constexpr int PARTIAL_BN = 128;       // B8: key rows per stage
constexpr int ATOM = 128;       // bytes per swizzled row: 64 bf16 of D
constexpr float LOG2E = 1.4426950408889634f;

template <bool PARTIAL>
struct Tiles {
  static constexpr int CONSUMERS = PARTIAL ? PARTIAL_CONSUMERS : hdq::CONSUMERS;
  static constexpr int BN = PARTIAL ? PARTIAL_BN : hdq::BN;
  static constexpr int BM = 64 * CONSUMERS;  // query rows per CTA
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int CTAS_PER_SM = CONSUMERS == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = CONSUMERS == 1 ? 232 : 240;
};

template <int D, bool PARTIAL>
struct Smem {
  using T = Tiles<PARTIAL>;
  static constexpr int ATOMS = D / 64;
  static constexpr int Q_BYTES = T::BM * D * 2;   // the Q or the dO tile
  static constexpr int KV_BYTES = T::BN * D * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // As many stages as fit, up to 4, in a block's share of the SM: half
  // of 233472 bytes less the 1024 each block reserves where two CTAs to
  // an SM fit with two stages, else all a block may have.
  static constexpr int FIXED = 2 * Q_BYTES + 80 + 1024;
  static constexpr int LIMIT =
      T::CTAS_PER_SM == 2 && FIXED + 2 * STAGE_BYTES <= 115712 ? 115712 : 232448;
  static constexpr int STAGES = (LIMIT - FIXED) / STAGE_BYTES < 4
                                    ? (LIMIT - FIXED) / STAGE_BYTES : 4;
  static constexpr int BAR_OFF = 2 * Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(STAGES >= 2 && BYTES <= 232448, "no room for two stages");
};

// The normalized form reads lse, O and dO (bf16, by TMA and for delta);
// the partial form m, dl and dO (f32, converted by the consumers).
// `row_sub` is lse or m; `o` is null and `mdo` unused in the partial form.
template <int D, bool PARTIAL>
__global__ void __launch_bounds__(Tiles<PARTIAL>::THREADS, Tiles<PARTIAL>::CTAS_PER_SM)
flash_dq_hopper(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                const bf16* __restrict__ o, const void* __restrict__ dout,
                const float* __restrict__ row_sub, const float* __restrict__ dl,
                bf16* __restrict__ dq, int L, int Lk, float scale, int causal, int window) {
  using T = Tiles<PARTIAL>;
  using S = Smem<D, PARTIAL>;
  constexpr int CONSUMERS = T::CONSUMERS, BM = T::BM, BN = T::BN, STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled TMA tiles want 1024-byte-aligned shared addresses.
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.x;
  const int nq = (L + BM - 1) / BM, nk = (Lk + BN - 1) / BN;
  const int qt = nq - 1 - blockIdx.y;
  const int wg = threadIdx.x / 128;
  int lo = 0, hi = nk - 1;  // the CTA's key tiles (the JAX _kv_needed)
  if (causal) {
    hi = min(hi, (qt * BM + BM - 1) / BN);
    if (window) lo = max(qt * BM - window + 1, 0) / BN;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every load: Q (and dO, normalized)
    // once, then the band's K/V tiles through the stage ring.
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      hopper::mbar_expect_tx(qbar, (PARTIAL ? 1 : 2) * S::Q_BYTES);
      for (int a = 0; a < S::ATOMS; ++a) {
        hopper::tma_load_3d(smem + a * BM * ATOM, &mq, qbar, a * 64, qt * BM, bh);
        if constexpr (!PARTIAL)
          hopper::tma_load_3d(smem + S::Q_BYTES + a * BM * ATOM, &mdo, qbar, a * 64, qt * BM,
                              bh);
      }
      for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the first round passes at once
        hopper::mbar_expect_tx(&full[s], S::STAGE_BYTES);
        unsigned char* kb = smem + 2 * S::Q_BYTES + s * S::STAGE_BYTES;
        for (int a = 0; a < S::ATOMS; ++a) {
          hopper::tma_load_3d(kb + a * BN * ATOM, &mk, &full[s], a * 64, kt * BN, bh);
          hopper::tma_load_3d(kb + S::KV_BYTES + a * BN * ATOM, &mv, &full[s], a * 64, kt * BN,
                              bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each, over the key tiles of their own
    // band [ka, kb] (the CTA's band holds it; a tile outside it is waited
    // for and released unread: an early release would complete the
    // ring's previous round). Per tile S and dP from shared memory, dS in
    // registers, then dQ += dS K with dS as the register-A operand.
    hopper::setmaxnreg_inc<T::CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int wrow0 = qt * BM + wg * 64;          // the warpgroup's first query row
    const int r0 = wrow0 + warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
    const unsigned char* sq = smem + wg * 64 * ATOM;
    const unsigned char* sdo = sq + S::Q_BYTES;
    const float scale_log2 = scale * LOG2E;
    int ka = 0, kb = nk - 1;
    if (causal) {
      kb = min(kb, (wrow0 + 63) / BN);
      if (window) ka = max(wrow0 - window + 1, 0) / BN;
    }
    if (wrow0 >= L) kb = ka - 1;  // no row of the warpgroup below L

    // The rows' row_sub (log2 units) and row_add scale, once.
    float lse2[2], nd[2];
    if constexpr (PARTIAL) {
      // m and dl, and the warpgroup's 64 dO rows: f32 from global memory
      // (every load in flight at once), rounded to bf16 into the swizzled
      // tile as TMA would have written it (16-byte chunk ^ row % 8); the
      // wgmma reads them after a proxy fence and the warpgroup's barrier.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        lse2[h] = row < L ? __ldg(row_sub + (size_t)bh * L + row) * LOG2E : 0.f;
        nd[h] = row < L ? __ldg(dl + (size_t)bh * L + row) * scale : 0.f;
      }
      constexpr int CH = D / 8;        // 16-byte bf16 chunks a row
      constexpr int N = 64 * CH / 128;  // chunks a thread
      float4 x[N][2];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int r = (i * 128 + t) / CH, c = (i * 128 + t) % CH;
        x[i][0] = x[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (wrow0 + r < L) {
          const float4* src = reinterpret_cast<const float4*>(
              static_cast<const float*>(dout) + ((size_t)bh * L + wrow0 + r) * D + c * 8);
          x[i][0] = __ldg(src);
          x[i][1] = __ldg(src + 1);
        }
      }
      unsigned char* sdo_w = smem + S::Q_BYTES + wg * 64 * ATOM;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int r = (i * 128 + t) / CH, c = (i * 128 + t) % CH;
        const uint4 w = {hopper::pack_bf16(x[i][0].x, x[i][0].y),
                         hopper::pack_bf16(x[i][0].z, x[i][0].w),
                         hopper::pack_bf16(x[i][1].x, x[i][1].y),
                         hopper::pack_bf16(x[i][1].z, x[i][1].w)};
        *reinterpret_cast<uint4*>(sdo_w + (c / 8) * BM * ATOM + r * ATOM +
                                  (((c % 8) ^ (r & 7)) << 4)) = w;
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
    } else {
      // lse and -delta scale, delta = rowsum(dO * O) (the JAX _delta): a
      // row lives in one quad, each thread reads a quarter of it from
      // global memory (under the first TMA loads) and two shfl.xor steps
      // sum the quad.
      const bf16* dob = static_cast<const bf16*>(dout);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        float acc = 0.f;
        lse2[h] = 0.f;
        if (row < L) {
          const size_t off = ((size_t)bh * L + row) * D + (lane % 4) * (D / 4);
          const uint4* po = reinterpret_cast<const uint4*>(o + off);
          const uint4* pd = reinterpret_cast<const uint4*>(dob + off);
#pragma unroll
          for (int i = 0; i < D / 32; ++i) {
            const uint4 a = __ldg(pd + i), b = __ldg(po + i);
            const __nv_bfloat162* fa = reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* fb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 x = __bfloat1622float2(fa[e]), y = __bfloat1622float2(fb[e]);
              acc = fmaf(x.x, y.x, acc);
              acc = fmaf(x.y, y.y, acc);
            }
          }
          lse2[h] = __ldg(row_sub + (size_t)bh * L + row) * LOG2E;
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        nd[h] = -acc * scale;
      }
    }

    float dqacc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dqacc[j] = 0.f;
    float sacc[BN / 2], dpacc[BN / 2];
    uint32_t df[BN / 16][4];

    hopper::mbar_wait(qbar, 0);
    for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
      const int s = i % STAGES, col0 = kt * BN;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      if (kt >= ka && kt <= kb) {
        const unsigned char* sk = smem + 2 * S::Q_BYTES + s * S::STAGE_BYTES;
        const unsigned char* sv = sk + S::KV_BYTES;
        // S = Q K^T and dP = dO V^T: all operands K-major, D / 16 steps of
        // k16, the two products' steps interleaved.
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int oa = (kk / 4) * BM * ATOM + (kk % 4) * 32;
          const int ob = (kk / 4) * BN * ATOM + (kk % 4) * 32;
          hopper::Wgmma<BN, 0>::ss(sacc, hopper::desc_sw128(sq + oa, 0),
                                   hopper::desc_sw128(sk + ob, 0), kk > 0);
          hopper::Wgmma<BN, 0>::ss(dpacc, hopper::desc_sw128(sdo + oa, 0),
                                   hopper::desc_sw128(sv + ob, 0), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(sacc);
        hopper::fence_operand(dpacc);

        // P = 2^(s scale log2e - row_sub log2e), 0 outside the band and
        // past the keys (masked only on tiles that cross either); dS = P
        // (dP + row_add) scale, packed to bf16 as the register-A fragments.
        const bool edge = col0 + BN > Lk ||
                          (causal && (col0 + BN - 1 > wrow0 ||
                                      (window && col0 <= wrow0 + 63 - window)));
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int h = (j % 4) / 2;
          const int col = col0 + 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
          float p = hopper::exp2_approx(fmaf(sacc[j], scale_log2, -lse2[h]));
          if (edge && (col >= Lk || !keep(r0 + 8 * h, col, causal, window))) p = 0.f;
          dpacc[j] = p * fmaf(dpacc[j], scale, nd[h]);
        }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            df[kk][r] = hopper::pack_bf16(dpacc[8 * kk + 2 * r], dpacc[8 * kk + 2 * r + 1]);

        // dQ += dS K: K [keys, D] is B with D contiguous (MN-major,
        // trans-b), the same tile as above; step kk reads keys 16 kk.. of
        // every 64-column atom.
        hopper::fence_operand(dqacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hopper::Wgmma<D, 1>::rs(dqacc, df[kk], hopper::desc_sw128(sk + kk * 16 * ATOM, BN * ATOM),
                                  1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(df);
        hopper::fence_operand(dqacc);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: dQ in bf16; rows >= L dropped.
    const size_t base = (size_t)bh * L;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int row = r0 + 8 * ((j % 4) / 2);
      const int col = 8 * (j / 4) + 2 * (lane % 4);
      if (row < L)
        *reinterpret_cast<uint32_t*>(dq + (base + row) * D + col) =
            hopper::pack_bf16(dqacc[j], dqacc[j + 1]);
    }
  }
}

template <int D, bool PARTIAL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* row_sub, const void* dl, const void* dout, void* dq, int BH,
                   int L, int Lk, float scale, int causal, int window, cudaStream_t stream) {
  using T = Tiles<PARTIAL>;
  using S = Smem<D, PARTIAL>;
  CUtensorMap mq, mk, mv, mdo = {};
  const uint64_t qdims[3] = {D, (uint64_t)L, (uint64_t)BH};
  const uint64_t kdims[3] = {D, (uint64_t)Lk, (uint64_t)BH};
  const uint64_t qstr[2] = {D * 2, (uint64_t)L * D * 2};
  const uint64_t kstr[2] = {D * 2, (uint64_t)Lk * D * 2};
  const uint32_t qbox[3] = {64, T::BM, 1}, kbox[3] = {64, T::BN, 1};
  cudaError_t err = hopper::encode_bf16_map(&mq, q, 3, qdims, qstr, qbox);
  if (!PARTIAL && err == cudaSuccess)
    err = hopper::encode_bf16_map(&mdo, dout, 3, qdims, qstr, qbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mk, k, 3, kdims, kstr, kbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mv, v, 3, kdims, kstr, kbox);
  if (err != cudaSuccess) return err;
  auto kernel = flash_dq_hopper<D, PARTIAL>;
  err = prepare(kernel, S::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (L + T::BM - 1) / T::BM), T::THREADS, S::BYTES, stream>>>(
      mq, mk, mv, mdo, (const bf16*)o, dout, (const float*)row_sub, (const float*)dl, (bf16*)dq,
      L, Lk, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace hdq

// ----------------------------------------------------- dK/dV, Hopper design
// Grid (BH, ceil(Lk / BN)); one CTA per (head, BN key rows), low key
// tiles (the longest causal bands) first. See the note at the top of the
// file.

namespace hdkv {

// Tiles, for the normalized form (B3) and the partial one (B9) apart:
// consumer warpgroups of 64 key rows each (keys a CTA: 64 a consumer),
// and query rows a stage. Two consumers: one CTA to an SM (168
// registers a thread at launch); one: two CTAs to an SM (128 at
// launch). scripts/torch_kernel_variants.py times the partial choices;
// two consumers and 64-row stages won at the ring's half-blocks
// (PERF.md).
constexpr int CONSUMERS = 2;          // B3
constexpr int BM = 64;                // B3: query rows per stage
constexpr int PARTIAL_CONSUMERS = 2;  // B9
constexpr int PARTIAL_BM = 64;        // B9: query rows per stage
// The partial form's producer warpgroup: warp 0's first thread issues
// the TMA loads, warps 1-3 round each f32 dO tile to bf16.
constexpr int CONVERTERS = 96;
constexpr int ATOM = 128;       // bytes per swizzled row: 64 bf16 of D
constexpr float LOG2E = 1.4426950408889634f;

template <bool PARTIAL>
struct Tiles {
  static constexpr int CONSUMERS = PARTIAL ? PARTIAL_CONSUMERS : hdkv::CONSUMERS;
  static constexpr int BN = 64 * CONSUMERS;  // key rows per CTA
  static constexpr int BM = PARTIAL ? PARTIAL_BM : hdkv::BM;
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int CTAS_PER_SM = CONSUMERS == 1 ? 2 : 1;
  static constexpr int CONSUMER_REGS = PARTIAL ? 232 : 240;
  // The producer keeps what the consumers leave of the CTA's registers
  // at launch (setmaxnreg.inc draws on what .dec released): 24 in the
  // normalized form; the partial form's converters take 40 beside two
  // consumers, 24 beside one.
  static constexpr int LAUNCH_REGS = 65536 / (THREADS * CTAS_PER_SM) / 8 * 8;
  static constexpr int PRODUCER_REGS =
      (LAUNCH_REGS * (CONSUMERS + 1) - CONSUMERS * CONSUMER_REGS) / 8 * 8;
  static_assert(PRODUCER_REGS >= 24, "the producer needs 24 registers");
};

template <int D, bool PARTIAL>
struct Smem {
  using T = Tiles<PARTIAL>;
  static constexpr int ATOMS = D / 64;
  static constexpr int KV_BYTES = T::BN * D * 2;  // K or V of the CTA
  static constexpr int T_BYTES = T::BM * D * 2;   // one bf16 Q, dO or O tile
  // The partial form's f32 dO tile as TMA lands it, [D / 32][BM][32]
  // floats, converted into the stage's bf16 dO tile.
  static constexpr int F_BYTES = PARTIAL ? T::BM * D * 4 : 0;
  static constexpr int STAGE_BYTES = (PARTIAL ? 2 : 3) * T_BYTES + F_BYTES;
  static constexpr int ST_OFF = 2 * KV_BYTES;
  // A query tile's rows: row_sub log2e, then row_add scale. Per stage
  // (partial: written by the converters), or per warpgroup and
  // double-buffered (normalized: computed by the consumers).
  static constexpr int ROW_BYTES = 2 * T::BM * 4;
  // Partial: as many stages as fit, up to 3, in a block's share of the
  // SM (as hdq::Smem); normalized: 3.
  static constexpr int FIXED = ST_OFF + 8 + 1024;
  static constexpr int PER_STAGE = STAGE_BYTES + ROW_BYTES + 3 * 8;
  static constexpr int LIMIT =
      T::CTAS_PER_SM == 2 && FIXED + 2 * PER_STAGE <= 115712 ? 115712 : 232448;
  static constexpr int STAGES = !PARTIAL ? 3 : (LIMIT - FIXED) / PER_STAGE < 3
                                                   ? (LIMIT - FIXED) / PER_STAGE : 3;
  static constexpr int ROW_OFF = ST_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + (PARTIAL ? STAGES : 2 * T::CONSUMERS) * ROW_BYTES;
  static constexpr int BYTES =
      BAR_OFF + ((PARTIAL ? 3 : 2) * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(STAGES >= 1 && BYTES <= 232448, "more shared memory than a block may have");
};

// The normalized form reads lse and the Q, dO and O tiles (bf16, TMA);
// the partial form m, dl and the Q tile (bf16, TMA) and the f32 dO tile
// (TMA into the staging area, `mdo` an f32 map). `row_sub` is lse or m;
// `dl` is unused in the normalized form, `mo` in the partial one.
template <int D, bool PARTIAL>
__global__ void __launch_bounds__(Tiles<PARTIAL>::THREADS, Tiles<PARTIAL>::CTAS_PER_SM)
flash_dkv_hopper(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                 const __grid_constant__ CUtensorMap mdo, const float* __restrict__ row_sub,
                 const float* __restrict__ dl, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int L, int Lk, float scale, int causal, int window) {
  using T = Tiles<PARTIAL>;
  using S = Smem<D, PARTIAL>;
  constexpr int CONSUMERS = T::CONSUMERS, BN = T::BN, BM = T::BM, STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled TMA tiles want 1024-byte-aligned shared addresses.
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  [[maybe_unused]] uint64_t* landed = kvbar + 1;  // partial: the stage's f32 dO tile is in

  const int bh = blockIdx.x, kt = blockIdx.y;
  const int nq = PARTIAL ? (L + BM - 1) / BM : L / BM;
  const int wg = threadIdx.x / 128;
  int lo = 0, hi = nq - 1;  // the band's query tiles (the JAX _q_needed)
  if (causal) {
    lo = (kt * BN) / BM;
    if (window) hi = min(hi, (kt * BN + BN - 2 + window) / BM);
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // Partial: TMA's bytes and one arrival per converter.
      hopper::mbar_init(&full[s], PARTIAL ? 1 + CONVERTERS : 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
      if constexpr (PARTIAL) hopper::mbar_init(&landed[s], 1);
    }
    hopper::mbar_init(kvbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every load: K and V once, then the
    // band's Q, dO and O tiles (partial: Q, and dO in f32) through the
    // stage ring.
    hopper::setmaxnreg_dec<T::PRODUCER_REGS>();
    const int t = threadIdx.x - CONSUMERS * 128;
    if (t == 0) {
      hopper::mbar_expect_tx(kvbar, 2 * S::KV_BYTES);
      for (int a = 0; a < S::ATOMS; ++a) {
        hopper::tma_load_3d(smem + a * BN * ATOM, &mk, kvbar, a * 64, kt * BN, bh);
        hopper::tma_load_3d(smem + S::KV_BYTES + a * BN * ATOM, &mv, kvbar, a * 64, kt * BN, bh);
      }
      for (int qt = lo, j = 0; qt <= hi; ++qt, ++j) {
        const int s = j % STAGES;
        hopper::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // the first round passes at once
        hopper::mbar_expect_tx(&full[s], (PARTIAL ? 1 : 3) * S::T_BYTES);
        unsigned char* st = smem + S::ST_OFF + s * S::STAGE_BYTES;
        for (int a = 0; a < S::ATOMS; ++a) {
          hopper::tma_load_3d(st + a * BM * ATOM, &mq, &full[s], a * 64, qt * BM, bh);
          if constexpr (!PARTIAL) {
            hopper::tma_load_3d(st + S::T_BYTES + a * BM * ATOM, &mdo, &full[s], a * 64,
                                qt * BM, bh);
            hopper::tma_load_3d(st + 2 * S::T_BYTES + a * BM * ATOM, &mo, &full[s], a * 64,
                                qt * BM, bh);
          }
        }
        if constexpr (PARTIAL) {
          hopper::mbar_expect_tx(&landed[s], S::F_BYTES);
          for (int a = 0; a < D / 32; ++a)
            hopper::tma_load_3d(st + 2 * S::T_BYTES + a * BM * 128, &mdo, &landed[s], a * 32,
                                qt * BM, bh);
        }
      }
    } else if constexpr (PARTIAL) {
      if (t >= 32) {
        // Converters: per tile, the rows' m log2e and dl scale (loaded
        // before the tile lands), then the f32 dO tile rounded to bf16
        // into the swizzled tile (16-byte chunk ^ row % 8), 4 floats a
        // step; a proxy fence, then one arrival each on the full barrier.
        const int c = t - 32;
        constexpr int RPT = (BM + CONVERTERS - 1) / CONVERTERS;  // rows a converter
        for (int qt = lo, j = 0; qt <= hi; ++qt, ++j) {
          const int s = j % STAGES;
          float m2[RPT], nd[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = c + i * CONVERTERS, row = qt * BM + r;
            const bool in = r < BM && row < L;
            m2[i] = in ? __ldg(row_sub + (size_t)bh * L + row) * LOG2E : 0.f;
            nd[i] = in ? __ldg(dl + (size_t)bh * L + row) * scale : 0.f;
          }
          hopper::mbar_wait(&landed[s], (j / STAGES) & 1);
          unsigned char* st = smem + S::ST_OFF + s * S::STAGE_BYTES;
          float* rows = reinterpret_cast<float*>(smem + S::ROW_OFF) + s * 2 * BM;
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int r = c + i * CONVERTERS;
            if (r < BM) {
              rows[r] = m2[i];
              rows[BM + r] = nd[i];
            }
          }
          const float* f = reinterpret_cast<const float*>(st + 2 * S::T_BYTES);
          unsigned char* sdo = st + S::T_BYTES;
          for (int idx = c; idx < BM * D / 4; idx += CONVERTERS) {
            const int r = idx / (D / 4), q4 = idx % (D / 4), ch = q4 / 2;
            const float4 x =
                *reinterpret_cast<const float4*>(f + (q4 / 8) * BM * 32 + r * 32 + (q4 % 8) * 4);
            const uint2 w = {hopper::pack_bf16(x.x, x.y), hopper::pack_bf16(x.z, x.w)};
            *reinterpret_cast<uint2*>(sdo + (ch / 8) * BM * ATOM + r * ATOM +
                                      (((ch % 8) ^ (r & 7)) << 4) + (q4 % 2) * 8) = w;
          }
          hopper::fence_proxy_async();
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 key rows each, over the query tiles of their own
    // band [qa, qb] (the JAX _q_needed of the 64 keys; the CTA's band
    // holds it, and a tile outside it is waited for and released
    // unread: an early release would complete the ring's previous
    // round). Per tile S^T and dP^T from shared memory, P^T and dS^T in
    // registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as
    // register-A operands.
    hopper::setmaxnreg_inc<T::CONSUMER_REGS>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int kw0 = kt * BN + wg * 64;        // the warpgroup's first key row
    const int r0 = kw0 + warp * 16 + lane / 4;  // this thread's keys: r0 and r0 + 8
    const unsigned char* skw = smem + wg * 64 * ATOM;
    const unsigned char* svw = skw + S::KV_BYTES;
    const float scale_log2 = scale * LOG2E;
    int qa = 0, qb = nq - 1;
    if (causal) {
      qa = kw0 / BM;
      if (window) qb = min(qb, (kw0 + 62 + window) / BM);
    }
    if (kw0 >= Lk) qb = qa - 1;  // no key of the warpgroup below Lk

    float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dkacc[j] = dvacc[j] = 0.f;
    float sacc[BM / 2], dpacc[BM / 2];
    uint32_t pf[BM / 16][4], df[BM / 16][4];

    hopper::mbar_wait(kvbar, 0);
    for (int qt = lo, j = 0; qt <= hi; ++qt, ++j) {
      const int s = j % STAGES, q0 = qt * BM;
      hopper::mbar_wait(&full[s], (j / STAGES) & 1);
      if (qt >= qa && qt <= qb) {
        const unsigned char* sq = smem + S::ST_OFF + s * S::STAGE_BYTES;
        const unsigned char* sdo = sq + S::T_BYTES;
        // S^T = K_w Q^T and dP^T = V_w dO^T: all operands K-major, D / 16
        // steps of k16, the two products' steps interleaved (a step waits
        // for the one before it into the same accumulator).
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ka = (kk / 4) * BN * ATOM + (kk % 4) * 32;
          const int kb = (kk / 4) * BM * ATOM + (kk % 4) * 32;
          hopper::Wgmma<BM, 0>::ss(sacc, hopper::desc_sw128(skw + ka, 0),
                                   hopper::desc_sw128(sq + kb, 0), kk > 0);
          hopper::Wgmma<BM, 0>::ss(dpacc, hopper::desc_sw128(svw + ka, 0),
                                   hopper::desc_sw128(sdo + kb, 0), kk > 0);
        }
        hopper::wgmma_commit();

        // The tile's rows: row_sub log2e, then row_add scale.
        const float* rows;
        if constexpr (PARTIAL) {
          rows = reinterpret_cast<const float*>(smem + S::ROW_OFF) + s * 2 * BM;
        } else {
          // Under the products: the tile's lse (log2 units) and -delta
          // scale, delta = rowsum(dO * O) (the JAX _delta), two threads a
          // row, from the swizzled tiles (16-byte chunk ^ row % 8).
          const unsigned char* so = sq + 2 * S::T_BYTES;
          float* wrows =
              reinterpret_cast<float*>(smem + S::ROW_OFF) + ((j & 1) * CONSUMERS + wg) * 2 * BM;
          const int q = t >> 1, half = t & 1;
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < D / 16; ++i) {
            const int ch = half * (D / 16) + i;
            const int off = (ch / 8) * BM * ATOM + q * ATOM + (((ch % 8) ^ (q & 7)) * 16);
            const uint4 a = *reinterpret_cast<const uint4*>(sdo + off);
            const uint4 b = *reinterpret_cast<const uint4*>(so + off);
            const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 fa = __bfloat1622float2(pa[e]), fb = __bfloat1622float2(pb[e]);
              acc = fmaf(fa.x, fb.x, acc);
              acc = fmaf(fa.y, fb.y, acc);
            }
          }
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          if (half == 0) {
            wrows[q] = __ldg(row_sub + (size_t)bh * L + q0 + q) * LOG2E;
            wrows[BM + q] = -acc * scale;
          }
          hopper::named_sync(1 + wg, 128);  // the rows are in
          rows = wrows;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_operand(sacc);
        hopper::fence_operand(dpacc);

        // P^T = 2^(s scale log2e - row_sub log2e), 0 outside the band
        // (masked only on tiles that cross its edge); dS^T = P^T (dP^T +
        // row_add) scale. Both packed to bf16 as the register-A fragments.
        const bool edge = causal && (kw0 + 63 > q0 || (window && kw0 <= q0 + BM - 1 - window));
#pragma unroll
        for (int n8 = 0; n8 < BM / 8; ++n8) {
          const int c = 8 * n8 + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(rows + c);
          const float2 nd = *reinterpret_cast<const float2*>(rows + BM + c);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jj = 4 * n8 + 2 * h + e;
              float p = hopper::exp2_approx(fmaf(sacc[jj], scale_log2, -(e ? l2.y : l2.x)));
              if (edge && !keep(q0 + c + e, r0 + 8 * h, causal, window)) p = 0.f;
              dpacc[jj] = p * fmaf(dpacc[jj], scale, e ? nd.y : nd.x);
              sacc[jj] = p;
            }
        }
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pf[kk][r] = hopper::pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
            df[kk][r] = hopper::pack_bf16(dpacc[8 * kk + 2 * r], dpacc[8 * kk + 2 * r + 1]);
          }

        // dV += P^T dO and dK += dS^T Q, interleaved: B [queries, D] with
        // D contiguous (MN-major, trans-b); step kk reads queries 16 kk..
        // of every 64-column atom.
        hopper::fence_operand(dkacc);
        hopper::fence_operand(dvacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          hopper::Wgmma<D, 1>::rs(dvacc, pf[kk],
                                  hopper::desc_sw128(sdo + kk * 16 * ATOM, BM * ATOM), 1);
          hopper::Wgmma<D, 1>::rs(dkacc, df[kk],
                                  hopper::desc_sw128(sq + kk * 16 * ATOM, BM * ATOM), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(pf);
        hopper::fence_operand(df);
        hopper::fence_operand(dkacc);
        hopper::fence_operand(dvacc);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // Epilogue: dK and dV in bf16; rows >= Lk dropped.
    const size_t base = (size_t)bh * Lk;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int row = r0 + 8 * ((j % 4) / 2);
      const int col = 8 * (j / 4) + 2 * (lane % 4);
      if (row < Lk) {
        *reinterpret_cast<uint32_t*>(dk + (base + row) * D + col) =
            hopper::pack_bf16(dkacc[j], dkacc[j + 1]);
        *reinterpret_cast<uint32_t*>(dv + (base + row) * D + col) =
            hopper::pack_bf16(dvacc[j], dvacc[j + 1]);
      }
    }
  }
}

template <int D, bool PARTIAL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* row_sub, const void* dl, const void* dout, void* dk, void* dv,
                   int BH, int L, int Lk, float scale, int causal, int window,
                   cudaStream_t stream) {
  using T = Tiles<PARTIAL>;
  using S = Smem<D, PARTIAL>;
  CUtensorMap mq, mk, mv, mo = {}, mdo;
  const uint64_t qdims[3] = {D, (uint64_t)L, (uint64_t)BH};
  const uint64_t kdims[3] = {D, (uint64_t)Lk, (uint64_t)BH};
  const uint64_t qstr[2] = {D * 2, (uint64_t)L * D * 2};
  const uint64_t kstr[2] = {D * 2, (uint64_t)Lk * D * 2};
  const uint64_t fstr[2] = {D * 4, (uint64_t)L * D * 4};  // the partial form's f32 dO
  const uint32_t qbox[3] = {64, T::BM, 1}, kbox[3] = {64, T::BN, 1}, fbox[3] = {32, T::BM, 1};
  cudaError_t err = hopper::encode_bf16_map(&mq, q, 3, qdims, qstr, qbox);
  if (!PARTIAL && err == cudaSuccess) err = hopper::encode_bf16_map(&mo, o, 3, qdims, qstr, qbox);
  if (err == cudaSuccess)
    err = PARTIAL ? hopper::encode_f32_map(&mdo, dout, 3, qdims, fstr, fbox)
                  : hopper::encode_bf16_map(&mdo, dout, 3, qdims, qstr, qbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mk, k, 3, kdims, kstr, kbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mv, v, 3, kdims, kstr, kbox);
  if (err != cudaSuccess) return err;
  auto kernel = flash_dkv_hopper<D, PARTIAL>;
  err = prepare(kernel, S::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, (Lk + T::BN - 1) / T::BN), T::THREADS, S::BYTES, stream>>>(
      mq, mk, mv, mo, mdo, (const float*)row_sub, (const float*)dl, (bf16*)dk, (bf16*)dv, L, Lk,
      scale, causal, window);
  return cudaGetLastError();
}

}  // namespace hdkv

// The head dim picks the instantiation (64 or 128; anything else is
// refused before a launch).
#define TFD_BY_HEAD_DIM(LAUNCH, PARTIAL, ...)                        \
  do {                                                               \
    if (D == 64) return LAUNCH<64, PARTIAL>(__VA_ARGS__);            \
    if (D == 128) return LAUNCH<128, PARTIAL>(__VA_ARGS__);          \
    return cudaErrorInvalidValue;                                    \
  } while (0)

}  // namespace

// ------------------------------------------------------------ C interface
// Each returns the CUDA error of the launch (0 = launched). Pointers are
// device pointers; `stream` is a cudaStream_t. Every function takes its
// pointers, then (BH, L, Lk, D, scale, causal, window), then the stream.

extern "C" int tfd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int BH, int L, int Lk, int D, float scale,
                             int causal, int window, void* stream) {
  TFD_BY_HEAD_DIM(hfwd::launch, false, q, k, v, o, lse, nullptr, BH, L, Lk, scale, causal, window,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int tfd_flash_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, int BH, int L,
                            int Lk, int D, float scale, int causal, int window,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  TFD_BY_HEAD_DIM(hdq::launch, false, q, k, v, o, lse, nullptr, dout, dq, BH, L, Lk, scale,
                  causal, window, s);
}

extern "C" int tfd_flash_dkv(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* dk, void* dv,
                             int BH, int L, int Lk, int D, float scale, int causal,
                             int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  TFD_BY_HEAD_DIM(hdkv::launch, false, q, k, v, o, lse, nullptr, dout, dk, dv, BH, L, Lk, scale,
                  causal, window, s);
}

// The partial (ring-step) kernels: o f32 [BH, L, D]; m, l, dl f32 [BH, L];
// dout f32 [BH, L, D].

extern "C" int tfd_flash_fwd_partial(const void* q, const void* k, const void* v, void* o,
                                     void* m, void* l, int BH, int L, int Lk, int D,
                                     float scale, int causal, int window, void* stream) {
  TFD_BY_HEAD_DIM(hfwd::launch, true, q, k, v, o, m, l, BH, L, Lk, scale, causal, window,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int tfd_flash_dq_partial(const void* q, const void* k, const void* v,
                                    const void* m, const void* dl, const void* dout,
                                    void* dq, int BH, int L, int Lk, int D, float scale,
                                    int causal, int window, void* stream) {
  TFD_BY_HEAD_DIM(hdq::launch, true, q, k, v, nullptr, m, dl, dout, dq, BH, L, Lk, scale,
                  causal, window, static_cast<cudaStream_t>(stream));
}

extern "C" int tfd_flash_dkv_partial(const void* q, const void* k, const void* v,
                                     const void* m, const void* dl, const void* dout,
                                     void* dk, void* dv, int BH, int L, int Lk, int D,
                                     float scale, int causal, int window, void* stream) {
  TFD_BY_HEAD_DIM(hdkv::launch, true, q, k, v, nullptr, m, dl, dout, dk, dv, BH, L, Lk, scale,
                  causal, window, static_cast<cudaStream_t>(stream));
}
