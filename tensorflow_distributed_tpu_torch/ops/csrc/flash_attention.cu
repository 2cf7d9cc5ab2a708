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
//         as f32 (the JAX bwd casts it so) and rounded to bf16 for the
//         tensor-core products; m carries no gradient (the merged ring
//         output does not depend on the stabilizer).
//
// Layout: q, o, dout, dq [BH, L, D]; k, v, dk, dv [BH, Lk, D]; all bf16,
// contiguous, except the partial form's o and dout (f32). lse, m, l, dl
// [BH, L] f32. D in {64, 128}; L and Lk multiples of 64.
//
// What bounds them on an H100: at GPT-2-small training shapes
// (BH = 96, L = 1024, D = 64) the tensor-core work (~13-26 GFLOP per
// call, causal) and the bytes each call must move (~50-90 MB) give
// bounds of the same order (~15-26 us), so both the matrix units and
// HBM matter. This first version is the simple, correct design: one
// CTA of 4 warps per 64-row output tile, bf16 WMMA (16x16x16) with f32
// accumulation, tiles staged in shared memory, and per-CTA loop bounds
// that skip key (resp. query) tiles outside the band. Instead of the
// TPU's sequential grid and VMEM scratch carried across grid steps,
// each CTA owns its output tile and loops over the reduction axis
// itself; rowsum(dO*O) is recomputed per tile as on the TPU rather than
// stored. No TMA, wgmma or pipelining yet: that is later work. The
// partial kernels share these loops as template instantiations: a ring
// step's half-block attend (GPT-2-small at S = 4: BH 96, 128 x 128) is
// a few MB of traffic and tens of MFLOP, so they are bound by bytes and
// by launch latency; their f32 o and dO double the bytes of those
// operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int WARPS = 4;      // each warp owns 16 rows of the output tile
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;  // large-finite, as the JAX kernels

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// window_keep: the (row - window, row] causal band; window 0 = unlimited.
__device__ __forceinline__ bool keep(int row, int col, int causal, int window) {
  if (!causal) return true;
  return col <= row && (window == 0 || col > row - window);
}

// Key tiles [lo, hi] that query tile qt needs (the JAX _kv_needed).
__device__ __forceinline__ void kv_range(int qt, int nk, int causal, int window,
                                         int* lo, int* hi) {
  *lo = 0;
  *hi = nk - 1;
  if (causal) {
    *hi = min(*hi, (qt * BQ + BQ - 1) / BK);
    if (window) *lo = max(qt * BQ - window + 1, 0) / BK;
  }
}

// Query tiles [lo, hi] that key tile kt needs (the JAX _q_needed).
__device__ __forceinline__ void q_range(int kt, int nq, int causal, int window,
                                        int* lo, int* hi) {
  *lo = 0;
  *hi = nq - 1;
  if (causal) {
    *lo = (kt * BK) / BQ;
    if (window) *hi = min(*hi, (kt * BK + BK - 2 + window) / BQ);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy `rows` contiguous rows of D bf16 from global to shared memory,
// 16 bytes per thread per iteration.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows) {
  const int n = rows * D / 8;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n; i += THREADS) d[i] = s[i];
}

// The same for f32 rows, rounded to bf16 on the way into shared memory
// (the partial backward's dO), 16 bytes read per thread per iteration.
template <int D>
__device__ __forceinline__ void load_tile_f32(bf16* dst, const float* src, int rows) {
  const int n = rows * D / 4;
  const float4* s = reinterpret_cast<const float4*>(src);
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float4 x = s[i];
    d[2 * i] = __floats2bfloat162_rn(x.x, x.y);
    d[2 * i + 1] = __floats2bfloat162_rn(x.z, x.w);
  }
}

// dO tile into shared memory as bf16: read as bf16 (normalized kernels)
// or as f32 (partial kernels).
template <int D, bool PARTIAL>
__device__ __forceinline__ void load_dout(bf16* dst, const void* dout, size_t off) {
  if constexpr (PARTIAL)
    load_tile_f32<D>(dst, static_cast<const float*>(dout) + off, BQ);
  else
    load_tile<D>(dst, static_cast<const bf16*>(dout) + off, BQ);
}

// acc[16 x 16*N] (one fragment per 16 columns) = A[16 x D] . B^T where B
// is [16*N x D] row-major in shared memory (so B^T is col-major).
template <int D, int N>
__device__ __forceinline__ void mm_abt(float* out, int ldo, const bf16* a,
                                       const bf16* b) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + kk * 16, D);
      wmma::load_matrix_sync(fb, b + n * 16 * D + kk * 16, D);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, ldo, wmma::mem_row_major);
  }
}

// acc[n] += A[16 x 64] . B[64 x D] for the D/16 column fragments; A is
// row-major with leading dimension 64, B row-major with leading dim D.
template <int D>
__device__ __forceinline__ void mm_ab_acc(FragC* acc, const bf16* a, const bf16* b) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, a + kk * 16, 64);
      wmma::load_matrix_sync(fb, b + kk * 16 * D + n * 16, D);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write a warp's 16 x D f32 accumulators to global bf16 rows through a
// 16 x D f32 shared-memory scratch owned by this warp.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, float* scratch, FragC* acc, int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(scratch + n * 16, acc[n], D, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) dst[i] = __float2bfloat16(scratch[i]);
  __syncwarp();
}

// ---------------------------------------------------------------- forward
// Grid (BH, L/BQ); one CTA per (head, query tile). Causal tiles are
// visited last-first so the longest bands start earliest. Normalized:
// o is bf16 and `stat` the lse. PARTIAL: o is the f32 accumulator,
// `stat` the row max m and `l_out` the exp-sum l.

template <int D>
constexpr int fwd_smem() {
  return (BQ * D + 2 * BK * D + BQ * BK) * 2 + (BQ * BK + BQ * D) * 4;
}

template <int D, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, void* __restrict__ o,
                 float* __restrict__ stat, float* __restrict__ l_out, int L,
                 int Lk, float scale, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);           // BQ x D
  bf16* sK = sQ + BQ * D;                             // BK x D
  bf16* sV = sK + BK * D;                             // BK x D
  bf16* sP = sV + BK * D;                             // BQ x BK
  float* sS = reinterpret_cast<float*>(sP + BQ * BK); // BQ x BK
  float* sO = sS + BQ * BK;                           // BQ x D accumulator

  const int bh = blockIdx.x;
  const int nq = L / BQ, nk = Lk / BK;
  const int qt = nq - 1 - blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kb = k + (size_t)bh * Lk * D;
  const bf16* vb = v + (size_t)bh * Lk * D;

  load_tile<D>(sQ, q + ((size_t)bh * L + (size_t)qt * BQ) * D, BQ);
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) sO[i] = 0.f;

  const bf16* sQw = sQ + warp * 16 * D;
  float* sSw = sS + warp * 16 * BK;
  bf16* sPw = sP + warp * 16 * BK;
  float* sOw = sO + warp * 16 * D;
  const int row0 = qt * BQ + warp * 16;  // global query row of the warp's first row

  // Running row max and sum, lane-replicated (every lane holds all 16).
  float m_row[16], l_row[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_row[r] = NEG_INF;
    l_row[r] = 0.f;
  }

  int lo, hi;
  kv_range(qt, nk, causal, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile<D>(sK, kb + (size_t)kt * BK * D, BK);
    load_tile<D>(sV, vb + (size_t)kt * BK * D, BK);
    __syncthreads();

    mm_abt<D, BK / 16>(sSw, BK, sQw, sK);  // S_w = Q_w K^T
    __syncwarp();

    const int col0 = kt * BK;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      float s0 = sSw[r * BK + lane] * scale;
      float s1 = sSw[r * BK + lane + 32] * scale;
      if (!keep(row, col0 + lane, causal, window)) s0 = NEG_INF;
      if (!keep(row, col0 + lane + 32, causal, window)) s1 = NEG_INF;
      const float m_new = fmaxf(m_row[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_row[r] - m_new);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      l_row[r] = l_row[r] * alpha + warp_sum(p0 + p1);
      m_row[r] = m_new;
      sPw[r * BK + lane] = __float2bfloat16(p0);
      sPw[r * BK + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < D; d += 32) sOw[r * D + d] *= alpha;
    }
    __syncwarp();

    // O_w += P_w V, accumulating in the shared-memory f32 tile.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragC acc;
      wmma::load_matrix_sync(acc, sOw + n * 16, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, sPw + kk * 16, BK);
        wmma::load_matrix_sync(fb, sV + kk * 16 * D + n * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sOw + n * 16, acc, D, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  const size_t rbase = (size_t)bh * L + (size_t)row0;
  if constexpr (PARTIAL) {
    float* ob = static_cast<float*>(o) + rbase * D;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      for (int d = lane; d < D; d += 32) ob[r * D + d] = sOw[r * D + d];
      if (lane == 0) {
        stat[rbase + r] = m_row[r];
        l_out[rbase + r] = l_row[r];
      }
    }
  } else {
    bf16* ob = static_cast<bf16*>(o) + rbase * D;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      for (int d = lane; d < D; d += 32)
        ob[r * D + d] = __float2bfloat16(sOw[r * D + d] / l_row[r]);
      if (lane == 0) stat[rbase + r] = m_row[r] + logf(l_row[r]);
    }
  }
}

// --------------------------------------------------------------------- dQ
// Grid (BH, L/BQ); one CTA per (head, query tile), looping over the key
// tiles of the band. dQ accumulates in registers. Normalized: `stat` is
// the lse, and delta = rowsum(dO * O) is recomputed from o (dl unused).
// PARTIAL: `stat` is m, delta = -dl, dout is f32 (o unused).

template <int D>
constexpr int dq_smem() {
  return (2 * BQ * D + 2 * BK * D + BQ * BK) * 2 + 2 * BQ * BK * 4;
}

template <int D, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const float* __restrict__ stat, const float* __restrict__ dl,
                const void* __restrict__ dout, bf16* __restrict__ dq, int L,
                int Lk, float scale, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);            // BQ x D
  bf16* sdO = sQ + BQ * D;                             // BQ x D
  bf16* sK = sdO + BQ * D;                             // BK x D
  bf16* sV = sK + BK * D;                              // BK x D
  bf16* sdS = sV + BK * D;                             // BQ x BK
  float* sS = reinterpret_cast<float*>(sdS + BQ * BK); // BQ x BK
  float* sdP = sS + BQ * BK;                           // BQ x BK

  const int bh = blockIdx.x;
  const int nq = L / BQ, nk = Lk / BK;
  const int qt = nq - 1 - blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = ((size_t)bh * L + (size_t)qt * BQ) * D;
  const bf16* kb = k + (size_t)bh * Lk * D;
  const bf16* vb = v + (size_t)bh * Lk * D;

  load_tile<D>(sQ, q + qoff, BQ);
  load_dout<D, PARTIAL>(sdO, dout, qoff);
  __syncthreads();

  const int row0 = qt * BQ + warp * 16;
  const bf16* sQw = sQ + warp * 16 * D;
  const bf16* sdOw = sdO + warp * 16 * D;
  float* sSw = sS + warp * 16 * BK;
  float* sdPw = sdP + warp * 16 * BK;
  bf16* sdSw = sdS + warp * 16 * BK;

  // Per-row lse (or m) and delta = rowsum(dO * O) (or -dl), lane-replicated.
  float lse_r[16], delta_r[16];
  const size_t rbase = (size_t)bh * L + row0;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if constexpr (PARTIAL) {
      delta_r[r] = -dl[rbase + r];
    } else {
      const bf16* orow = o + (rbase + r) * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(sdOw[r * D + d]) * __bfloat162float(orow[d]);
      delta_r[r] = warp_sum(acc);
    }
    lse_r[r] = stat[rbase + r];
  }

  FragC dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  int lo, hi;
  kv_range(qt, nk, causal, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    __syncthreads();
    load_tile<D>(sK, kb + (size_t)kt * BK * D, BK);
    load_tile<D>(sV, vb + (size_t)kt * BK * D, BK);
    __syncthreads();

    mm_abt<D, BK / 16>(sSw, BK, sQw, sK);    // S_w  = Q_w K^T
    mm_abt<D, BK / 16>(sdPw, BK, sdOw, sV);  // dP_w = dO_w V^T
    __syncwarp();

    const int col0 = kt * BK;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        float s = sSw[r * BK + c] * scale;
        if (!keep(row, col0 + c, causal, window)) s = NEG_INF;
        const float p = expf(s - lse_r[r]);
        const float ds = p * (sdPw[r * BK + c] - delta_r[r]) * scale;
        sdSw[r * BK + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_ab_acc<D>(dq_acc, sdSw, sK);  // dQ_w += dS_w K
  }
  __syncthreads();  // sS/sdP become per-warp epilogue scratch (16 x D f32 each)
  store_rows<D>(dq + qoff + (size_t)warp * 16 * D, sS + warp * 16 * D, dq_acc, lane);
}

// ------------------------------------------------------------------- dK/dV
// Grid (BH, Lk/BK); one CTA per (head, key tile), looping over the query
// tiles of the band. Each warp owns 16 key rows and computes the
// transposed blocks S^T = K Q^T and dP^T = V dO^T directly, so P^T and
// dS^T are warp-local and dK/dV accumulate in registers. `stat`, `dl`,
// `o` and `dout` as in the dQ kernel.

template <int D>
constexpr int dkv_smem() {
  return (2 * BK * D + 2 * BQ * D + 2 * BK * BQ) * 2 + 2 * BK * BQ * 4 + 2 * BQ * 4;
}

template <int D, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const float* __restrict__ stat, const float* __restrict__ dl,
                 const void* __restrict__ dout, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int L, int Lk, float scale, int causal,
                 int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);             // BK x D
  bf16* sV = sK + BK * D;                               // BK x D
  bf16* sQ = sV + BK * D;                               // BQ x D
  bf16* sdO = sQ + BQ * D;                              // BQ x D
  bf16* sPt = sdO + BQ * D;                             // BK x BQ
  bf16* sdSt = sPt + BK * BQ;                           // BK x BQ
  float* sSt = reinterpret_cast<float*>(sdSt + BK * BQ);// BK x BQ
  float* sdPt = sSt + BK * BQ;                          // BK x BQ
  float* sLse = sdPt + BK * BQ;                         // BQ
  float* sDelta = sLse + BQ;                            // BQ

  const int bh = blockIdx.x;
  const int nq = L / BQ, nk = Lk / BK;
  const int kt = blockIdx.y;  // causal: low key tiles have the longest bands
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t koff = ((size_t)bh * Lk + (size_t)kt * BK) * D;

  load_tile<D>(sK, k + koff, BK);
  load_tile<D>(sV, v + koff, BK);

  const int krow0 = kt * BK + warp * 16;  // global key row of the warp's first row
  const bf16* sKw = sK + warp * 16 * D;
  const bf16* sVw = sV + warp * 16 * D;
  float* sStw = sSt + warp * 16 * BQ;
  float* sdPtw = sdPt + warp * 16 * BQ;
  bf16* sPtw = sPt + warp * 16 * BQ;
  bf16* sdStw = sdSt + warp * 16 * BQ;

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  int lo, hi;
  q_range(kt, nq, causal, window, &lo, &hi);
  for (int qt = lo; qt <= hi; ++qt) {
    const size_t qoff = ((size_t)bh * L + (size_t)qt * BQ) * D;
    __syncthreads();  // the previous Q/dO tile and its stats are consumed
    load_tile<D>(sQ, q + qoff, BQ);
    load_dout<D, PARTIAL>(sdO, dout, qoff);
    if (threadIdx.x < BQ) {
      const size_t row = (size_t)bh * L + qt * BQ + threadIdx.x;
      sLse[threadIdx.x] = stat[row];
      if constexpr (PARTIAL) sDelta[threadIdx.x] = -dl[row];
    }
    __syncthreads();
    if constexpr (!PARTIAL) {
      // delta = rowsum(dO * O) for the tile's 64 query rows, 16 per warp.
      for (int r = 0; r < 16; ++r) {
        const int qr = warp * 16 + r;
        const bf16* orow = o + qoff + (size_t)qr * D;
        float acc = 0.f;
        for (int d = lane; d < D; d += 32)
          acc += __bfloat162float(sdO[qr * D + d]) * __bfloat162float(orow[d]);
        acc = warp_sum(acc);
        if (lane == 0) sDelta[qr] = acc;
      }
    }

    mm_abt<D, BQ / 16>(sStw, BQ, sKw, sQ);    // S^T_w  = K_w Q^T
    mm_abt<D, BQ / 16>(sdPtw, BQ, sVw, sdO);  // dP^T_w = V_w dO^T
    __syncthreads();  // sDelta complete

    const int qcol0 = qt * BQ;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int krow = krow0 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        float s = sStw[r * BQ + c] * scale;
        if (!keep(qcol0 + c, krow, causal, window)) s = NEG_INF;
        const float p = expf(s - sLse[c]);
        const float ds = p * (sdPtw[r * BQ + c] - sDelta[c]) * scale;
        sPtw[r * BQ + c] = __float2bfloat16(p);
        sdStw[r * BQ + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_ab_acc<D>(dv_acc, sPtw, sdO);  // dV_w += P^T_w dO
    mm_ab_acc<D>(dk_acc, sdStw, sQ);  // dK_w += dS^T_w Q
  }
  __syncthreads();  // sSt/sdPt become per-warp epilogue scratch
  float* scratch = sSt + warp * 16 * D;
  store_rows<D>(dk + koff + (size_t)warp * 16 * D, scratch, dk_acc, lane);
  store_rows<D>(dv + koff + (size_t)warp * 16 * D, scratch, dv_acc, lane);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// One launcher per kernel: set the shared-memory limit, launch on
// `stream`, return the launch's CUDA error. `o` and `dl` are null where
// the form does not read them (see the kernels).

template <int D, bool PARTIAL>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* stat,
                       void* l, int BH, int L, int Lk, float scale, int causal,
                       int window, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<D, PARTIAL>;
  cudaError_t err = prepare(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, L / BQ), THREADS, fwd_smem<D>(), s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, o, (float*)stat, (float*)l, L,
      Lk, scale, causal, window);
  return cudaGetLastError();
}

template <int D, bool PARTIAL>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* stat, const void* dl, const void* dout, void* dq,
                      int BH, int L, int Lk, float scale, int causal, int window,
                      cudaStream_t s) {
  auto kernel = flash_dq_kernel<D, PARTIAL>;
  cudaError_t err = prepare(kernel, dq_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, L / BQ), THREADS, dq_smem<D>(), s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const float*)stat,
      (const float*)dl, dout, (bf16*)dq, L, Lk, scale, causal, window);
  return cudaGetLastError();
}

template <int D, bool PARTIAL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o,
                       const void* stat, const void* dl, const void* dout, void* dk,
                       void* dv, int BH, int L, int Lk, float scale, int causal,
                       int window, cudaStream_t s) {
  auto kernel = flash_dkv_kernel<D, PARTIAL>;
  cudaError_t err = prepare(kernel, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, Lk / BK), THREADS, dkv_smem<D>(), s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, (const float*)stat,
      (const float*)dl, dout, (bf16*)dk, (bf16*)dv, L, Lk, scale, causal, window);
  return cudaGetLastError();
}

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
  TFD_BY_HEAD_DIM(launch_fwd, false, q, k, v, o, lse, nullptr, BH, L, Lk, scale, causal,
                  window, static_cast<cudaStream_t>(stream));
}

extern "C" int tfd_flash_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* lse, const void* dout, void* dq, int BH, int L,
                            int Lk, int D, float scale, int causal, int window,
                            void* stream) {
  TFD_BY_HEAD_DIM(launch_dq, false, q, k, v, o, lse, nullptr, dout, dq, BH, L, Lk, scale,
                  causal, window, static_cast<cudaStream_t>(stream));
}

extern "C" int tfd_flash_dkv(const void* q, const void* k, const void* v, const void* o,
                             const void* lse, const void* dout, void* dk, void* dv,
                             int BH, int L, int Lk, int D, float scale, int causal,
                             int window, void* stream) {
  TFD_BY_HEAD_DIM(launch_dkv, false, q, k, v, o, lse, nullptr, dout, dk, dv, BH, L, Lk,
                  scale, causal, window, static_cast<cudaStream_t>(stream));
}

// The partial (ring-step) kernels: o f32 [BH, L, D]; m, l, dl f32 [BH, L];
// dout f32 [BH, L, D].

extern "C" int tfd_flash_fwd_partial(const void* q, const void* k, const void* v, void* o,
                                     void* m, void* l, int BH, int L, int Lk, int D,
                                     float scale, int causal, int window, void* stream) {
  TFD_BY_HEAD_DIM(launch_fwd, true, q, k, v, o, m, l, BH, L, Lk, scale, causal, window,
                  static_cast<cudaStream_t>(stream));
}

extern "C" int tfd_flash_dq_partial(const void* q, const void* k, const void* v,
                                    const void* m, const void* dl, const void* dout,
                                    void* dq, int BH, int L, int Lk, int D, float scale,
                                    int causal, int window, void* stream) {
  TFD_BY_HEAD_DIM(launch_dq, true, q, k, v, nullptr, m, dl, dout, dq, BH, L, Lk, scale,
                  causal, window, static_cast<cudaStream_t>(stream));
}

extern "C" int tfd_flash_dkv_partial(const void* q, const void* k, const void* v,
                                     const void* m, const void* dl, const void* dout,
                                     void* dk, void* dv, int BH, int L, int Lk, int D,
                                     float scale, int causal, int window, void* stream) {
  TFD_BY_HEAD_DIM(launch_dkv, true, q, k, v, nullptr, m, dl, dout, dk, dv, BH, L, Lk,
                  scale, causal, window, static_cast<cudaStream_t>(stream));
}
