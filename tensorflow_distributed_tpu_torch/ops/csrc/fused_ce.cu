// Fused linear + cross-entropy ("flash CE") for Hopper (sm_90a): forward,
// dx and dW/db kernels.
//
// Replaces the Pallas TPU kernels of tensorflow_distributed_tpu/ops/
// fused_ce_kernel.py: _fwd_kernel (forward), _dx_kernel and _dw_kernel
// (backward), with _block_logits and _dlogits as the shared block math.
// Same function, same numerics:
//   logits = x . W^T + b in f32 from bf16 x and W (f32 accumulation);
//            vocab columns >= V are masked in place (logit NEG_INF,
//            p = 0, no gold, no smoothing term, never the argmax) instead
//            of padding W to a block multiple;
//   fwd  : online logsumexp over vocab tiles, gold logit, logit sum
//          (label smoothing eps) and first-max argmax (smallest column
//          among a tile's maxima; a later tile wins only with a strictly
//          larger max). Emits ce = lse - ((1-eps) gold + eps/V lsum),
//          correct = (argmax == target) and lse, each flat [T] f32;
//   bwd  : dlogits = coef (softmax - (1-eps) onehot - eps/V) from the
//          recomputed logits and the saved lse, rounded to bf16 before
//          the products (as the scan formulation rounds it to x's
//          dtype); dx = dlogits . W (bf16 out), dW = dlogits^T . x (f32
//          out), db = column sums of the f32 dlogits (f32 out).
//
// Layout: x [T, D] bf16, W [V, D] bf16, b [V] f32 or null (tied head),
// targets [T] int32, lse and coef [T] f32; all contiguous. D % 8 == 0
// (16-byte rows); any T >= 1 and V >= 1: ragged token and vocab tiles are
// masked here.
//
// What bounds them on an H100: at GPT-2-small training shapes (T = 8192,
// D = 768, V = 50257) each kernel is bound by operations, ~7000 FLOP
// per byte: the logits product alone is 2 T D V = 0.632 TFLOP on ~90 MB
// of input (0.64 ms at 989 TFLOP/s against 0.03 ms for the bytes), and
// dx and dW each add a second product of the same size. So the design
// keeps the tensor cores fed and never writes a logits block to memory:
// each CTA computes its logits block with bf16 WMMA (16x16x16, f32
// accumulation) from x and W tiles streamed over D in 32-column chunks
// (cp.async, double-buffered), keeps the block in shared memory, and
// consumes it there.
//
// The TPU grid runs in order and carries its accumulators in VMEM across
// the vocab (resp. token) axis. Blocks here run in no order, so a CTA
// owns its output and loops the reduction axis itself; nothing crosses
// CTAs, no atomics:
//   fwd : a CTA owns 64 tokens and walks every 128-column vocab tile,
//         with the running (m, l, gold, lsum, best, argmax) of its rows
//         in registers;
//   dx  : a CTA owns 64 tokens x a 384-column slice of D and walks every
//         vocab tile; dW/db: a CTA owns 64 vocab rows x a 384-column
//         slice of D and walks every 128-token tile.
// A dx or dW accumulator over all of D does not fit one CTA (64 x 768
// f32 is 196 KB, at D = 1600 400 KB), so each CTA owns a D slice and
// keeps its 64 x 384 f32 block in registers (each warp 48 columns); the
// price is that every slice recomputes the logits block: at D = 768 two
// slices, so 2 x 0.632 + 0.632 = 1.90 TFLOP per backward kernel instead
// of 1.26. db comes out of the dW CTA of slice 0 that owns the rows.
// No TMA, wgmma or warp specialisation yet: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 32;            // D columns per chunk of the logits product
constexpr int KPAD = KC + 8;      // shared-memory row stride of a chunk (bf16)
constexpr int CF = 3;             // 16-column fragments per warp in dx / dW
constexpr int DS = WARPS * 16 * CF;  // D columns of dx / dW per CTA (384)
constexpr int DSPAD = DS + 8;
constexpr float NEG_INF = -1e30f;  // large-finite, as the JAX kernels
constexpr int INT_BIG = 1 << 30;

// fwd and dx: 64 tokens x 128 vocab columns; dW: 128 tokens x 64 vocab.
constexpr int XT = 64, XV = 128;
constexpr int WT = 128, WV = 64;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// A TM x TN logits tile: each warp computes 32 x 32 of it.
template <int TM, int TN>
struct Tile {
  static constexpr int WN = TN / 32;               // warps along vocab
  static constexpr int WM = WARPS / WN;            // warps along tokens
  static_assert(WM * 32 == TM, "tile must be 8 warps of 32 x 32");
  static constexpr int LD = TN + 4;                // f32 row stride of the tile
  static constexpr int STAGE = (TM + TN) * KPAD;   // bf16 per pipeline stage
  static constexpr int STAGE_BYTES = 2 * STAGE * 2;
  static constexpr int TILE_BYTES = TM * LD * 4;
};

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

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[ROWS][COLS + 8] <- src[r0 + r][c0 + c] of a row-major [nrows, D]
// matrix; rows >= nrows and columns >= D read as zeros.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* src, int r0, int nrows,
                                           int c0, int D) {
  constexpr int G = COLS / 8;  // 16-byte groups per row
  for (int i = threadIdx.x; i < ROWS * G; i += THREADS) {
    const int r = i / G, g = i % G;
    const int col = c0 + g * 8;
    const bool ok = r0 + r < nrows && col < D;
    cp_async16(dst + r * (COLS + 8) + g * 8, ok ? src + (size_t)(r0 + r) * D + col : src, ok);
  }
}

// sL[TM][LD] = x[tok0 : tok0+TM] . W[v0 : v0+TN]^T in f32 (the TPU
// _block_logits without the bias): rows >= T and vocab rows >= V read as
// zeros. Streams both operands over D in KC-column chunks through two
// stages of `stage`. Ends with the tile visible to the whole CTA.
template <int TM, int TN>
__device__ __forceinline__ void logits_tile(float* sL, bf16* stage, const bf16* x,
                                            const bf16* w, int tok0, int T, int v0, int V,
                                            int D) {
  using TL = Tile<TM, TN>;
  const int warp = threadIdx.x / 32;
  const int wm = warp / TL::WN, wn = warp % TL::WN;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (D + KC - 1) / KC;
  load_block<TM, KC>(stage, x, tok0, T, 0, D);
  load_block<TN, KC>(stage + TM * KPAD, w, v0, V, 0, D);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      bf16* nxt = stage + ((kc + 1) & 1) * TL::STAGE;
      load_block<TM, KC>(nxt, x, tok0, T, (kc + 1) * KC, D);
      load_block<TN, KC>(nxt + TM * KPAD, w, v0, V, (kc + 1) * KC, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sx = stage + (kc & 1) * TL::STAGE;
    const bf16* sw = sx + TM * KPAD;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      FragA a[2];
      FragBt b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sx + (wm * 32 + i * 16) * KPAD + kk * 16, KPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sw + (wn * 32 + j * 16) * KPAD + kk * 16, KPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // this stage is refilled two chunks on
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sL + (wm * 32 + i * 16) * TL::LD + wn * 32 + j * 16, acc[i][j],
                              TL::LD, wmma::mem_row_major);
  __syncthreads();
}

// Write a 64-row x (WARPS * 16 * CF)-column block of f32 accumulators (this
// warp's columns: col0 + warp * 16 * CF ...) to dst[row][col] (row stride
// D) through a 16 x 16 per-warp scratch, masking rows >= nrows and
// columns >= D.
template <typename Out, typename Convert>
__device__ __forceinline__ void store_block(Out* dst, FragC (&acc)[4][CF], float* scratch,
                                            int row0, int nrows, int col0, int D,
                                            Convert convert) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CF; ++c) {
      wmma::store_matrix_sync(sw, acc[i][c], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = row0 + i * 16 + e / 16;
        const int col = col0 + warp * 16 * CF + c * 16 + e % 16;
        if (row < nrows && col < D) dst[(size_t)row * D + col] = convert(sw[e]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------- forward
// Grid (ceil(T / 64)); one CTA per token tile, walking every vocab tile.
// Each warp owns 8 token rows; lane j of a warp reads vocab columns
// j, j+32, j+64, j+96 of the tile.

constexpr int fwd_smem() { return Tile<XT, XV>::STAGE_BYTES + Tile<XT, XV>::TILE_BYTES; }

__global__ void __launch_bounds__(THREADS)
fused_ce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ b, const int* __restrict__ t,
                    float* __restrict__ ce, float* __restrict__ correct,
                    float* __restrict__ lse, int T, int D, int V, float eps) {
  using TL = Tile<XT, XV>;
  constexpr int RPW = XT / WARPS, CPL = XV / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  float* sL = reinterpret_cast<float*>(smem + TL::STAGE_BYTES);

  const int tok0 = blockIdx.x * XT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float m[RPW], l[RPW], gold[RPW], lsum[RPW], best[RPW];
  int arg[RPW], tgt[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = tok0 + warp * RPW + r;
    m[r] = NEG_INF;
    l[r] = 0.f;
    gold[r] = 0.f;
    lsum[r] = 0.f;
    best[r] = NEG_INF;
    arg[r] = -1;
    tgt[r] = row < T ? t[row] : -1;
  }

  for (int v0 = 0; v0 < V; v0 += XV) {
    logits_tile<XT, XV>(sL, stage, x, w, tok0, T, v0, V, D);
    bool valid[CPL];
    float bias[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int col = v0 + lane + 32 * j;
      valid[j] = col < V;
      bias[j] = (b != nullptr && valid[j]) ? b[col] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float* rowL = sL + (warp * RPW + r) * TL::LD;
      float s[CPL];
      float lmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        s[j] = valid[j] ? rowL[lane + 32 * j] + bias[j] : NEG_INF;
        lmax = fmaxf(lmax, s[j]);
      }
      // Online logsumexp over vocab tiles (the flash recurrence).
      const float tmax = warp_max(lmax);
      const float m_new = fmaxf(m[r], tmax);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) psum += expf(s[j] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + warp_sum(psum);
      m[r] = m_new;
      // Gold logit: the target column lies in at most one tile.
      const int tc = tgt[r] - v0;
      if (tc >= 0 && tc < XV && tgt[r] < V)
        gold[r] = rowL[tc] + (b != nullptr ? b[tgt[r]] : 0.f);
      if (eps != 0.f) {  // smoothing needs the sum of the real vocab's logits
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) part += valid[j] ? s[j] : 0.f;
        lsum[r] += warp_sum(part);
      }
      // First-max argmax: strict > keeps an earlier tile's winner; within
      // the tile the smallest column among the maxima wins.
      if (tmax > best[r]) {
        int idx = INT_BIG;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (valid[j] && s[j] == tmax) idx = min(idx, v0 + lane + 32 * j);
        best[r] = tmax;
        arg[r] = warp_min(idx);
      }
    }
    __syncthreads();  // sL is rewritten by the next tile
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = tok0 + warp * RPW + r;
      if (row >= T) continue;
      const float lse_r = m[r] + logf(l[r]);
      float g = gold[r];
      if (eps != 0.f) g = (1.f - eps) * g + (eps / V) * lsum[r];
      ce[row] = lse_r - g;
      correct[row] = arg[r] == tgt[r] ? 1.f : 0.f;
      lse[row] = lse_r;
    }
  }
}

// --------------------------------------------------------------------- dx
// Grid (ceil(T / 64), ceil(D / DS)); one CTA per (token tile, D slice),
// walking every vocab tile: logits tile -> dlogits (bf16, shared) ->
// dx_slice += dlogits . W[tile, slice], the W slice loaded while the
// dlogits are formed.

constexpr int dx_smem() {
  return Tile<XT, XV>::STAGE_BYTES + Tile<XT, XV>::TILE_BYTES + XT * (XV + 8) * 2 +
         XV * DSPAD * 2 + 3 * XT * 4;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_ce_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ b, const int* __restrict__ t,
                   const float* __restrict__ lse, const float* __restrict__ coef,
                   bf16* __restrict__ dx, int T, int D, int V, float eps) {
  using TL = Tile<XT, XV>;
  constexpr int RPW = XT / WARPS, CPL = XV / 32, LDD = XV + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  float* sL = reinterpret_cast<float*>(smem + TL::STAGE_BYTES);
  bf16* sD = reinterpret_cast<bf16*>(smem + TL::STAGE_BYTES + TL::TILE_BYTES);
  bf16* sY = sD + XT * LDD;  // W[v0 : v0+XV, d0 : d0+DS]
  int* sT = reinterpret_cast<int*>(sY + XV * DSPAD);
  float* sLse = reinterpret_cast<float*>(sT + XT);
  float* sCoef = sLse + XT;

  const int tok0 = blockIdx.x * XT, d0 = blockIdx.y * DS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x < XT) {  // read after logits_tile's first barrier
    const int row = tok0 + threadIdx.x;
    sT[threadIdx.x] = row < T ? t[row] : -1;
    sLse[threadIdx.x] = row < T ? lse[row] : 0.f;
    sCoef[threadIdx.x] = row < T ? coef[row] : 0.f;
  }
  FragC acc[4][CF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CF; ++c) wmma::fill_fragment(acc[i][c], 0.f);

  for (int v0 = 0; v0 < V; v0 += XV) {
    logits_tile<XT, XV>(sL, stage, x, w, tok0, T, v0, V, D);
    load_block<XV, DS>(sY, w, v0, V, d0, D);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j, col = v0 + c;
      const bool valid = col < V;
      const float bias = (b != nullptr && valid) ? b[col] : 0.f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int rt = warp * RPW + r;
        const int tg = sT[rt];
        float d = 0.f;
        if (tg >= 0 && valid) {  // the TPU _dlogits
          d = expf(sL[rt * TL::LD + c] + bias - sLse[rt]);
          if (col == tg) d -= 1.f - eps;
          if (eps != 0.f) d -= eps / V;
          d *= sCoef[rt];
        }
        sD[rt * LDD + c] = __float2bfloat16(d);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < XV / 16; ++kk) {
      FragB fb[CF];
#pragma unroll
      for (int c = 0; c < CF; ++c)
        wmma::load_matrix_sync(fb[c], sY + kk * 16 * DSPAD + warp * 16 * CF + c * 16, DSPAD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragA fa;
        wmma::load_matrix_sync(fa, sD + i * 16 * LDD + kk * 16, LDD);
#pragma unroll
        for (int c = 0; c < CF; ++c) wmma::mma_sync(acc[i][c], fa, fb[c], acc[i][c]);
      }
    }
    __syncthreads();  // sD and sY are rewritten by the next tile
  }
  store_block(dx, acc, sL, tok0, T, d0, D, [](float v) { return __float2bfloat16(v); });
}

// ------------------------------------------------------------------- dW/db
// Grid (ceil(V / 64), ceil(D / DS)); one CTA per (vocab tile, D slice),
// walking every token tile: logits tile -> dlogits (f32 in place for db,
// bf16 for the product) -> dW_slice += dlogits^T . x[tile, slice]. db
// sums the f32 dlogits: thread i keeps the partial of vocab column i % 64
// over token rows [32 (i / 64), 32 (i / 64) + 32) of every tile.

constexpr int dw_smem() {
  return Tile<WT, WV>::STAGE_BYTES + Tile<WT, WV>::TILE_BYTES + WT * (WV + 8) * 2 +
         WT * DSPAD * 2 + 3 * WT * 4;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_ce_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ b, const int* __restrict__ t,
                   const float* __restrict__ lse, const float* __restrict__ coef,
                   float* __restrict__ dw, float* __restrict__ db, int T, int D, int V,
                   float eps) {
  using TL = Tile<WT, WV>;
  constexpr int RPW = WT / WARPS, CPL = WV / 32, LDD = WV + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  float* sL = reinterpret_cast<float*>(smem + TL::STAGE_BYTES);
  bf16* sD = reinterpret_cast<bf16*>(smem + TL::STAGE_BYTES + TL::TILE_BYTES);
  bf16* sY = sD + WT * LDD;  // x[tok0 : tok0+WT, d0 : d0+DS]
  int* sT = reinterpret_cast<int*>(sY + WT * DSPAD);
  float* sLse = reinterpret_cast<float*>(sT + WT);
  float* sCoef = sLse + WT;

  const int v0 = blockIdx.x * WV, d0 = blockIdx.y * DS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  FragC acc[4][CF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CF; ++c) wmma::fill_fragment(acc[i][c], 0.f);
  const int db_col = threadIdx.x % WV, db_part = threadIdx.x / WV;
  float db_acc = 0.f;

  for (int tok0 = 0; tok0 < T; tok0 += WT) {
    if (threadIdx.x < WT) {
      const int row = tok0 + threadIdx.x;
      sT[threadIdx.x] = row < T ? t[row] : -1;
      sLse[threadIdx.x] = row < T ? lse[row] : 0.f;
      sCoef[threadIdx.x] = row < T ? coef[row] : 0.f;
    }
    logits_tile<WT, WV>(sL, stage, x, w, tok0, T, v0, V, D);  // syncs sT/sLse/sCoef too
    load_block<WT, DS>(sY, x, tok0, T, d0, D);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j, col = v0 + c;
      const bool valid = col < V;
      const float bias = (b != nullptr && valid) ? b[col] : 0.f;
#pragma unroll 4
      for (int r = 0; r < RPW; ++r) {
        const int rt = warp * RPW + r;
        const int tg = sT[rt];
        float d = 0.f;
        if (tg >= 0 && valid) {  // the TPU _dlogits
          d = expf(sL[rt * TL::LD + c] + bias - sLse[rt]);
          if (col == tg) d -= 1.f - eps;
          if (eps != 0.f) d -= eps / V;
          d *= sCoef[rt];
        }
        sL[rt * TL::LD + c] = d;
        sD[rt * LDD + c] = __float2bfloat16(d);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < WT / 4; ++r) db_acc += sL[(db_part * (WT / 4) + r) * TL::LD + db_col];
#pragma unroll
    for (int kk = 0; kk < WT / 16; ++kk) {
      FragB fb[CF];
#pragma unroll
      for (int c = 0; c < CF; ++c)
        wmma::load_matrix_sync(fb[c], sY + kk * 16 * DSPAD + warp * 16 * CF + c * 16, DSPAD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragAt fa;  // dlogits^T: element (vocab i, token k) at sD[k * LDD + i]
        wmma::load_matrix_sync(fa, sD + kk * 16 * LDD + i * 16, LDD);
#pragma unroll
        for (int c = 0; c < CF; ++c) wmma::mma_sync(acc[i][c], fa, fb[c], acc[i][c]);
      }
    }
    __syncthreads();  // sL, sD, sY and the token rows are rewritten next tile
  }
  store_block(dw, acc, sL, v0, V, d0, D, [](float v) { return v; });
  if (db != nullptr && blockIdx.y == 0) {
    float* sPart = sL + WARPS * 256;  // past store_block's scratch
    sPart[threadIdx.x] = db_acc;
    __syncthreads();
    if (threadIdx.x < WV && v0 + threadIdx.x < V) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < THREADS / WV; ++p) s += sPart[p * WV + threadIdx.x];
      db[v0 + threadIdx.x] = s;
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// ------------------------------------------------------------ C interface
// Each returns the CUDA error of the launch (0 = launched). Pointers are
// device pointers (b and db may be null: a head without bias); `stream`
// is a cudaStream_t. T, D, V >= 1 and D % 8 == 0 (the wrappers check).

extern "C" int tfd_fused_ce_fwd(const void* x, const void* w, const void* b, const void* t,
                                void* ce, void* correct, void* lse, int T, int D, int V,
                                float eps, void* stream) {
  cudaError_t err = prepare(fused_ce_fwd_kernel, fwd_smem());
  if (err != cudaSuccess) return err;
  fused_ce_fwd_kernel<<<dim3((T + XT - 1) / XT), THREADS, fwd_smem(),
                        static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, (const int*)t, (float*)ce,
      (float*)correct, (float*)lse, T, D, V, eps);
  return cudaGetLastError();
}

extern "C" int tfd_fused_ce_dx(const void* x, const void* w, const void* b, const void* t,
                               const void* lse, const void* coef, void* dx, int T, int D,
                               int V, float eps, void* stream) {
  cudaError_t err = prepare(fused_ce_dx_kernel, dx_smem());
  if (err != cudaSuccess) return err;
  fused_ce_dx_kernel<<<dim3((T + XT - 1) / XT, (D + DS - 1) / DS), THREADS, dx_smem(),
                       static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, (const int*)t, (const float*)lse,
      (const float*)coef, (bf16*)dx, T, D, V, eps);
  return cudaGetLastError();
}

extern "C" int tfd_fused_ce_dw(const void* x, const void* w, const void* b, const void* t,
                               const void* lse, const void* coef, void* dw, void* db, int T,
                               int D, int V, float eps, void* stream) {
  cudaError_t err = prepare(fused_ce_dw_kernel, dw_smem());
  if (err != cudaSuccess) return err;
  fused_ce_dw_kernel<<<dim3((V + WV - 1) / WV, (D + DS - 1) / DS), THREADS, dw_smem(),
                       static_cast<cudaStream_t>(stream)>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, (const int*)t, (const float*)lse,
      (const float*)coef, (float*)dw, (float*)db, T, D, V, eps);
  return cudaGetLastError();
}
