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
// keeps the tensor cores fed and never writes a logits block to memory.
//
// The TPU grid runs in order and carries its accumulators in VMEM across
// the vocab (resp. token) axis. Blocks here run in no order, so a CTA
// owns its output and loops the reduction axis itself; nothing crosses
// CTAs, no atomics.
//
// dx is the Hopper design, fused_ce_dx_hopper: a CTA owns 64 tokens x a
// 384-column slice of D and walks every 128-column vocab tile, with
// three warpgroups. The producer (registers cut to 24 by setmaxnreg) has
// one thread issue TMA loads: per vocab tile, the x and W chunks of 64 D
// columns into a 4-stage ring under full/empty mbarriers, and
// W[tile, slice] for the dx product into its own buffer, issued when the
// previous tile's dx product releases it (as the consumers start this
// tile's logits), so it lands under the logits product. The two consumer
// warpgroups (registers raised to 240) share the 64 tokens: warpgroup h
// computes vocab columns [64 h, 64 h + 64) of the logits block with
// wgmma m64n64k16 from shared memory (x and W both K-major) into
// registers, forms dlogits there exactly as the JAX _dlogits (bias,
// exp(logit - lse), - (1-eps) at the target, - eps/V, times coef), and
// stores them as bf16 into a shared 64 x 128 dlogits tile in the
// 128-byte-swizzled K-major layout (double-buffered, a named barrier
// between the halves); then each accumulates its own 192 columns of
// dx += dlogits . W[tile, slice] with wgmma m64n192k16 (A the dlogits
// tile, B the W slice MN-major: trans-b), and waits for it (left in
// flight under the next tile's logits, ptxas serializes the wgmmas:
// warning C7515). The f32 dx block (96 registers a thread) stays in
// registers for the whole vocab loop and is written once, bf16.
// Ragged edges come from TMA's zero fill (tokens >= T, vocab rows >= V,
// D columns >= D) plus the vocab and row masks; the bias row goes
// through shared memory, loaded under the logits product.
//
// Register budget and recompute: a warpgroup's dx accumulator over 64
// tokens and N columns costs N / 2 registers a thread, its logits block
// over 64 vocab columns 32. Splitting the vocab tile's logits between the
// two warpgroups and sharing them through shared memory lets the CTA own
// 384 columns (2 x 96 registers), so at D = 768 two slices recompute the
// logits: 2 x 0.632 + 0.632 = 1.90 TFLOP executed for the 1.26 the
// function needs, in 128 x 2 = 256 CTAs of one per SM (1.94 waves on 132
// SMs). The alternative that keeps dlogits in registers as the dx
// product's A operand (each warpgroup its own 64 tokens, a 64 x 128
// logits block and a 256-column slice: 64 + 128 registers) executes 2.53
// TFLOP in 192 CTAs (1.45 waves), spills, and was slower on the card.
//
// dW/db is the same design transposed, fused_ce_dw_hopper: a CTA owns 64
// vocab rows x a 384-column slice of D and walks every 128-token tile.
// The producer streams the W[64 rows, 64-column chunk] and x[128 tokens,
// chunk] boxes through the stage ring and x[tile, slice] into its own
// buffer; consumer warpgroup h computes logits^T[64 vocab, tokens 64 h ..
// 64 h + 64) = W x^T (wgmma m64n64k16, both K-major), forms dlogits^T in
// registers (the bias is now per row: two registers a thread, loaded
// once; target, lse and coef are per column: the 128 tokens' rows go
// through shared memory), stores it bf16 into a swizzled K-major (tokens
// contiguous) 64 x 128 tile, and accumulates its own 192 columns of
// dW[64, 192] += dlogits^T[64, 128] . x[tile, own 192 columns] (m64n192,
// x MN-major: trans-b). db sums the f32 dlogits^T before the rounding:
// two running row sums a thread, a quad shuffle and the two warpgroups'
// halves through shared memory at the end, written by the slice-0 CTAs.
// Shared memory: B5's 4 stages x 24 KB, the 96 KB slice buffer and two
// 16 KB dlogits tiles leave 3 KB for the token rows, over the 227 KB a
// block may have with the barriers and the alignment slack; the rows
// are single-buffered instead (1.5 KB): a warpgroup writes the next
// tile's rows only after the named barrier that ends this tile's
// dlogits, which every reader of this tile's rows has passed.
//
// fwd is the first, simple design: bf16 WMMA (16x16x16, f32
// accumulation) from x and W tiles streamed over D in 32-column chunks
// (cp.async, double-buffered) into a logits block kept in shared memory
// and consumed there (logits_tile): a CTA owns 64 tokens and walks every
// 128-column vocab tile, with the running (m, l, gold, lsum, best,
// argmax) of its rows in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 32;            // D columns per chunk of the logits product
constexpr int KPAD = KC + 8;      // shared-memory row stride of a chunk (bf16)
constexpr float NEG_INF = -1e30f;  // large-finite, as the JAX kernels
constexpr int INT_BIG = 1 << 30;

// fwd: 64 tokens x 128 vocab columns.
constexpr int XT = 64, XV = 128;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
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
// The Hopper design (see the note at the top). Grid (ceil(T / 64),
// ceil(D / 384)); one CTA per (64 tokens, 384-column D slice), walking
// every vocab tile of 128 columns.

namespace hdx {

constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int TM = 64;                  // tokens per CTA (both warpgroups)
constexpr int BV = 128;                 // vocab columns per tile
constexpr int HV = BV / CONSUMERS;      // logits columns per warpgroup
constexpr int KC = 64;                  // D columns per logits chunk (one swizzle atom)
constexpr int DSL = 384;                // D columns of dx per CTA
constexpr int HD = DSL / CONSUMERS;     // dx columns per warpgroup
constexpr int STAGES = 4;
constexpr int ATOM = 128;               // bytes per swizzled row
constexpr int X_BYTES = TM * KC * 2;
constexpr int STAGE_BYTES = X_BYTES + BV * KC * 2;
constexpr int WS_ATOM = BV * ATOM;      // W[tile, 64 columns of the slice]
constexpr int WS_BYTES = (DSL / 64) * WS_ATOM;
constexpr int DL_ATOM = TM * ATOM;      // dlogits[64 tokens, 64 vocab columns]
constexpr int DL_BYTES = (BV / 64) * DL_ATOM;
constexpr int WS_OFF = STAGES * STAGE_BYTES;
constexpr int DL_OFF = WS_OFF + WS_BYTES;      // two dlogits tiles
constexpr int BIAS_OFF = DL_OFF + 2 * DL_BYTES;  // two [BV] f32 bias rows
constexpr int BAR_OFF = BIAS_OFF + 2 * BV * 4;
constexpr int SMEM = BAR_OFF + (2 * STAGES + 2) * 8 + 1024;  // + alignment slack
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(THREADS, 1)
fused_ce_dx_hopper(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                   const float* __restrict__ b, const int* __restrict__ t,
                   const float* __restrict__ lse, const float* __restrict__ coef,
                   bf16* __restrict__ dx, int T, int D, int V, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* ws_full = empty + STAGES;
  uint64_t* ws_empty = ws_full + 1;
  unsigned char* ws = smem + WS_OFF;

  const int tok0 = blockIdx.x * TM, d0 = blockIdx.y * DSL;
  const int nk = (D + KC - 1) / KC, nv = (V + BV - 1) / BV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
    }
    hopper::mbar_init(ws_full, 1);
    hopper::mbar_init(ws_empty, CONSUMERS * 4);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: per vocab tile, the x and W chunks of the logits
    // product through the stage ring and, once the ring is full ahead of
    // the consumers, W[tile, slice] for the dx product: its buffer is
    // freed when the previous tile's dx product completes, about when the
    // consumers start this tile's logits, and it lands while they compute
    // them.
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      int i = 0;
      for (int vt = 0; vt < nv; ++vt) {
        const int v0 = vt * BV;
        for (int c = 0; c < nk; ++c, ++i) {
          const int s = i % STAGES;
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], STAGE_BYTES);
          unsigned char* st = smem + s * STAGE_BYTES;
          hopper::tma_load_2d(st, &mx, &full[s], c * KC, tok0);
          hopper::tma_load_2d(st + X_BYTES, &mw, &full[s], c * KC, v0);
          if (c == min(STAGES, nk) - 1) {
            hopper::mbar_wait(ws_empty, (vt & 1) ^ 1);
            hopper::mbar_expect_tx(ws_full, WS_BYTES);
            for (int a = 0; a < DSL / 64; ++a)
              hopper::tma_load_2d(ws + a * WS_ATOM, &mw, ws_full, d0 + a * 64, v0);
          }
        }
      }
    }
  } else {
    // ---- consumers: the same 64 tokens; warpgroup h computes vocab
    // columns [64 h, 64 h + 64) of each tile's logits and owns dx columns
    // [192 h, 192 h + 192) of the slice.
    hopper::setmaxnreg_inc<240>();
    const int tt = threadIdx.x % 128, warp = tt / 32, lane = tt % 32;
    const int rr = warp * 16 + lane / 4;  // this thread's tile rows: rr and rr + 8
    int tg[2];
    float lse2[2], cf[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tok0 + rr + 8 * h;
      const bool ok = row < T;
      tg[h] = ok ? t[row] : -1;
      lse2[h] = ok ? lse[row] * LOG2E : 0.f;
      cf[h] = ok ? coef[row] : 0.f;
    }
    const float smooth = eps != 0.f ? eps / V : 0.f;

    float acc[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;

    int i = 0;
    for (int vt = 0; vt < nv; ++vt) {
      const int v0 = vt * BV, vh = v0 + wg * HV;  // this warpgroup's first vocab column
      float* sbias = reinterpret_cast<float*>(smem + BIAS_OFF) + (vt & 1) * BV + wg * HV;
      unsigned char* dl = smem + DL_OFF + (vt & 1) * DL_BYTES;

      // logits[64 tokens, 64 columns] = x W^T over D in 64-column chunks,
      // one wgmma group per chunk; a stage is released once the group
      // reading it has completed (the next group is issued by then).
      float lg[HV / 2];
      for (int c = 0; c < nk; ++c, ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&full[s], (i / STAGES) & 1);
        const unsigned char* st = smem + s * STAGE_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          hopper::Wgmma<HV, 0>::ss(lg, hopper::desc_sw128(st + kk * 32, 0),
                                   hopper::desc_sw128(st + X_BYTES + wg * HV * ATOM + kk * 32, 0),
                                   c > 0 || kk > 0);
        hopper::wgmma_commit();
        // The group before this one is done: release its stage.
        hopper::wgmma_wait<1>();
        if (lane == 0 && c > 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
        if (c == 0 && tt < HV)  // this warpgroup's bias columns, under the product
          sbias[tt] = (b != nullptr && vh + tt < V) ? __ldg(b + vh + tt) : 0.f;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(lg);
      if (lane == 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
      hopper::named_sync(2 + wg, 128);  // the bias columns are in

      // dlogits (the TPU _dlogits) in registers, rounded to bf16 and
      // stored as the K-major (vocab-contiguous) A operand of the dx
      // product: atom wg of the tile, rows 128 bytes, 16-byte chunks
      // swizzled as TMA's 128-byte swizzle (chunk ^ row % 8).
      unsigned char* dla = dl + wg * DL_ATOM;
#pragma unroll
      for (int n8 = 0; n8 < HV / 8; ++n8) {
        const int cc = 8 * n8 + 2 * (lane % 4);
        const float2 bias = *reinterpret_cast<const float2*>(sbias + cc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = vh + cc + e;
            d[e] = 0.f;
            if (tg[h] >= 0 && col < V) {
              const float z = lg[4 * n8 + 2 * h + e] + (e ? bias.y : bias.x);
              d[e] = hopper::exp2_approx(fmaf(z, LOG2E, -lse2[h]));
              if (col == tg[h]) d[e] -= 1.f - eps;
              d[e] = (d[e] - smooth) * cf[h];
            }
          }
          const int row = rr + 8 * h;
          *reinterpret_cast<uint32_t*>(dla + row * ATOM + ((n8 ^ (row & 7)) * 16) +
                                       (lane % 4) * 4) = hopper::pack_bf16(d[0], d[1]);
        }
      }
      hopper::fence_proxy_async();       // the stores, before wgmma reads them
      hopper::named_sync(1, CONSUMERS * 128);  // both halves of the tile are in

      // dx[64, 192] += dlogits[64, 128] . W[tile, own 192 columns]: A
      // K-major from the dlogits tile, B MN-major (trans-b) from the
      // slice; step kk reads vocab 16 kk.. of both.
      hopper::mbar_wait(ws_full, vt & 1);
      hopper::fence_operand(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BV / 16; ++kk)
        hopper::Wgmma<HD, 1>::ss(
            acc, hopper::desc_sw128(dl + (kk / 4) * DL_ATOM + (kk % 4) * 32, 0),
            hopper::desc_sw128(ws + wg * (HD / 64) * WS_ATOM + kk * 16 * ATOM, WS_ATOM), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      if (lane == 0) hopper::mbar_arrive(ws_empty);
    }

    // Epilogue: bf16 dx, rows >= T and columns >= D dropped (D % 8 == 0,
    // so a column pair is in or out together).
#pragma unroll
    for (int j = 0; j < HD / 2; j += 2) {
      const int row = tok0 + rr + 8 * ((j % 4) / 2);
      const int col = d0 + wg * HD + 8 * (j / 4) + 2 * (lane % 4);
      if (row < T && col < D)
        *reinterpret_cast<uint32_t*>(dx + (size_t)row * D + col) =
            hopper::pack_bf16(acc[j], acc[j + 1]);
    }
  }
}

cudaError_t launch(const void* x, const void* w, const void* b, const void* t, const void* lse,
                   const void* coef, void* dx, int T, int D, int V, float eps,
                   cudaStream_t stream) {
  CUtensorMap mx, mw;
  const uint64_t xdims[2] = {(uint64_t)D, (uint64_t)T}, wdims[2] = {(uint64_t)D, (uint64_t)V};
  const uint64_t str[1] = {(uint64_t)D * 2};
  const uint32_t xbox[2] = {KC, TM}, wbox[2] = {KC, BV};
  cudaError_t err = hopper::encode_bf16_map(&mx, x, 2, xdims, str, xbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mw, w, 2, wdims, str, wbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_ce_dx_hopper, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return err;
  fused_ce_dx_hopper<<<dim3((T + TM - 1) / TM, (D + DSL - 1) / DSL), THREADS, SMEM, stream>>>(
      mx, mw, (const float*)b, (const int*)t, (const float*)lse, (const float*)coef, (bf16*)dx,
      T, D, V, eps);
  return cudaGetLastError();
}

}  // namespace hdx

// ------------------------------------------------------------------- dW/db
// The Hopper design (see the note at the top). Grid (ceil(V / 64),
// ceil(D / 384)); one CTA per (64 vocab rows, 384-column D slice),
// walking every token tile of 128.

namespace hdw {

constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int TV = 64;                  // vocab rows per CTA (both warpgroups)
constexpr int BT = 128;                 // tokens per tile
constexpr int HT = BT / CONSUMERS;      // logits^T columns (tokens) per warpgroup
constexpr int KC = 64;                  // D columns per logits chunk (one swizzle atom)
constexpr int DSL = 384;                // D columns of dW per CTA
constexpr int HD = DSL / CONSUMERS;     // dW columns per warpgroup
constexpr int STAGES = 4;
constexpr int ATOM = 128;               // bytes per swizzled row
constexpr int W_BYTES = TV * KC * 2;
constexpr int STAGE_BYTES = W_BYTES + BT * KC * 2;
constexpr int XS_ATOM = BT * ATOM;      // x[tile, 64 columns of the slice]
constexpr int XS_BYTES = (DSL / 64) * XS_ATOM;
constexpr int DL_ATOM = TV * ATOM;      // dlogits^T[64 vocab rows, 64 tokens]
constexpr int DL_BYTES = (BT / 64) * DL_ATOM;
constexpr int XS_OFF = STAGES * STAGE_BYTES;
constexpr int DL_OFF = XS_OFF + XS_BYTES;          // two dlogits^T tiles
constexpr int ROW_OFF = DL_OFF + 2 * DL_BYTES;     // target, lse log2e, coef [BT] each
constexpr int BAR_OFF = ROW_OFF + 3 * BT * 4;
constexpr int SMEM = BAR_OFF + (2 * STAGES + 2) * 8 + 1024;  // + alignment slack
static_assert(SMEM <= 232448, "more shared memory than a block may have");
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(THREADS, 1)
fused_ce_dw_hopper(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                   const float* __restrict__ b, const int* __restrict__ t,
                   const float* __restrict__ lse, const float* __restrict__ coef,
                   float* __restrict__ dw, float* __restrict__ db, int T, int D, int V,
                   float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* xs_full = empty + STAGES;
  uint64_t* xs_empty = xs_full + 1;
  unsigned char* xs = smem + XS_OFF;

  const int v0 = blockIdx.x * TV, d0 = blockIdx.y * DSL;
  const int nk = (D + KC - 1) / KC, nt = (T + BT - 1) / BT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
    }
    hopper::mbar_init(xs_full, 1);
    hopper::mbar_init(xs_empty, CONSUMERS * 4);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: per token tile, the W and x chunks of the logits
    // product through the stage ring and, once the ring is full ahead of
    // the consumers, x[tile, slice] for the dW product (freed when the
    // previous tile's dW product completes).
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      int i = 0;
      for (int tt = 0; tt < nt; ++tt) {
        const int tok0 = tt * BT;
        for (int c = 0; c < nk; ++c, ++i) {
          const int s = i % STAGES;
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], STAGE_BYTES);
          unsigned char* st = smem + s * STAGE_BYTES;
          hopper::tma_load_2d(st, &mw, &full[s], c * KC, v0);
          hopper::tma_load_2d(st + W_BYTES, &mx, &full[s], c * KC, tok0);
          if (c == min(STAGES, nk) - 1) {
            hopper::mbar_wait(xs_empty, (tt & 1) ^ 1);
            hopper::mbar_expect_tx(xs_full, XS_BYTES);
            for (int a = 0; a < DSL / 64; ++a)
              hopper::tma_load_2d(xs + a * XS_ATOM, &mx, xs_full, d0 + a * 64, tok0);
          }
        }
      }
    }
  } else {
    // ---- consumers: the same 64 vocab rows; warpgroup h computes tokens
    // [64 h, 64 h + 64) of each tile's logits^T and owns dW columns
    // [192 h, 192 h + 192) of the slice.
    hopper::setmaxnreg_inc<240>();
    const int tt = threadIdx.x % 128, warp = tt / 32, lane = tt % 32;
    const int rr = warp * 16 + lane / 4;  // this thread's vocab rows: rr and rr + 8
    bool vok[2];
    float bias[2], dbs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = v0 + rr + 8 * h;
      vok[h] = row < V;
      bias[h] = (b != nullptr && vok[h]) ? __ldg(b + row) : 0.f;
    }
    const float smooth = eps != 0.f ? eps / V : 0.f;
    int* stg = reinterpret_cast<int*>(smem + ROW_OFF);
    float* slse = reinterpret_cast<float*>(stg + BT);
    float* scf = slse + BT;

    float acc[HD / 2];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) acc[j] = 0.f;

    int i = 0;
    for (int ti = 0; ti < nt; ++ti) {
      const int tok0 = ti * BT, th = wg * HT;  // this warpgroup's first token of the tile
      unsigned char* dl = smem + DL_OFF + (ti & 1) * DL_BYTES;

      // logits^T[64 vocab, 64 tokens] = W x^T over D in 64-column
      // chunks, one wgmma group per chunk; a stage is released once the
      // group reading it has completed (the next group is issued by then).
      float lg[HT / 2];
      for (int c = 0; c < nk; ++c, ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&full[s], (i / STAGES) & 1);
        const unsigned char* st = smem + s * STAGE_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          hopper::Wgmma<HT, 0>::ss(lg, hopper::desc_sw128(st + kk * 32, 0),
                                   hopper::desc_sw128(st + W_BYTES + th * ATOM + kk * 32, 0),
                                   c > 0 || kk > 0);
        hopper::wgmma_commit();
        // The group before this one is done: release its stage.
        hopper::wgmma_wait<1>();
        if (lane == 0 && c > 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
        if (c == 0 && tt < HT) {  // this warpgroup's token rows, under the product
          const int row = tok0 + th + tt;
          const bool ok = row < T;
          stg[th + tt] = ok ? __ldg(t + row) : -1;
          slse[th + tt] = ok ? __ldg(lse + row) * LOG2E : 0.f;
          scf[th + tt] = ok ? __ldg(coef + row) : 0.f;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(lg);
      if (lane == 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
      hopper::named_sync(2 + wg, 128);  // the token rows are in

      // dlogits^T (the TPU _dlogits) in registers; db sums it in f32, the
      // dW product takes it rounded to bf16, stored K-major (tokens
      // contiguous): atom wg of the tile, rows 128 bytes, 16-byte chunks
      // swizzled as TMA's 128-byte swizzle (chunk ^ row % 8).
      unsigned char* dla = dl + wg * DL_ATOM;
#pragma unroll
      for (int n8 = 0; n8 < HT / 8; ++n8) {
        const int cc = th + 8 * n8 + 2 * (lane % 4);
        const int2 tg = *reinterpret_cast<const int2*>(stg + cc);
        const float2 l2 = *reinterpret_cast<const float2*>(slse + cc);
        const float2 cf = *reinterpret_cast<const float2*>(scf + cc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int vrow = v0 + rr + 8 * h;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tgt = e ? tg.y : tg.x;
            d[e] = 0.f;
            if (tgt >= 0 && vok[h]) {
              d[e] = hopper::exp2_approx(fmaf(lg[4 * n8 + 2 * h + e] + bias[h], LOG2E,
                                              -(e ? l2.y : l2.x)));
              if (vrow == tgt) d[e] -= 1.f - eps;
              d[e] = (d[e] - smooth) * (e ? cf.y : cf.x);
            }
            dbs[h] += d[e];
          }
          const int row = rr + 8 * h;
          *reinterpret_cast<uint32_t*>(dla + row * ATOM + ((n8 ^ (row & 7)) * 16) +
                                       (lane % 4) * 4) = hopper::pack_bf16(d[0], d[1]);
        }
      }
      hopper::fence_proxy_async();       // the stores, before wgmma reads them
      hopper::named_sync(1, CONSUMERS * 128);  // both halves of the tile are in

      // dW[64, 192] += dlogits^T[64, 128] . x[tile, own 192 columns]: A
      // K-major from the dlogits^T tile, B MN-major (trans-b) from the
      // slice; step kk reads tokens 16 kk.. of both.
      hopper::mbar_wait(xs_full, ti & 1);
      hopper::fence_operand(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        hopper::Wgmma<HD, 1>::ss(
            acc, hopper::desc_sw128(dl + (kk / 4) * DL_ATOM + (kk % 4) * 32, 0),
            hopper::desc_sw128(xs + wg * (HD / 64) * XS_ATOM + kk * 16 * ATOM, XS_ATOM), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      if (lane == 0) hopper::mbar_arrive(xs_empty);
    }

    // Epilogue: f32 dW, rows >= V and columns >= D dropped (D % 8 == 0,
    // so a column pair is in or out together).
#pragma unroll
    for (int j = 0; j < HD / 2; j += 2) {
      const int row = v0 + rr + 8 * ((j % 4) / 2);
      const int col = d0 + wg * HD + 8 * (j / 4) + 2 * (lane % 4);
      if (row < V && col < D)
        *reinterpret_cast<float2*>(dw + (size_t)row * D + col) = make_float2(acc[j], acc[j + 1]);
    }
    // db: a row's sum lives in one quad of each warpgroup; the two
    // halves meet in shared memory (the token rows are no longer read).
    float* part = slse;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 1);
      dbs[h] += __shfl_xor_sync(0xffffffffu, dbs[h], 2);
      if (lane % 4 == 0) part[wg * TV + rr + 8 * h] = dbs[h];
    }
    hopper::named_sync(1, CONSUMERS * 128);
    if (db != nullptr && blockIdx.y == 0 && wg == 0 && tt < TV && v0 + tt < V)
      db[v0 + tt] = part[tt] + part[TV + tt];
  }
}

cudaError_t launch(const void* x, const void* w, const void* b, const void* t, const void* lse,
                   const void* coef, void* dw, void* db, int T, int D, int V, float eps,
                   cudaStream_t stream) {
  CUtensorMap mx, mw;
  const uint64_t xdims[2] = {(uint64_t)D, (uint64_t)T}, wdims[2] = {(uint64_t)D, (uint64_t)V};
  const uint64_t str[1] = {(uint64_t)D * 2};
  const uint32_t xbox[2] = {KC, BT}, wbox[2] = {KC, TV};
  cudaError_t err = hopper::encode_bf16_map(&mx, x, 2, xdims, str, xbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mw, w, 2, wdims, str, wbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_ce_dw_hopper, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return err;
  fused_ce_dw_hopper<<<dim3((V + TV - 1) / TV, (D + DSL - 1) / DSL), THREADS, SMEM, stream>>>(
      mx, mw, (const float*)b, (const int*)t, (const float*)lse, (const float*)coef, (float*)dw,
      (float*)db, T, D, V, eps);
  return cudaGetLastError();
}

}  // namespace hdw

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
  return hdx::launch(x, w, b, t, lse, coef, dx, T, D, V, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int tfd_fused_ce_dw(const void* x, const void* w, const void* b, const void* t,
                               const void* lse, const void* coef, void* dw, void* db, int T,
                               int D, int V, float eps, void* stream) {
  return hdw::launch(x, w, b, t, lse, coef, dw, db, T, D, V, eps,
                     static_cast<cudaStream_t>(stream));
}
