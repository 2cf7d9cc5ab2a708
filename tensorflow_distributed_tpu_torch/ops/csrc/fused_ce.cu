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
// fwd is the Hopper design, fused_ce_fwd_hopper: a CTA owns 64 tokens
// and walks every 256-column vocab tile, with three warpgroups. The
// producer (registers cut to 24 by setmaxnreg) has one thread issue TMA
// loads: per vocab tile, the x[64 tokens, 64 D columns] and W[256 rows,
// 64 columns] chunks into a 4-stage ring under full/empty mbarriers (no
// D slice and no dlogits tile; five stages fit but ran slower). The two
// consumer warpgroups (registers raised to 240) share the x chunks:
// warpgroup h computes vocab columns [128 h, 128 h + 128) of each tile's
// logits with wgmma m64n128k16 from shared memory (both operands
// K-major) into registers and keeps its rows' statistics there: the
// running max m and exp-sum l in log2 units (2^x is one ex2.approx), the
// gold logit, the logit sum (eps != 0 only) and the running max with its
// first column. A row lives in one quad, so a row's max is two shfl.xor
// steps; the bias comes through shared memory, loaded under the product;
// columns >= V are NEG_INF on the vocab tail tile only. Nothing is
// shared between the consumers until the end of the CTA, where
// warpgroup 1 hands its rows to warpgroup 0 through shared memory, which
// merges them (m, l rescaled to the larger m; gold and lsum added; the
// larger max wins, an exact tie the smaller column: the JAX kernel's
// first max) and writes ce, correct and lse. At T 8192 the grid is 128
// CTAs for 132 SMs.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;  // large-finite, as the JAX kernels
constexpr int INT_BIG = 1 << 30;

// ---------------------------------------------------------------- forward
// The Hopper design (see the note at the top). Grid (ceil(T / 64)); one
// CTA per 64 tokens, walking every vocab tile of 256 columns.

namespace hfw {

constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int TM = 64;                  // tokens per CTA (both warpgroups)
constexpr int BV = 256;                 // vocab columns per tile
constexpr int HV = BV / CONSUMERS;      // logits columns per warpgroup
constexpr int KC = 64;                  // D columns per chunk (one swizzle atom)
constexpr int STAGES = 4;
constexpr int ATOM = 128;               // bytes per swizzled row
constexpr int X_BYTES = TM * KC * 2;
constexpr int STAGE_BYTES = X_BYTES + BV * KC * 2;
constexpr int BIAS_OFF = STAGES * STAGE_BYTES;  // two [BV] f32 bias rows
constexpr int ROW_OFF = BIAS_OFF + 2 * BV * 4;  // the second warpgroup's row statistics
constexpr int NSTAT = 6;                        // m, l, gold, lsum, best, argmax
constexpr int BAR_OFF = ROW_OFF + NSTAT * TM * 4;
constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
static_assert(SMEM <= 232448, "more shared memory than a block may have");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_ce_fwd_hopper(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                    const float* __restrict__ b, const int* __restrict__ t,
                    float* __restrict__ ce, float* __restrict__ correct, float* __restrict__ lse,
                    int T, int D, int V, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tok0 = blockIdx.x * TM;
  const int nk = (D + KC - 1) / KC, nv = (V + BV - 1) / BV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: per vocab tile, the x and W chunks of the logits
    // product through the stage ring.
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      int i = 0;
      for (int vt = 0; vt < nv; ++vt) {
        for (int c = 0; c < nk; ++c, ++i) {
          const int s = i % STAGES;
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], STAGE_BYTES);
          unsigned char* st = smem + s * STAGE_BYTES;
          hopper::tma_load_2d(st, &mx, &full[s], c * KC, tok0);
          hopper::tma_load_2d(st + X_BYTES, &mw, &full[s], c * KC, vt * BV);
        }
      }
    }
  } else {
    // ---- consumers: the same 64 tokens; warpgroup h computes vocab
    // columns [128 h, 128 h + 128) of each tile and keeps its own running
    // statistics of its two rows a thread; the two meet once, at the end.
    hopper::setmaxnreg_inc<240>();
    const int tt = threadIdx.x % 128, warp = tt / 32, lane = tt % 32;
    const int rr = warp * 16 + lane / 4;  // this thread's tile rows: rr and rr + 8
    int tg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tok0 + rr + 8 * h;
      tg[h] = row < T ? __ldg(t + row) : -1;
    }
    // m (log2 units) is quad-uniform, as are best and arg; l, gold and
    // lsum are this thread's columns' parts, summed over the quad at the end.
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
    float lsum[2] = {0.f, 0.f}, best[2] = {NEG_INF, NEG_INF};
    int arg[2] = {-1, -1};
    const bool smooth = eps != 0.f;

    int i = 0;
    for (int vt = 0; vt < nv; ++vt) {
      const int vh = vt * BV + wg * HV;  // this warpgroup's first vocab column
      float* sbias = reinterpret_cast<float*>(smem + BIAS_OFF) + (vt & 1) * BV + wg * HV;

      // logits[64 tokens, 128 columns] = x W^T over D in 64-column chunks,
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
        if (c == 0)  // this warpgroup's bias columns, under the product
          sbias[tt] = (b != nullptr && vh + tt < V) ? __ldg(b + vh + tt) : 0.f;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operand(lg);
      if (lane == 0) hopper::mbar_arrive(&empty[(i - 1) % STAGES]);
      hopper::named_sync(2 + wg, 128);  // the bias columns are in

      // The tile's logits (the TPU _block_logits: + bias; columns >= V
      // NEG_INF, only on the vocab tail), their row max and logit sum.
      const bool tail = vh + HV > V;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n8 = 0; n8 < HV / 8; ++n8) {
        const int cc = 8 * n8 + 2 * (lane % 4);
        const float2 bias = *reinterpret_cast<const float2*>(sbias + cc);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 4 * n8 + 2 * h + e;
            float z = lg[j] + (e ? bias.y : bias.x);
            if (tail && vh + cc + e >= V)
              z = NEG_INF;
            else if (smooth)
              lsum[h] += z;
            lg[j] = z;
            mx[h] = fmaxf(mx[h], z);
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);

      // First-max argmax: a later tile wins only with a strictly larger
      // max; within the tile the smallest column among the maxima.
      const bool up0 = mx[0] > best[0], up1 = mx[1] > best[1];
      if (__any_sync(0xffffffffu, up0 || up1)) {
        int idx[2] = {INT_BIG, INT_BIG};
#pragma unroll
        for (int j = HV / 2 - 1; j >= 0; --j) {
          const int h = (j % 4) / 2;
          if (lg[j] == mx[h]) idx[h] = 8 * (j / 4) + 2 * (lane % 4) + (j % 2);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          idx[h] = min(idx[h], __shfl_xor_sync(0xffffffffu, idx[h], 1));
          idx[h] = min(idx[h], __shfl_xor_sync(0xffffffffu, idx[h], 2));
        }
        if (up0) {
          best[0] = mx[0];
          arg[0] = vh + idx[0];
        }
        if (up1) {
          best[1] = mx[1];
          arg[1] = vh + idx[1];
        }
      }

      // Gold logit: the target column lies in at most one tile.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tc = tg[h] - vh;
        if (tc >= 0 && tc < HV && tg[h] < V) {
#pragma unroll
          for (int j = 0; j < HV / 2; ++j)
            if ((j % 4) / 2 == h && 8 * (j / 4) + 2 * (lane % 4) + (j % 2) == tc) gold[h] = lg[j];
        }
      }

      // Online logsumexp in log2 units (the flash recurrence).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], mx[h] * LOG2E);
        l[h] *= hopper::exp2_approx(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < HV / 2; ++j) {
        const int h = (j % 4) / 2;
        l[h] += hopper::exp2_approx(fmaf(lg[j], LOG2E, -m[h]));
      }
    }

    // End of the CTA: the quads sum their parts; warpgroup 1 hands its
    // rows to warpgroup 0 through shared memory, which merges and writes.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      gold[h] = quad_sum(gold[h]);
      lsum[h] = quad_sum(lsum[h]);
    }
    float* rows = reinterpret_cast<float*>(smem + ROW_OFF);
    if (wg == 1 && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rr + 8 * h;
        rows[r] = m[h];
        rows[TM + r] = l[h];
        rows[2 * TM + r] = gold[h];
        rows[3 * TM + r] = lsum[h];
        rows[4 * TM + r] = best[h];
        reinterpret_cast<int*>(rows)[5 * TM + r] = arg[h];
      }
    }
    hopper::named_sync(1, CONSUMERS * 128);
    if (wg == 0 && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rr + 8 * h, row = tok0 + r;
        if (row >= T) continue;
        const float m1 = rows[r], b1 = rows[4 * TM + r];
        const int a1 = reinterpret_cast<const int*>(rows)[5 * TM + r];
        const float mm = fmaxf(m[h], m1);
        const float ll = l[h] * exp2f(m[h] - mm) + rows[TM + r] * exp2f(m1 - mm);
        // Equal maxima: the smaller column, the JAX kernel's first max.
        const int am = (b1 > best[h] || (b1 == best[h] && a1 >= 0 && a1 < arg[h])) ? a1 : arg[h];
        const float lse_r = (mm + log2f(ll)) * LN2;
        float g = gold[h] + rows[2 * TM + r];
        if (smooth) g = (1.f - eps) * g + (eps / V) * (lsum[h] + rows[3 * TM + r]);
        ce[row] = lse_r - g;
        correct[row] = am == tg[h] ? 1.f : 0.f;
        lse[row] = lse_r;
      }
    }
  }
}

cudaError_t launch(const void* x, const void* w, const void* b, const void* t, void* ce,
                   void* correct, void* lse, int T, int D, int V, float eps, cudaStream_t stream) {
  CUtensorMap mx, mw;
  const uint64_t xdims[2] = {(uint64_t)D, (uint64_t)T}, wdims[2] = {(uint64_t)D, (uint64_t)V};
  const uint64_t str[1] = {(uint64_t)D * 2};
  const uint32_t xbox[2] = {KC, TM}, wbox[2] = {KC, BV};
  cudaError_t err = hopper::encode_bf16_map(&mx, x, 2, xdims, str, xbox);
  if (err == cudaSuccess) err = hopper::encode_bf16_map(&mw, w, 2, wdims, str, wbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_ce_fwd_hopper, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return err;
  fused_ce_fwd_hopper<<<dim3((T + TM - 1) / TM), THREADS, SMEM, stream>>>(
      mx, mw, (const float*)b, (const int*)t, (float*)ce, (float*)correct, (float*)lse, T, D, V,
      eps);
  return cudaGetLastError();
}

}  // namespace hfw

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

}  // namespace

// ------------------------------------------------------------ C interface
// Each returns the CUDA error of the launch (0 = launched). Pointers are
// device pointers (b and db may be null: a head without bias); `stream`
// is a cudaStream_t. T, D, V >= 1 and D % 8 == 0 (the wrappers check).

extern "C" int tfd_fused_ce_fwd(const void* x, const void* w, const void* b, const void* t,
                                void* ce, void* correct, void* lse, int T, int D, int V,
                                float eps, void* stream) {
  return hfw::launch(x, w, b, t, ce, correct, lse, T, D, V, eps,
                     static_cast<cudaStream_t>(stream));
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
