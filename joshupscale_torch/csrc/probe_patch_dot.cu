// P2: the conv probe's in-kernel 9-tap patch build + product.
//
// For output row R = i*tile_rows + r (i < steps, r < tile_rows), with
// t = 3*dy + dx and halo = 2*pw + 2:
//   y1[r] = bf16(relu(sum_t x[dy*pw + dx + r] @ w1[64t : 64t + 64]))
//   single: y[R] = y1[r]
//   pair:   y[R] = bf16(bf16(concat([y1[r]] * 9) @ w2) + x[halo + pw + 1 + r])
// with f32 accumulation and the last add rounded in bf16.  Every step i
// reads the same input rows: the probe measures cost, it does not
// compute a conv of a frame.
//
// Replaces the TPU kernel tools/pallas_conv_probe.py probe_patch_dot ->
// kernel.  What it computes is kept; its layout is not: the Pallas
// kernel assembled the (tile_rows, 576) patch in a VMEM scratch with
// lane-slice stores to get around a Mosaic lowering error.  Here the
// patch is never built: the three dx taps of a dy are the same staged
// rows shifted by one.  Layouts: x (rows, 64), w1 and w2 (576, 64),
// y (steps*tile_rows, 64), all bf16 row-major.
//
// What bounds it on an H100: at the probe's shape (tile_rows 2416,
// 53 steps, 128,048 output rows) 9.44 GFLOP a product against 17 MB
// (the output; x is 557 KB): operations, 9.5 us (19.1 us for the pair)
// at 989 TFLOP/s.  Design (simple first):
//   * a persistent grid walks work items of 128 output rows; a step's
//     rows are cut into ceil(tile_rows / 128) items, so an item never
//     straddles two steps;
//   * w1 stays resident in shared memory, and in pair mode w2 as well
//     (576 x 72 bf16 = 82,944 B each; chosen over streaming w2 because
//     it fits: 221,760 B in all with the staging below);
//   * for each dy the CTA stages x rows [dy*pw + r0, dy*pw + r0 + 130)
//     (rows padded by 8, zero-filled past what the item needs) through a
//     2-buffer cp.async ring, so the next dy's rows load while this
//     one's three dx taps run on mma.sync.m16n8k16;
//   * 8 warps, 4 along rows x 2 along columns, 32 x 32 outputs each;
//   * pair: relu -> bf16 y1 into shared memory, then the full K = 576
//     second product over the nine copies of y1 (w2's blocks are not
//     summed first: that would change the rounding and the cost), then
//     bf16, then the bf16 residual add with x read from global memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int C = 64;
constexpr int TAPS = 9;
constexpr int KP = TAPS * C;      // 576
constexpr int BM = 128;           // output rows per work item
constexpr int PAD = 8;
constexpr int LD = C + PAD;       // row stride of every shared array
constexpr int XROWS = BM + 2;     // staged x rows per dy
constexpr int W_ELEMS = KP * LD;
constexpr int X_ELEMS = XROWS * LD;
constexpr int Y_ELEMS = BM * LD;
constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

template <bool PAIR>
constexpr size_t smem_bytes() {
  return size_t((PAIR ? 2 : 1) * W_ELEMS + 2 * X_ELEMS +
                (PAIR ? Y_ELEMS : 0)) *
         sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.0f;
}

template <bool PAIR>
__global__ void __launch_bounds__(THREADS, 1)
probe_patch_dot_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w1,
                       const __nv_bfloat16* __restrict__ w2,
                       __nv_bfloat16* __restrict__ y, int tile_rows,
                       int steps, int pw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w2s = w1s + W_ELEMS;                    // PAIR only
  __nv_bfloat16* xs = w1s + (PAIR ? 2 : 1) * W_ELEMS;    // [2][XROWS][LD]
  __nv_bfloat16* ys = xs + 2 * X_ELEMS;                  // PAIR only

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;

  for (int i = tid; i < KP * (C / 8); i += THREADS) {
    const int k = i / (C / 8);
    const int v = i % (C / 8);
    jt::cp_async16(w1s + k * LD + v * 8, w1 + k * C + v * 8, true);
    if (PAIR) jt::cp_async16(w2s + k * LD + v * 8, w2 + k * C + v * 8, true);
  }

  const int per_step = (tile_rows + BM - 1) / BM;
  const int items = steps * per_step;
  const int my_items =
      int(blockIdx.x) < items
          ? (items - 1 - int(blockIdx.x)) / int(gridDim.x) + 1
          : 0;
  const int total = my_items * 3;  // one pipeline stage per (item, dy)

  // Stage s: rows dy*pw + r0 + j, j < XROWS, of item s / 3, dy = s % 3.
  auto load_stage = [&](int s) {
    const int item = blockIdx.x + (s / 3) * gridDim.x;
    const int r0 = (item % per_step) * BM;
    const int need = min(BM, tile_rows - r0) + 2;
    const __nv_bfloat16* src = x + size_t((s % 3) * pw + r0) * C;
    __nv_bfloat16* dst = xs + (s & 1) * X_ELEMS;
    for (int i = tid; i < XROWS * (C / 8); i += THREADS) {
      const int j = i / (C / 8);
      const int v = i % (C / 8);
      const bool valid = j < need;
      jt::cp_async16(dst + j * LD + v * 8, valid ? src + j * C + v * 8 : x,
                     valid);
    }
  };

  if (total > 0) load_stage(0);
  jt::cp_async_commit();  // with the weights

  float acc[2][4][4];
  for (int s = 0; s < total; ++s) {
    const int dy = s % 3;
    if (dy == 0) zero(acc);
    // Stage s (and the weights) have landed; every warp is done with
    // stage s - 1, whose buffer the prefetch below refills.
    jt::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < total) load_stage(s + 1);
    jt::cp_async_commit();

    const __nv_bfloat16* xt = xs + (s & 1) * X_ELEMS + wm * LD;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      jt::warp_tile_mma<4>(acc, xt + dx * LD, LD,
                           w1s + (dy * 3 + dx) * C * LD + wn, LD, C / 16,
                           lane);
    if (dy != 2) continue;

    const int item = blockIdx.x + (s / 3) * gridDim.x;
    const int r0 = (item % per_step) * BM;
    const int rows = min(BM, tile_rows - r0);
    const size_t out0 = size_t(item / per_step) * tile_rows + r0;
    if (!PAIR) {
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm + mf * 16 + g + half * 8;
          if (r >= rows) continue;
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
            *reinterpret_cast<__nv_bfloat162*>(
                y + (out0 + r) * C + wn + nf * 8 + 2 * t) =
                __floats2bfloat162_rn(fmaxf(acc[mf][nf][half * 2], 0.0f),
                                      fmaxf(acc[mf][nf][half * 2 + 1], 0.0f));
        }
      continue;
    }

    // Pair: y1 = bf16(relu(acc)) into shared memory, all 64 columns of
    // a row are needed by both column warps.
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + mf * 16 + g + half * 8;
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
          *reinterpret_cast<__nv_bfloat162*>(ys + r * LD + wn + nf * 8 +
                                             2 * t) =
              __floats2bfloat162_rn(fmaxf(acc[mf][nf][half * 2], 0.0f),
                                    fmaxf(acc[mf][nf][half * 2 + 1], 0.0f));
      }
    __syncthreads();
    float acc2[2][4][4];
    zero(acc2);
#pragma unroll 1
    for (int tap = 0; tap < TAPS; ++tap)
      jt::warp_tile_mma<4>(acc2, ys + wm * LD, LD, w2s + tap * C * LD + wn,
                           LD, C / 16, lane);
    const __nv_bfloat16* res = x + size_t(2 * pw + 2 + pw + 1 + r0) * C;
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + mf * 16 + g + half * 8;
        if (r >= rows) continue;
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          const int col = wn + nf * 8 + 2 * t;
          const __nv_bfloat162 y2 = __floats2bfloat162_rn(
              acc2[mf][nf][half * 2], acc2[mf][nf][half * 2 + 1]);
          const __nv_bfloat162 xr =
              *reinterpret_cast<const __nv_bfloat162*>(res + r * C + col);
          *reinterpret_cast<__nv_bfloat162*>(y + (out0 + r) * C + col) =
              __floats2bfloat162_rn(
                  __bfloat162float(y2.x) + __bfloat162float(xr.x),
                  __bfloat162float(y2.y) + __bfloat162float(xr.y));
        }
      }
  }
  jt::cp_async_wait<0>();
}

template <bool PAIR>
cudaError_t launch(const void* x, const void* w1, const void* w2, void* y,
                   int tile_rows, int steps, int pw, cudaStream_t stream) {
  static int grid_cap[MAX_DEVICES] = {};
  cudaError_t e;
  const int cap = jt::persistent_grid(probe_patch_dot_kernel<PAIR>, THREADS,
                                      smem_bytes<PAIR>(), grid_cap,
                                      MAX_DEVICES, &e);
  if (cap == 0) return e;
  const int items = steps * ((tile_rows + BM - 1) / BM);
  const int grid = items < cap ? items : cap;
  probe_patch_dot_kernel<PAIR><<<grid, THREADS, smem_bytes<PAIR>(), stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<__nv_bfloat16*>(y),
      tile_rows, steps, pw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, 64), w1 and w2 (576, 64), y (steps * tile_rows, 64), bf16
// row-major; w2 is read in pair mode only.  x must hold the rows the
// probe reads (tile_rows + 2*pw + 2, plus pw + 1 in pair mode): the
// caller checks.  Returns the cudaError_t after the launch.
int jt_probe_patch_dot(const void* x, const void* w1, const void* w2,
                       void* y, int tile_rows, int steps, int pw, int pair,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_rows <= 0 || steps <= 0 || pw <= 0 || (pair && w2 == nullptr))
    return int(cudaErrorInvalidValue);
  if (pair) return int(launch<true>(x, w1, w2, y, tile_rows, steps, pw, st));
  return int(launch<false>(x, w1, w2, y, tile_rows, steps, pw, st));
}

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
