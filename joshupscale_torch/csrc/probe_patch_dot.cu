// P2: the conv probe's 9-tap patch product, for Hopper (sm_90a).
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
// patch is never built.  Layouts: x (rows, 64), w1 and w2 (576, 64),
// y (steps*tile_rows, 64), all bf16 row-major.
//
// What bounds it on an H100: at the probe's shape (tile_rows 2416,
// 53 steps, 128,048 output rows) 9.44 GFLOP a product against 17 MB
// (the output; x is 557 KB): operations, 9.5 us (19.1 us for the pair)
// at 989 TFLOP/s.  Only wgmma reaches that rate.  Design, on the Hopper
// core of wgmma_tma.cuh (the structure of K1, resblock_conv.cu):
//   * Work items of 64 output rows (one wgmma M-block) of one step.  A
//     step's rows are cut into ceil(tile_rows / 64) row chunks and the
//     items are numbered chunk-major (every step of chunk 0, then of
//     chunk 1, ...).  A persistent grid (one CTA an SM) splits them into
//     contiguous ranges, so a CTA meets one or two chunks at the probe's
//     shape.
//   * The TPU kernel's residency, kept: the Pallas call holds all of x in
//     VMEM for every grid step.  Here a CTA holds, for its current row
//     chunk at r0, the three dy windows, x rows [dy*pw + r0, +66) (a
//     "window set"), and in pair mode the residual rows
//     [halo + pw + 1 + r0, +66), in shared memory, and w1 (and w2) for
//     the whole launch.  Every step's products are still computed: each
//     item issues all of its wgmma on the resident rows; no item copies
//     another's result.
//   * TMA does every copy.  One producer thread loads the weights once
//     and each chunk's window set and residual rows (boxes of 66 rows x 64
//     channels = 128 bytes, 128-byte swizzled; rows past x arrive as
//     zeros).  Two window sets are in flight: in the pair a warpgroup's
//     second product waits for the other's first product of the next
//     item, which may lie in the next chunk, so that chunk's windows must
//     load while this one's are still in use.  The residual is read only
//     by the epilogue and has a slot and barriers of its own.  Each item leaves
//     by one TMA store from a swizzled staging tile through a 3-D output
//     map (64, tile_rows, steps): the box clips at the step's end, so a
//     ragged last chunk never writes into the next step's rows.
//   * Taps are descriptor offsets; no patch is built.  The A operand of
//     tap (dy, dx) is the dy window with the descriptor's start moved by
//     dx 128-byte rows (the swizzle follows the absolute address, see
//     wgmma_tma.cuh), k16 steps by 32 bytes.  The weights are the
//     MN-major B operand, as stored ((K, N) row-major, trans-b = 1).
//   * Two consumer warpgroups in ping-pong take alternate items and turns
//     to issue their products, so one's epilogue runs under the other's
//     products.
//   * Pair: y1 stays in registers.  bf16_rn(relu(acc)) is packed straight
//     into wgmma's A register fragments (the m64n64 accumulator's layout
//     is theirs), and the second product is 36 wgmma "RS" (A from
//     registers): nine copies of y1 against w2's nine blocks (the blocks
//     are not summed first: that would change the rounding and the
//     cost), reading only w2 from shared memory.  An item is two turns,
//     one for each product.  The epilogue adds the resident residual.
// Shared memory, bytes: w1 73,728 (+ w2 73,728); two window sets of 3
// slots of 9,216 (66 rows of 128 bytes, padded to stay 1024-byte aligned
// for the swizzle); pair: a residual slot of 9,216; staging tiles of
// 8,192, two a warpgroup (pair: one, to fit); barriers; up to 1,024 of
// alignment.  Single 161,792, pair 228,352, + 1,024 + barriers, of the
// 232,448 a CTA may use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int C = 64;                     // channels: one 128-byte row
constexpr int ROW_BYTES = C * 2;
constexpr int TAPS = 9;
constexpr int KP = TAPS * C;              // 576
constexpr int BM = 64;                    // output rows per work item
constexpr int WIN_ROWS = BM + 2;          // x rows per window
constexpr int SLOT = (WIN_ROWS * ROW_BYTES + 1023) / 1024 * 1024;  // 9,216
constexpr int TAP_BYTES = C * ROW_BYTES;  // one 64 x 64 block of w
constexpr int W_BYTES = KP * ROW_BYTES;   // 73,728
constexpr int W_BOX_ROWS = 192;           // 3 TMA boxes per weight
constexpr int TILE_BYTES = BM * ROW_BYTES;  // staging, 8,192
constexpr int CONSUMERS = 2;              // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int SETS = 2;                   // window sets in flight
constexpr int SET_BYTES = 3 * SLOT;       // windows dy = 0, 1, 2
constexpr int MAX_DEVICES = 64;

template <bool PAIR>
struct Layout {
  static constexpr int WEIGHTS = PAIR ? 2 : 1;
  static constexpr int RES_BYTES = PAIR ? SLOT : 0;
  static constexpr int STAGING = PAIR ? 1 : 2;   // staging tiles a warpgroup
  static constexpr int TURNS = PAIR ? 2 : 1;     // turns to issue an item
  static constexpr size_t SMEM =
      1024 + size_t(WEIGHTS) * W_BYTES + size_t(SETS) * SET_BYTES +
      RES_BYTES + size_t(CONSUMERS) * STAGING * TILE_BYTES +
      (3 + 2 * SETS + CONSUMERS) * sizeof(uint64_t);
  static_assert(SLOT % 1024 == 0 && TILE_BYTES % 1024 == 0 &&
                    W_BYTES % 1024 == 0,
                "swizzled tiles must stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "over the shared memory of a CTA");
};

// Maps of one launch: x (windows), w1, w2 (B operands) and y (staging
// tiles); all bf16 with 128-byte rows, swizzled.
struct Maps {
  CUtensorMap x, w1, w2, y;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <bool PAIR>
__global__ void __launch_bounds__(THREADS, 1)
probe_patch_dot_kernel(const __grid_constant__ Maps maps, int tile_rows,
                       int steps, int pw) {
  using L = Layout<PAIR>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws = jt::align1024(smem_raw);  // w1 [, w2]
  unsigned char* sets = ws + L::WEIGHTS * W_BYTES;
  unsigned char* res = sets + SETS * SET_BYTES;  // pair only
  unsigned char* outs = res + L::RES_BYTES;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(
      outs + CONSUMERS * L::STAGING * TILE_BYTES);
  uint64_t* set_full = wbar + 1;         // a chunk's window set landed
  uint64_t* set_free = set_full + SETS;  // both warpgroups done with it
  uint64_t* res_full = set_free + SETS;  // pair: a chunk's residual landed
  uint64_t* res_free = res_full + 1;     // pair: both epilogues done with it
  uint64_t* turn = res_free + 1;         // a warpgroup's turn to issue

  const int tid = threadIdx.x;
  if (tid == 0) {
    jt::mbar_init(wbar, 1);
    for (int b = 0; b < SETS; ++b) {
      jt::mbar_init(&set_full[b], 1);
      jt::mbar_init(&set_free[b], CONSUMERS);
    }
    jt::mbar_init(res_full, 1);
    jt::mbar_init(res_free, CONSUMERS);
    for (int w = 0; w < CONSUMERS; ++w) jt::mbar_init(&turn[w], 1);
    jt::mbar_init_fence();
  }
  __syncthreads();

  // This CTA's items q0 .. q1 - 1: item q is rows [r0, r0 + 64) of step
  // q % steps, r0 = 64 (q / steps).  Its chunks c0, c0 + 1, ... are its
  // segments s = 0, 1, ..., each held in window set s % SETS (and the
  // residual slot).  The grid is at most the item count, so n >= 1.
  const int chunks = (tile_rows + BM - 1) / BM;
  const long long items = (long long)steps * chunks;
  const int q0 = int(items * blockIdx.x / gridDim.x);
  const int q1 = int(items * (blockIdx.x + 1) / gridDim.x);
  const int n = q1 - q0;
  const int c0 = q0 / steps;
  const int segs = (q1 - 1) / steps - c0 + 1;

  if (tid >= CONSUMERS * 128) {  // the producer warp; one thread issues
    if (tid == CONSUMERS * 128) {
      jt::mbar_expect_tx(wbar, L::WEIGHTS * W_BYTES);
      for (int k = 0; k < KP; k += W_BOX_ROWS) {
        jt::tma_load_2d(ws + k * ROW_BYTES, &maps.w1, wbar, 0, k);
        if (PAIR)
          jt::tma_load_2d(ws + W_BYTES + k * ROW_BYTES, &maps.w2, wbar, 0, k);
      }
      for (int s = 0; s < segs; ++s) {
        const int b = s % SETS;
        if (s >= SETS) jt::mbar_wait(&set_free[b], ((s / SETS) - 1) & 1);
        const int r0 = (c0 + s) * BM;
        jt::mbar_expect_tx(&set_full[b], 3 * WIN_ROWS * ROW_BYTES);
        for (int dy = 0; dy < 3; ++dy)
          jt::tma_load_2d(sets + b * SET_BYTES + dy * SLOT, &maps.x,
                          &set_full[b], 0, dy * pw + r0);
        if (PAIR) {
          if (s >= 1) jt::mbar_wait(res_free, (s - 1) & 1);
          jt::mbar_expect_tx(res_full, WIN_ROWS * ROW_BYTES);
          jt::tma_load_2d(res, &maps.x, res_full, 0, 3 * pw + 3 + r0);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int warp = wt >> 5;
  const int lane = wt & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t w1a = jt::smem_addr(ws);
  const uint32_t w2a = w1a + W_BYTES;  // pair only
  // Warpgroup wg takes the CTA's items wg, wg + 2, ...
  const int n_mine = (n - wg + 1) / 2;
  const int n_other = (n - (wg ^ 1) + 1) / 2;

  // Turns alternate 0, 1, 0, 1, ...: warpgroup 1's turn T follows
  // warpgroup 0's turn T, warpgroup 0's turn T > 0 follows warpgroup 1's
  // turn T - 1 where there is one (warpgroup 0 may have one item more).
  int turns = 0;
  auto take_turn = [&]() {
    if (wg == 1)
      jt::mbar_wait(&turn[1], turns & 1);
    else if (turns <= L::TURNS * n_other)
      jt::mbar_wait(&turn[0], (turns & 1) ^ 1);
  };
  auto pass_turn = [&]() {
    if (wt == 0) jt::mbar_arrive(&turn[wg ^ 1]);
    ++turns;
  };
  // Every warpgroup walks every segment in order, waits for its window
  // set and releases it (and the residual) once its last item there is
  // stored, whether or not it had an item there: so the phases of
  // set_free and res_free count segments.  The residual is waited for
  // at the epilogue only: its next load waits for both warpgroups to
  // leave the last chunk, and one of them may have to issue a product
  // first.
  int seg = -1;
  int res_seg = -1;  // the segment whose residual this warpgroup waited for
  auto enter = [&](int s) {
    while (seg < s) {
      if (seg >= 0 && wt == 0) {
        jt::mbar_arrive(&set_free[seg % SETS]);
        if (PAIR) jt::mbar_arrive(res_free);
      }
      ++seg;
      if (seg < segs) jt::mbar_wait(&set_full[seg % SETS], (seg / SETS) & 1);
    }
  };

  float acc[C / 2];
#pragma unroll
  for (int j = 0; j < C / 2; ++j) acc[j] = 0.0f;
  jt::mbar_wait(wbar, 0);
  for (int i = 0; i < n_mine; ++i) {
    const int q = q0 + wg + 2 * i;
    const int step = q % steps;
    const int r0 = (q / steps) * BM;
    enter(q / steps - c0);
    const uint32_t x0 = jt::smem_addr(sets + (seg % SETS) * SET_BYTES);

    take_turn();
    jt::fence_operands(acc);
    jt::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        // A: 64 rows of window dy from row dx, 16 channels; B: 16 k rows
        // of w1's block for this tap (MN-major, 8 k rows an SBO).
        const uint64_t a =
            jt::make_desc(x0 + dy * SLOT + dx * ROW_BYTES + kk * 32, 0, 1024);
        const uint64_t b =
            jt::make_desc(w1a + tap * TAP_BYTES + kk * 16 * ROW_BYTES, 0,
                          1024);
        jt::wgmma<C, 1>(acc, a, b, (tap | kk) != 0);
      }
    }
    jt::wgmma_commit();
    pass_turn();
    jt::wgmma_wait<0>();
    jt::fence_operands(acc);

    if (PAIR) {
      // y1 = bf16_rn(relu(acc)), packed as the A operand of k16 steps
      // 0..3.
      uint32_t y1[C / 16][4];
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          y1[kk][r] = pack_bf16(fmaxf(acc[8 * kk + 2 * r], 0.0f),
                                fmaxf(acc[8 * kk + 2 * r + 1], 0.0f));
      take_turn();
      jt::fence_operands(acc);
      jt::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
          jt::wgmma_m64n64_rs<1>(
              acc, y1[kk],
              jt::make_desc(w2a + tap * TAP_BYTES + kk * 16 * ROW_BYTES, 0,
                            1024),
              (tap | kk) != 0);
      jt::wgmma_commit();
      pass_turn();
      jt::wgmma_wait<0>();
      jt::fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) jt::fence_operands(y1[kk]);
    }

    unsigned char* tile =
        outs + (wg * L::STAGING + i % L::STAGING) * TILE_BYTES;
    // With two tiles, this tile's last store (two items back) was waited
    // for at the last item, before the barrier every thread of the
    // warpgroup passed since; with one, it is waited for here.
    if (wt == 0) jt::bulk_wait_read<0>();
    if (L::STAGING == 1) jt::named_sync(1 + wg, 128);
    if (PAIR && res_seg != seg) {
      jt::mbar_wait(res_full, seg & 1);
      res_seg = seg;
    }

    // Epilogue in the staging tile: accumulator row 16 warp + 8 half + g
    // is tile row `row`; d[4j + 2 half + e] is channel 8j + 2t + e, whose
    // 16-byte chunk j sits at chunk j ^ g of the swizzled row (row % 8 ==
    // g).  The residual slot is swizzled alike.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + half * 8 + g;
      unsigned char* out = tile + row * ROW_BYTES + t * 4;
      __nv_bfloat162 rv[C / 8];
      if (PAIR) {
        const unsigned char* rrow = res + row * ROW_BYTES + t * 4;
#pragma unroll
        for (int j = 0; j < C / 8; ++j)
          rv[j] = *reinterpret_cast<const __nv_bfloat162*>(
              rrow + ((j ^ g) << 4));
      }
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const float v0 = acc[4 * j + 2 * half];
        const float v1 = acc[4 * j + 2 * half + 1];
        __nv_bfloat162 o;
        if (PAIR) {
          const __nv_bfloat162 y2 = __floats2bfloat162_rn(v0, v1);
          o = __floats2bfloat162_rn(
              __bfloat162float(y2.x) + __bfloat162float(rv[j].x),
              __bfloat162float(y2.y) + __bfloat162float(rv[j].y));
        } else {
          o = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        }
        *reinterpret_cast<__nv_bfloat162*>(out + ((j ^ g) << 4)) = o;
      }
    }
    jt::fence_proxy_async();
    jt::named_sync(1 + wg, 128);
    if (wt == 0) {
      // The box clips the rows >= tile_rows of the ragged last chunk.
      jt::tma_store_3d(&maps.y, tile, 0, r0, step);
      jt::bulk_commit();
    }
  }
  enter(segs);
  if (wt == 0) jt::bulk_wait<0>();
}

template <bool PAIR>
cudaError_t launch(const void* x, const void* w1, const void* w2, void* y,
                   int tile_rows, int steps, int pw, cudaStream_t stream) {
  using L = Layout<PAIR>;
  Maps maps = {};
  // x as the probe reads it: rows past these arrive as zeros (they only
  // feed output rows past tile_rows, which are not stored).
  const uint64_t x_rows =
      uint64_t(tile_rows) + 2 * pw + 2 + (PAIR ? pw + 1 : 0);
  const uint64_t x_dims[2] = {C, x_rows};
  const uint64_t rm_strides[2] = {2, ROW_BYTES};
  const uint32_t x_box[2] = {C, WIN_ROWS};
  const uint64_t w_dims[2] = {C, KP};
  const uint32_t w_box[2] = {C, W_BOX_ROWS};
  const uint64_t y_dims[3] = {C, uint64_t(tile_rows), uint64_t(steps)};
  const uint64_t y_strides[3] = {2, ROW_BYTES,
                                 uint64_t(tile_rows) * ROW_BYTES};
  const uint32_t y_box[3] = {C, BM, 1};
  cudaError_t e = jt::encode_bf16(&maps.x, x, 2, x_dims, rm_strides, x_box);
  if (e == cudaSuccess)
    e = jt::encode_bf16(&maps.w1, w1, 2, w_dims, rm_strides, w_box);
  if (e == cudaSuccess && PAIR)
    e = jt::encode_bf16(&maps.w2, w2, 2, w_dims, rm_strides, w_box);
  if (e == cudaSuccess)
    e = jt::encode_bf16(&maps.y, y, 3, y_dims, y_strides, y_box);
  if (e != cudaSuccess) return e;
  static int grid_cap[MAX_DEVICES] = {};
  const int cap = jt::persistent_grid(probe_patch_dot_kernel<PAIR>, THREADS,
                                      L::SMEM, grid_cap, MAX_DEVICES, &e);
  if (cap == 0) return e;
  const long long items =
      (long long)steps * ((tile_rows + BM - 1) / BM);
  const int grid = items < cap ? int(items) : cap;
  probe_patch_dot_kernel<PAIR><<<grid, THREADS, L::SMEM, stream>>>(
      maps, tile_rows, steps, pw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, 64), w1 and w2 (576, 64), y (steps * tile_rows, 64), bf16
// row-major, 16-byte aligned; w2 is read in pair mode only.  x must hold
// the rows the probe reads (tile_rows + 2*pw + 2, plus pw + 1 in pair
// mode): the caller checks.  Returns the cudaError_t after the launch
// (cudaErrorInvalidValue where a tensor map is refused).
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
