// K1: fused res-block conv for Hopper (sm_90a).
//
//   y = act(conv3x3_SAME(x, w) * scale + offset [+ residual])
//
// Replaces the TPU kernel joshupscale_tpu/nn/resblock_pallas.py
// _conv_kernel (built by _build_conv_call, driven by res_block_chain):
// one 3x3 conv, C -> C channels, bias-free, folded BN scale/offset (the
// fade-in and any conv bias are folded in by the caller), optional
// residual, relu / lrelu.  A res block is two launches.
//
// Layouts: x, residual, y NHWC contiguous; w OHWI contiguous
// (C, 3, 3, C), i.e. per output channel the K = 9*C reduction is
// contiguous in (tap, ci) order; scale, offset float32 (C,).
//
// What bounds it on an H100: at the main path's shape (1, 270, 480, 64)
// bf16 a conv is 9.56 GFLOP (9.7 us at 989 TFLOP/s) against 33-50 MB of
// activations (10-15 us at 3.35 TB/s): both bounds are close, so the
// kernel must run the reduction at the tensor cores' full rate while it
// moves every activation byte once, and overlap the two.  Only wgmma
// reaches that rate, so:
//   * bf16: implicit GEMM on the Hopper core of wgmma_tma.cuh, M = output
//     pixels, N = C output channels, K = 9 taps x C/16 k16 steps.  A
//     persistent CTA (one an SM) walks 8 x 16-pixel output tiles.
//     - TMA does every copy.  One producer thread loads each tile's
//       (8+2) x (16+2) input halo (a ring of 3) and its residual, and
//       the weights once; the SAME padding and the ragged edges are
//       TMA's zero fill of out-of-bound coordinates.  Every shared tile
//       holds 128-byte rows of 64 channels (zeros past C), 128-byte
//       swizzled.
//     - Taps are descriptor offsets.  An M-block of 64 rows is 8 image
//       rows x 8 pixels of the halo (SBO = one halo row); a tap (dy, dx)
//       moves the A descriptor's start by dy halo rows and dx 128-byte
//       pixel rows, and k16 steps by 32 bytes.  No patch is built.  The
//       swizzle is a function of the absolute shared address, so a start
//       off a 1024-byte boundary reads what TMA wrote there.  The weights
//       are the K-major B operand, [tap][co][ci].
//     - Two consumer warpgroups in ping-pong: each owns whole tiles (two
//       M-blocks, 9 x C/16 x 2 wgmma m64nCk16) and they take turns to
//       issue, so one's epilogue runs under the other's products.
//     - Epilogue in the tile's shared staging buffer, in place over the
//       residual TMA brought there, then one TMA store, which clips the
//       rows >= H and columns >= W.
//   * bf16 at C = 32 (the fast tier's flow net, 12 launches a frame):
//     a launch moves 16.6-24.9 MB (5.0-7.4 us) and does 2.4 GFLOP
//     (2.4 us), so the 64-channel layout above spent half of every byte
//     it moved through shared memory on zeros, and the launch's fixed
//     costs (start, weights and first halo, the last tile's store) were
//     as large as its work.  The same design, changed where that costs:
//     - Dense rows.  Every shared tile holds 64-byte rows of the 32
//       channels, 64-byte swizzled (CU_TENSOR_MAP_SWIZZLE_64B, descriptor
//       layout 2): a halo is 11,520 bytes, a staging tile 8,192, the
//       weights 18,432.  Taps stay descriptor offsets: the 64-byte
//       swizzle (chunk bits 4-5 XOR address bits 7-8) is a function of
//       the absolute address too, so a start at any 64-byte pixel row of
//       a 512-byte-aligned tile reads what TMA wrote there.
//     - A ring of 5 halos (4 tiles ahead), each residual asked for before
//       the next halo, in 114,088 bytes: two CTAs fit an SM.
//     - Programmatic dependent launch.  The grid is one CTA an SM, so the
//       SM's second slot takes the next launch's CTA: each CTA lets the
//       next launch start at once (griddepcontrol.launch_dependents),
//       sets up its barriers, and waits for the launch before it
//       (griddepcontrol.wait) before it reads anything global, weights,
//       scale and offset included (the consumers read the last two
//       straight from global memory while the first loads fly).  In a
//       res-block chain the next conv's launch and set-up overlap this
//       one's tail.
//     The product is the one above at N = 32: 9 taps x 2 k16 steps x 2
//     M-blocks of m64n32k16 a tile, both operands from shared memory, in
//     the same tap-major, k16 order.  A from registers (ldmatrix, with or
//     without warp shuffles that reuse a halo row across dx) was tried
//     and ran slower on the H100 at a frame and more; its register sets
//     also need more registers than two CTAs an SM allow.
//   * f32: a direct CUDA-core conv (one thread per output pixel, all C
//     outputs in registers, weights staged tap by tap) -- not on the
//     main path, kept exact in f32.
// Epilogue in f32 (scale, offset, residual, act), one rounding to the
// output type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

// f32 direct conv tile.
constexpr int TILE_H = 8;
constexpr int TILE_W = 16;
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_W = TILE_W + 2;
constexpr int ACT_RELU = 0;
constexpr int ACT_LRELU = 1;
constexpr int MAX_DEVICES = 64;

// bf16 implicit-GEMM tile of one consumer warpgroup: 8 x 16 output
// pixels = 2 M-blocks of 8 x 8.
constexpr int BT_H = 8;
constexpr int BT_W = 16;
constexpr int HALO_PX = BT_W + 2;
constexpr int CONSUMERS = 2;                        // warpgroups
constexpr int BF16_THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int SLOTS = 2 * CONSUMERS;                // staging tiles, two each
constexpr int SM_SMEM = 233472;     // shared memory of an H100 SM, bytes
constexpr int CTA_RESERVED = 1024;  // of it, reserved for each CTA

__device__ __forceinline__ float activate(float v, int act, float alpha) {
  if (act == ACT_RELU) return fmaxf(v, 0.0f);
  return v >= 0.0f ? v : v * alpha;
}

template <int C>
struct Geom {
  // C = 48, 64: every tile of shared memory holds 128-byte rows of 64
  // channels (zeros past C), 128-byte swizzled as TMA writes them, with a
  // ring of 3 halos.  C = 32 (DENSE): 64-byte rows of the 32 channels,
  // 64-byte swizzled, a ring of 5 halos, and small enough that two CTAs
  // fit an SM.
  static constexpr bool DENSE = C == 32;
  static constexpr int PX = DENSE ? 64 : 128;         // a pixel's row, bytes
  static constexpr uint32_t LAYOUT = DENSE ? 2 : 1;   // descriptor swizzle
  static constexpr int STAGES = DENSE ? 5 : 3;        // halo ring
  static constexpr int CTAS_PER_SM = DENSE ? 2 : 1;
  static constexpr int ROW = HALO_PX * PX;             // halo row, bytes
  static constexpr int HALO_BYTES = (BT_H + 2) * ROW;  // 23,040 / 11,520
  static constexpr int HALO_STRIDE = (HALO_BYTES + 1023) / 1024 * 1024;
  static constexpr int W_BYTES = 9 * C * PX;           // 73,728 at C = 64
  static constexpr int TILE_BYTES = BT_H * BT_W * PX;  // staging, 16,384
  static constexpr size_t SMEM = 1024 + W_BYTES + SLOTS * TILE_BYTES +
                                 STAGES * HALO_STRIDE +
                                 2 * C * sizeof(float) +
                                 (1 + 2 * STAGES + 2 * SLOTS +
                                  CONSUMERS) * sizeof(uint64_t);
  static_assert(W_BYTES % 1024 == 0 && TILE_BYTES % 1024 == 0,
                "swizzled tiles must stay 1024-byte aligned");
  static_assert(CTAS_PER_SM * (SMEM + CTA_RESERVED) <= SM_SMEM,
                "the CTAs an SM holds must fit its shared memory");
};

// Maps of one launch: x (halo), w (B operand), the residual and y
// (staging tiles); all bf16 with rows of Geom::PX bytes, swizzled.
struct Maps {
  CUtensorMap x, w, res, y;
};

template <int C>
__global__ void __launch_bounds__(BF16_THREADS, Geom<C>::CTAS_PER_SM)
conv3x3_bf16_kernel(const __grid_constant__ Maps maps,
                    const float* __restrict__ scale,
                    const float* __restrict__ offset, int has_residual,
                    int n_img, int H, int W, int act, float alpha) {
  using G = Geom<C>;
  constexpr int STAGES = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws = jt::align1024(smem_raw);
  unsigned char* outs = ws + G::W_BYTES;
  unsigned char* halo = outs + SLOTS * G::TILE_BYTES;
  float* s_scale = reinterpret_cast<float*>(halo + STAGES * G::HALO_STRIDE);
  float* s_offset = s_scale + C;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(s_offset + C);
  uint64_t* full = wbar + 1;                     // halo landed
  uint64_t* halo_free = full + STAGES;           // products done with it
  uint64_t* res_full = halo_free + STAGES;       // residual in a staging tile
  uint64_t* out_free = res_full + SLOTS;         // store done reading it
  uint64_t* turn = out_free + SLOTS;             // a warpgroup's turn to issue

  const int tid = threadIdx.x;
  if constexpr (G::DENSE) {
    // Launched with programmatic dependent launch: the next launch's CTAs
    // may take this SM's second slot now and set up while this one works.
    jt::griddep_launch_dependents();
  } else {
    for (int i = tid; i < C; i += BF16_THREADS) {
      s_scale[i] = scale[i];
      s_offset[i] = offset[i];
    }
  }
  if (tid == 0) {
    jt::mbar_init(wbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      jt::mbar_init(&full[s], 1);
      jt::mbar_init(&halo_free[s], 1);
    }
    for (int s = 0; s < SLOTS; ++s) {
      jt::mbar_init(&res_full[s], 1);
      jt::mbar_init(&out_free[s], 1);
    }
    for (int w = 0; w < CONSUMERS; ++w) jt::mbar_init(&turn[w], 1);
    jt::mbar_init_fence();
  }
  __syncthreads();
  // Nothing global is read before the launch this one follows has
  // completed: it may have written any operand.  Then the producer's
  // loads go out at once, and the consumers read scale and offset
  // straight from global memory meanwhile.
  if constexpr (G::DENSE) jt::griddep_wait();

  // This CTA's tiles, k = 0, 1, ...: tile blockIdx.x + k gridDim.x, taken
  // by warpgroup k % 2 as its tile i = k / 2, its halo in stage
  // k % STAGES, its residual and output in staging slot 2 (k % 2) + i % 2.
  const int tiles_y = (H + BT_H - 1) / BT_H;
  const int tiles_x = (W + BT_W - 1) / BT_W;
  const int num_tiles = n_img * tiles_y * tiles_x;
  const int n_local =
      int(blockIdx.x) < num_tiles
          ? (num_tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1
          : 0;
  auto origin = [&](int k, int& img, int& ty0, int& tx0) {
    const int tile = blockIdx.x + k * gridDim.x;
    img = tile / (tiles_y * tiles_x);
    const int rem = tile % (tiles_y * tiles_x);
    ty0 = (rem / tiles_x) * BT_H;
    tx0 = (rem % tiles_x) * BT_W;
  };

  if (tid >= CONSUMERS * 128) {  // the producer warp; one thread issues
    if (tid == CONSUMERS * 128) {
      jt::mbar_expect_tx(wbar, G::W_BYTES);
      jt::tma_load_3d(ws, &maps.w, wbar, 0, 0, 0);
      auto load_halo = [&](int k) {
        const int s = k % STAGES;
        jt::mbar_wait(&halo_free[s], ((k / STAGES) & 1) ^ 1);
        int img, ty0, tx0;
        origin(k, img, ty0, tx0);
        jt::mbar_expect_tx(&full[s], G::HALO_BYTES);
        jt::tma_load_4d(halo + s * G::HALO_STRIDE, &maps.x, &full[s], 0,
                        tx0 - 1, ty0 - 1, img);
      };
      auto load_residual = [&](int k) {
        const int i = k / CONSUMERS;
        const int slot = 2 * (k % CONSUMERS) + (i & 1);
        jt::mbar_wait(&out_free[slot], ((i >> 1) & 1) ^ 1);
        int img, ty0, tx0;
        origin(k, img, ty0, tx0);
        jt::mbar_expect_tx(&res_full[slot], G::TILE_BYTES);
        jt::tma_load_4d(outs + slot * G::TILE_BYTES, &maps.res,
                        &res_full[slot], 0, tx0, ty0, img);
      };
      // Halos run STAGES - 1 tiles ahead of residuals: halo k + STAGES - 1
      // waits for the products of tile k - 1, residual k for the store
      // from its staging slot two of its warpgroup's tiles back (freed
      // after the products of tile k - 2).  At C = 32 the residual goes
      // first, so it is not queued behind the later wait.
      constexpr int LEAD = STAGES - 1;
      for (int k = 0; k < LEAD && k < n_local; ++k) load_halo(k);
      for (int k = 0; k < n_local; ++k) {
        if constexpr (G::DENSE) {
          if (has_residual) load_residual(k);
          if (k + LEAD < n_local) load_halo(k + LEAD);
        } else {
          if (k + LEAD < n_local) load_halo(k + LEAD);
          if (has_residual) load_residual(k);
        }
      }
    }
    return;
  }

  // Two consumer warpgroups in ping-pong: each owns whole tiles, and they
  // take turns to issue their products, so one warpgroup's epilogue runs
  // while the other's products keep the tensor cores busy.
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int warp = wt >> 5;
  const int lane = wt & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // The 16-byte chunk j of this thread's pixel rows (pixel 8m + g of a
  // staging row) sits at chunk j ^ swz of the swizzled row.
  const int swz = G::DENSE ? (g >> 1) & 3 : g;
  const uint32_t w0 = jt::smem_addr(ws);
  // This thread's output channels are 8j + 2t, +1: their scale and offset
  // stay in registers.
  const float* sc_src = G::DENSE ? scale : s_scale;
  const float* of_src = G::DENSE ? offset : s_offset;
  float2 sc[C / 8], of[C / 8];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    sc[j] = *reinterpret_cast<const float2*>(sc_src + j * 8 + t * 2);
    of[j] = *reinterpret_cast<const float2*>(of_src + j * 8 + t * 2);
  }
  float acc[2][C / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[m][i] = 0.0f;

  jt::mbar_wait(wbar, 0);
  int i = 0;  // this warpgroup's tile count
  for (int k = wg; k < n_local; k += CONSUMERS, ++i) {
    int img, ty0, tx0;
    origin(k, img, ty0, tx0);
    const int stage = k % STAGES;

    jt::mbar_wait(&full[stage], (k / STAGES) & 1);
    jt::mbar_wait(&turn[wg], wg == 0 ? (i & 1) ^ 1 : i & 1);
    const uint32_t h0 = jt::smem_addr(halo + stage * G::HALO_STRIDE);
    jt::fence_operands(acc[0]);
    jt::fence_operands(acc[1]);
    jt::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        // B: the C output channels x 16 input channels of this tap.
        const uint64_t b = jt::make_desc(w0 + tap * C * G::PX + kk * 32, 0,
                                         8 * G::PX, G::LAYOUT);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // A: M-block m's 8 rows x 8 pixels, shifted by the tap: dy halo
          // rows, dx pixel rows (the swizzle follows the absolute
          // address, so any whole pixel row is a valid start).
          const uint64_t a = jt::make_desc(
              h0 + dy * G::ROW + (m * 8 + dx) * G::PX + kk * 32, 0, G::ROW,
              G::LAYOUT);
          jt::wgmma<C, 0>(acc[m], a, b, (tap | kk) != 0);
        }
      }
    }
    jt::wgmma_commit();
    if (wt == 0) jt::mbar_arrive(&turn[wg ^ 1]);
    jt::wgmma_wait<0>();
    jt::fence_operands(acc[0]);
    jt::fence_operands(acc[1]);
    const int slot = 2 * wg + (i & 1);
    unsigned char* tile_out = outs + slot * G::TILE_BYTES;
    if (wt == 0) {
      jt::mbar_arrive(&halo_free[stage]);
      // The last tile's store, issued a tile ago, has read its slot: free
      // it for the residual two tiles on.  This slot's own last store
      // (two tiles back) was waited for then.
      jt::bulk_wait_read<0>();
      if (i > 0) jt::mbar_arrive(&out_free[slot ^ 1]);
    }
    if (has_residual) jt::mbar_wait(&res_full[slot], (i >> 1) & 1);

    // Epilogue in the staging tile, in place over the residual: the
    // accumulator row 16 warp + g + 8 half of M-block m is pixel
    // (2 warp + half, 8 m + g) of the 8 x 16 tile; d[4j + 2 half + e] is
    // channel 8j + 2t + e, whose 16-byte chunk j sits at chunk j ^ swz
    // of the pixel's swizzled row.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned char* row = tile_out +
                             ((warp * 2 + half) * BT_W + m * 8 + g) * G::PX +
                             t * 4;
        // All of the row's residual loads go ahead of its stores, which
        // the compiler may not reorder across.
        __nv_bfloat162 res[C / 8];
        if (has_residual) {
#pragma unroll
          for (int j = 0; j < C / 8; ++j)
            res[j] = *reinterpret_cast<const __nv_bfloat162*>(
                row + ((j ^ swz) << 4));
        }
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          float v0 = acc[m][4 * j + 2 * half] * sc[j].x + of[j].x;
          float v1 = acc[m][4 * j + 2 * half + 1] * sc[j].y + of[j].y;
          if (has_residual) {
            v0 += __bfloat162float(res[j].x);
            v1 += __bfloat162float(res[j].y);
          }
          *reinterpret_cast<__nv_bfloat162*>(row + ((j ^ swz) << 4)) =
              __floats2bfloat162_rn(activate(v0, act, alpha),
                                    activate(v1, act, alpha));
        }
      }
    }
    jt::fence_proxy_async();
    jt::named_sync(1 + wg, 128);
    if (wt == 0) {
      // TMA clips the rows >= H and columns >= W.
      jt::tma_store_4d(&maps.y, tile_out, 0, tx0, ty0, img);
      jt::bulk_commit();
    }
  }
  if (wt == 0) jt::bulk_wait<0>();
}

template <int C>
__global__ void __launch_bounds__(TILE_H * TILE_W)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ offset,
                   const float* __restrict__ residual, float* __restrict__ y,
                   int n_img, int H, int W, int act, float alpha) {
  constexpr int XS = C + 1;  // odd stride: conflict-free per-pixel reads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);   // [HALO_H*HALO_W][XS]
  float* wt = halo + HALO_H * HALO_W * XS;             // [ci][co], one tap

  const int tiles_y = (H + TILE_H - 1) / TILE_H;
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int img = blockIdx.x / (tiles_y * tiles_x);
  const int rem = blockIdx.x % (tiles_y * tiles_x);
  const int ty0 = (rem / tiles_x) * TILE_H;
  const int tx0 = (rem % tiles_x) * TILE_W;
  const int tid = threadIdx.x;
  const int py = tid / TILE_W;
  const int px = tid % TILE_W;

  for (int i = tid; i < HALO_H * HALO_W * C; i += blockDim.x) {
    const int pix = i / C;
    const int ci = i % C;
    const int gy = ty0 + pix / HALO_W - 1;
    const int gx = tx0 + pix % HALO_W - 1;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = x[((size_t(img) * H + gy) * W + gx) * C + ci];
    halo[pix * XS + ci] = v;
  }

  float acc[C];
#pragma unroll
  for (int co = 0; co < C; ++co) acc[co] = 0.0f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // halo ready / previous tap's weights consumed
    for (int i = tid; i < C * C; i += blockDim.x) {
      const int co = i / C;
      const int ci = i % C;
      wt[ci * C + co] = w[(size_t(co) * 9 + tap) * C + ci];
    }
    __syncthreads();
    const float* xp = halo + ((py + tap / 3) * HALO_W + px + tap % 3) * XS;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      const float xv = xp[ci];
#pragma unroll
      for (int co = 0; co < C; ++co) acc[co] = fmaf(xv, wt[ci * C + co], acc[co]);
    }
  }

  const int oy = ty0 + py;
  const int ox = tx0 + px;
  if (oy >= H || ox >= W) return;
  const size_t base = ((size_t(img) * H + oy) * W + ox) * C;
#pragma unroll
  for (int co = 0; co < C; ++co) {
    float v = acc[co] * scale[co] + offset[co];
    if (residual != nullptr) v += residual[base + co];
    y[base + co] = activate(v, act, alpha);
  }
}

template <int C>
cudaError_t launch_bf16(const void* x, const void* w, const float* scale,
                        const float* offset, const void* residual, void* y,
                        int n, int h, int wd, int act, float alpha,
                        cudaStream_t stream) {
  using G = Geom<C>;
  constexpr uint32_t BOX_C = G::PX / 2;  // channels a box row holds
  constexpr CUtensorMapSwizzle SWIZZLE =
      G::DENSE ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  Maps maps = {};
  // x (n, h, wd, C): a box is one tile's (8+2) x (16+2) halo.
  const uint64_t x_dims[4] = {C, uint64_t(wd), uint64_t(h), uint64_t(n)};
  const uint64_t x_strides[4] = {2, C * 2, uint64_t(wd) * C * 2,
                                 uint64_t(h) * wd * C * 2};
  const uint32_t x_box[4] = {BOX_C, HALO_PX, BT_H + 2, 1};
  // w OHWI (C, 3, 3, C) seen as [tap][co][ci]: rows of BOX_C input
  // channels (zeros past C), swizzled: the K-major B operand.
  const uint64_t w_dims[3] = {C, C, 9};
  const uint64_t w_strides[3] = {2, 9 * C * 2, C * 2};
  const uint32_t w_box[3] = {BOX_C, C, 9};
  // Residual and y (n, h, wd, C): a box is one 8 x 16-pixel tile.
  const uint64_t t_dims[4] = {C, uint64_t(wd), uint64_t(h), uint64_t(n)};
  const uint64_t t_strides[4] = {2, C * 2, uint64_t(wd) * C * 2,
                                 uint64_t(h) * wd * C * 2};
  const uint32_t t_box[4] = {BOX_C, BT_W, BT_H, 1};
  cudaError_t e =
      jt::encode_bf16(&maps.x, x, 4, x_dims, x_strides, x_box, SWIZZLE);
  if (e == cudaSuccess)
    e = jt::encode_bf16(&maps.w, w, 3, w_dims, w_strides, w_box, SWIZZLE);
  if (e == cudaSuccess)
    e = jt::encode_bf16(&maps.y, y, 4, t_dims, t_strides, t_box, SWIZZLE);
  if (e == cudaSuccess && residual != nullptr)
    e = jt::encode_bf16(&maps.res, residual, 4, t_dims, t_strides, t_box,
                        SWIZZLE);
  if (e != cudaSuccess) return e;
  static int grid_cap[MAX_DEVICES] = {};
  const int cap = jt::persistent_grid(conv3x3_bf16_kernel<C>, BF16_THREADS,
                                      G::SMEM, grid_cap, MAX_DEVICES, &e);
  if (cap == 0) return e;
  const int tiles = n * ((h + BT_H - 1) / BT_H) * ((wd + BT_W - 1) / BT_W);
  if constexpr (G::DENSE) {
    // One CTA an SM; the SM's second slot takes the next launch's CTA
    // (programmatic dependent launch), which sets up while this one ends.
    static int sm_count[MAX_DEVICES] = {};
    int dev = 0;
    e = cudaGetDevice(&dev);  // below MAX_DEVICES: persistent_grid checked
    if (e == cudaSuccess && sm_count[dev] == 0)
      e = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(tiles < sm_count[dev] ? tiles : sm_count[dev]);
    config.blockDim = dim3(BF16_THREADS);
    config.dynamicSmemBytes = G::SMEM;
    config.stream = stream;
    config.attrs = &attr;
    config.numAttrs = 1;
    e = cudaLaunchKernelEx(&config, conv3x3_bf16_kernel<C>, maps, scale,
                           offset, int(residual != nullptr), n, h, wd, act,
                           alpha);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  const int grid = tiles < cap ? tiles : cap;
  conv3x3_bf16_kernel<C><<<grid, BF16_THREADS, G::SMEM, stream>>>(
      maps, scale, offset, residual != nullptr, n, h, wd, act, alpha);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_f32(const void* x, const void* w, const float* scale,
                       const float* offset, const void* residual, void* y,
                       int n, int h, int wd, int act, float alpha,
                       cudaStream_t stream) {
  const size_t smem = size_t(HALO_H * HALO_W * (C + 1) + C * C) * sizeof(float);
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(conv3x3_f32_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
    if (e != cudaSuccess) return e;
    configured[dev] = true;
  }
  const int tiles = n * ((h + TILE_H - 1) / TILE_H) *
                    ((wd + TILE_W - 1) / TILE_W);
  conv3x3_f32_kernel<C><<<tiles, TILE_H * TILE_W, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), scale,
      offset, static_cast<const float*>(residual), static_cast<float*>(y), n,
      h, wd, act, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  act: 0 = relu, 1 = lrelu(alpha).
// residual may be null.  Returns the cudaError_t after the launch.
int jt_resblock_conv3x3(int dtype, const void* x, const void* w,
                        const void* scale, const void* offset,
                        const void* residual, void* y, int n, int h, int wd,
                        int c, int act, float alpha, void* stream) {
  const float* s = static_cast<const float*>(scale);
  const float* o = static_cast<const float*>(offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || h <= 0 || wd <= 0) return int(cudaErrorInvalidValue);
  if (act != ACT_RELU && act != ACT_LRELU) return int(cudaErrorInvalidValue);
  if (dtype == 1) {
    switch (c) {
      case 32: return int(launch_bf16<32>(x, w, s, o, residual, y, n, h, wd, act, alpha, st));
      case 48: return int(launch_bf16<48>(x, w, s, o, residual, y, n, h, wd, act, alpha, st));
      case 64: return int(launch_bf16<64>(x, w, s, o, residual, y, n, h, wd, act, alpha, st));
    }
  } else if (dtype == 0) {
    switch (c) {
      case 32: return int(launch_f32<32>(x, w, s, o, residual, y, n, h, wd, act, alpha, st));
      case 48: return int(launch_f32<48>(x, w, s, o, residual, y, n, h, wd, act, alpha, st));
      case 64: return int(launch_f32<64>(x, w, s, o, residual, y, n, h, wd, act, alpha, st));
    }
  }
  return int(cudaErrorInvalidValue);
}

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
