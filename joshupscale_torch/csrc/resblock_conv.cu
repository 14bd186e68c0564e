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
// kernel must keep the reduction on the tensor cores and read every
// activation byte once.  Design (simple first, a wgmma/TMA redesign is
// queued):
//   * bf16: implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate).  A CTA owns an 8x16-pixel output tile and all C
//     output channels; it stages the (8+2)x(16+2)xC input halo in shared
//     memory (SAME zero padding = bounds checks on the halo load) and
//     keeps the whole 9*C x C weight matrix resident.  The grid is
//     persistent (a few CTAs per SM walk the tiles), so the weights are
//     read from L2 once per CTA, not once per tile.  Four warps, each
//     two tile rows (2 m16 fragments) x C output channels.  Rows of both
//     shared arrays are padded by 8 elements, which makes every 32-bit
//     fragment load bank-conflict free for C in {32, 48, 64}.
//   * f32: a direct CUDA-core conv (one thread per output pixel, all C
//     outputs in registers, weights staged tap by tap) -- not on the
//     main path, kept exact in f32.
// Epilogue in f32 (scale, offset, residual, act), one rounding to the
// output type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 16;
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_W = TILE_W + 2;
constexpr int WARPS = TILE_H / 2;
constexpr int THREADS = WARPS * 32;
constexpr int ACT_RELU = 0;
constexpr int ACT_LRELU = 1;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float activate(float v, int act, float alpha) {
  if (act == ACT_RELU) return fmaxf(v, 0.0f);
  return v >= 0.0f ? v : v * alpha;
}

template <int C>
struct Geom {
  static constexpr int PAD = 8;
  static constexpr int XS = C + PAD;        // halo pixel stride (elements)
  static constexpr int K = 9 * C;
  static constexpr int WS = K + PAD;        // weight row stride (elements)
  static constexpr int HALO_ELEMS = HALO_H * HALO_W * XS;
  static constexpr int W_ELEMS = C * WS;
  static constexpr size_t SMEM =
      size_t(HALO_ELEMS + W_ELEMS) * sizeof(__nv_bfloat16);
};

template <int C>
__global__ void __launch_bounds__(THREADS)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ offset,
                    const __nv_bfloat16* __restrict__ residual,
                    __nv_bfloat16* __restrict__ y,
                    int n_img, int H, int W, int act, float alpha) {
  using G = Geom<C>;
  constexpr int NT = C / 8;    // n8 fragments (output channels)
  constexpr int KC = C / 16;   // k16 steps per tap
  constexpr int VEC = C / 8;   // uint4 vectors per pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = halo + G::HALO_ELEMS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // groupID
  const int t = lane & 3;    // thread in group

  // Resident weights: ws[co * WS + k], k = tap * C + ci.
  for (int i = tid; i < C * (G::K / 8); i += THREADS) {
    const int co = i / (G::K / 8);
    const int v = i % (G::K / 8);
    *reinterpret_cast<uint4*>(ws + co * G::WS + v * 8) =
        *reinterpret_cast<const uint4*>(w + size_t(co) * G::K + v * 8);
  }

  const int tiles_y = (H + TILE_H - 1) / TILE_H;
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int num_tiles = n_img * tiles_y * tiles_x;

  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int img = tile / (tiles_y * tiles_x);
    const int rem = tile % (tiles_y * tiles_x);
    const int ty0 = (rem / tiles_x) * TILE_H;
    const int tx0 = (rem % tiles_x) * TILE_W;

    __syncthreads();  // previous tile's fragment reads are done
    for (int i = tid; i < HALO_H * HALO_W * VEC; i += THREADS) {
      const int pix = i / VEC;
      const int v = i % VEC;
      const int gy = ty0 + pix / HALO_W - 1;
      const int gx = tx0 + pix % HALO_W - 1;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        val = *reinterpret_cast<const uint4*>(
            x + ((size_t(img) * H + gy) * W + gx) * C + v * 8);
      }
      *reinterpret_cast<uint4*>(halo + pix * G::XS + v * 8) = val;
    }
    __syncthreads();

    float acc[2][NT][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mf][nt][r] = 0.0f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[2][4];
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const int row = warp * 2 + mf;  // tile row of this fragment
          const __nv_bfloat16* p0 =
              halo + ((row + dy) * HALO_W + g + dx) * G::XS + kc * 16 + t * 2;
          const __nv_bfloat16* p1 = p0 + 8 * G::XS;  // pixel g + 8
          a[mf][0] = *reinterpret_cast<const uint32_t*>(p0);
          a[mf][1] = *reinterpret_cast<const uint32_t*>(p1);
          a[mf][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
          a[mf][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* q =
              ws + (nt * 8 + g) * G::WS + tap * C + kc * 16 + t * 2;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(q);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(q + 8);
          jt::mma_bf16(acc[0][nt], a[0], b0, b1);
          jt::mma_bf16(acc[1][nt], a[1], b0, b1);
        }
      }
    }

    // Epilogue: c0,c1 -> pixel g, c2,c3 -> pixel g + 8; channels
    // nt*8 + 2t + {0, 1}.
#pragma unroll
    for (int mf = 0; mf < 2; ++mf) {
      const int oy = ty0 + warp * 2 + mf;
      if (oy >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox = tx0 + g + half * 8;
        if (ox >= W) continue;
        const size_t base = ((size_t(img) * H + oy) * W + ox) * C;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = nt * 8 + t * 2;
          float v0 = acc[mf][nt][half * 2 + 0] * __ldg(scale + co) +
                     __ldg(offset + co);
          float v1 = acc[mf][nt][half * 2 + 1] * __ldg(scale + co + 1) +
                     __ldg(offset + co + 1);
          if (residual != nullptr) {
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(residual + base + co);
            v0 += __bfloat162float(r.x);
            v1 += __bfloat162float(r.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(y + base + co) =
              __floats2bfloat162_rn(activate(v0, act, alpha),
                                    activate(v1, act, alpha));
        }
      }
    }
  }
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
  static int grid_cap[MAX_DEVICES] = {};
  cudaError_t e;
  const int cap = jt::persistent_grid(conv3x3_bf16_kernel<C>, THREADS,
                                      G::SMEM, grid_cap, MAX_DEVICES, &e);
  if (cap == 0) return e;
  const int tiles = n * ((h + TILE_H - 1) / TILE_H) *
                    ((wd + TILE_W - 1) / TILE_W);
  const int grid = tiles < cap ? tiles : cap;
  conv3x3_bf16_kernel<C><<<grid, THREADS, G::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), scale, offset,
      static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(y), n, h, wd, act, alpha);
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
