// P1: the conv probe's product, y = bf16(A_blk @ B) with f32 accumulation.
//
//   y[i*tile_m + r, :] = bf16(A[src(i, r), :] @ B),
//   src = r (resident: every output tile is the same) or i*tile_m + r.
//
// Replaces the TPU kernel tools/pallas_conv_probe.py probe_dot -> kernel
// (the A BlockSpec index (0, 0) is the resident mode).  Layouts: A
// (M, K) and B (K, N) row-major bf16, y (M, N) bf16; N in {64, 128},
// K a multiple of 64 up to 576, tile_m dividing M.
//
// What bounds it on an H100: at the probe's shape (M = 129600, K = 576,
// N = 64, A resident) 9.56 GFLOP against 18 MB (the reused A rows, B and
// the output): operations, 9.7 us at 989 TFLOP/s.  With A streamed it
// reads 149 MB of A: bytes, about 49 us at 3.35 TB/s.  Both modes use
// mma.sync.m16n8k16 with fragments from ldmatrix, 32 x 32 outputs a warp
// (32 x 64 streamed at N = 128), shared rows padded by 8 elements (both
// ldmatrix patterns then hit no bank twice), and round the f32 sums to
// bf16 once (simple first; wgmma and TMA are the K1 redesign's work).
//
// Resident: the TPU kernel keeps A_blk (tile_m x K, 1.49 MB at the
// probe's shape) in VMEM and multiplies it again at every grid step.
// No SM holds that much, so the rows are spread over the CTAs: a CTA
// owns 96 rows of A_blk and 64 columns of B, loads both into shared
// memory once (96 x 584 + 576 x 72 bf16 = 195,072 B at K = 576) and
// then computes the product again for every tile of its tile group,
// from shared memory alone.  The grid is (row blocks, N / 64, tile
// groups), with as many tile groups as fill the SMs once.  So this mode
// times the product with no operand traffic but the output stores.
//
// Streamed:
//   * a persistent grid (SMs x resident CTAs) walks 128-row output
//     tiles; each CTA keeps all of B in shared memory, K x (N + 8) bf16
//     (82,944 B for N = 64, 156,672 B for N = 128), loaded once;
//   * A is streamed in 128 x 64 k-chunks through a 3-stage cp.async ring
//     (zero-filled past M);
//   * 8 warps, 4 along rows x 2 along columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int BM = 128;             // output rows per tile
constexpr int KC = 64;              // k-chunk per pipeline stage
constexpr int PAD = 8;
constexpr int AS = KC + PAD;        // A stage row stride (elements)
constexpr int A_STAGE = BM * AS;    // elements per stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int K_MAX = 576;
constexpr int MAX_DEVICES = 64;

template <int N>
constexpr size_t smem_bytes(int k) {
  return (size_t(k) * (N + PAD) + size_t(STAGES) * A_STAGE) *
         sizeof(__nv_bfloat16);
}

// Resident mode.
constexpr int RBM = 96;             // A_blk rows a CTA holds
constexpr int RBN = 64;             // columns of B a CTA holds
constexpr int R_THREADS = 192;      // 6 warps: 3 along rows x 2 along columns

constexpr size_t resident_smem_bytes(int k) {
  return (size_t(RBM) * (k + PAD) + size_t(k) * (RBN + PAD)) *
         sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(R_THREADS, 1)
probe_dot_resident_kernel(const __nv_bfloat16* __restrict__ a,
                          const __nv_bfloat16* __restrict__ b,
                          __nv_bfloat16* __restrict__ y, int M, int K,
                          int N, int tile_m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = K + PAD;
  constexpr int LDB = RBN + PAD;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bs = as + RBM * lda;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RBM;  // first A_blk row of this CTA
  const int c0 = blockIdx.y * RBN;  // first column of this CTA
  for (int i = tid; i < RBM * (K / 8); i += R_THREADS) {
    const int r = i / (K / 8);
    const int v = i % (K / 8);
    const bool valid = r0 + r < tile_m;
    const __nv_bfloat16* p = valid ? a + size_t(r0 + r) * K + v * 8 : a;
    jt::cp_async16(as + r * lda + v * 8, p, valid);
  }
  for (int i = tid; i < K * (RBN / 8); i += R_THREADS) {
    const int k = i / (RBN / 8);
    const int v = i % (RBN / 8);
    jt::cp_async16(bs + k * LDB + v * 8, b + size_t(k) * N + c0 + v * 8,
                   true);
  }
  jt::cp_async_commit();
  jt::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp % 3) * 32;
  const int wn = (warp / 3) * 32;
  if (r0 + wm >= tile_m) return;  // all of this warp's rows lie past A_blk
  const int tiles = M / tile_m;
  for (int tile = blockIdx.z; tile < tiles; tile += gridDim.z) {
    float acc[2][4][4] = {};
    jt::warp_tile_mma<4>(acc, as + wm * lda, lda, bs + wn, LDB, K / 16,
                         lane);
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + wm + mf * 16 + g + half * 8;
        if (r >= tile_m) continue;
        __nv_bfloat16* out =
            y + (size_t(tile) * tile_m + r) * N + c0 + wn + 2 * t;
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
          *reinterpret_cast<__nv_bfloat162*>(out + nf * 8) =
              __floats2bfloat162_rn(acc[mf][nf][half * 2],
                                    acc[mf][nf][half * 2 + 1]);
      }
  }
}

// Streamed mode.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
probe_dot_kernel(const __nv_bfloat16* __restrict__ a,
                 const __nv_bfloat16* __restrict__ b,
                 __nv_bfloat16* __restrict__ y, int M, int K) {
  constexpr int BS = N + PAD;   // B row stride (elements)
  constexpr int WN = N / 2;     // columns per warp
  constexpr int NF = WN / 8;    // n8 fragments per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* as = bs + K * BS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp & 3) * 32;   // first row of this warp in the tile
  const int wn = (warp >> 2) * WN;  // first column of this warp

  for (int i = tid; i < K * (N / 8); i += THREADS) {
    const int k = i / (N / 8);
    const int v = i % (N / 8);
    jt::cp_async16(bs + k * BS + v * 8, b + size_t(k) * N + v * 8, true);
  }
  jt::cp_async_commit();

  const int num_tiles = (M + BM - 1) / BM;
  const int kchunks = K / KC;
  const int my_tiles =
      int(blockIdx.x) < num_tiles
          ? (num_tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1
          : 0;
  const int total = my_tiles * kchunks;  // pipeline stages of this CTA

  auto load_stage = [&](int s) {
    const int tile = blockIdx.x + (s / kchunks) * gridDim.x;
    const int k0 = (s % kchunks) * KC;
    __nv_bfloat16* dst = as + (s % STAGES) * A_STAGE;
    for (int i = tid; i < BM * (KC / 8); i += THREADS) {
      const int r = i / (KC / 8);
      const int v = i % (KC / 8);
      const int row = tile * BM + r;
      const bool valid = row < M;
      const __nv_bfloat16* p = valid ? a + size_t(row) * K + k0 + v * 8 : a;
      jt::cp_async16(dst + r * AS + v * 8, p, valid);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_stage(s);
    jt::cp_async_commit();
  }

  float acc[2][NF][4];
  for (int s = 0; s < total; ++s) {
    const int kc = s % kchunks;
    if (kc == 0) {
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.0f;
    }
    // Stage s (and B) have landed; every warp is done with stage s - 1,
    // whose buffer the prefetch below refills.
    jt::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < total) load_stage(s + STAGES - 1);
    jt::cp_async_commit();

    jt::warp_tile_mma<NF>(acc, as + (s % STAGES) * A_STAGE + wm * AS, AS,
                          bs + kc * KC * BS + wn, BS, KC / 16, lane);

    if (kc == kchunks - 1) {
      const int row0 = (blockIdx.x + (s / kchunks) * gridDim.x) * BM + wm;
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + mf * 16 + g + half * 8;
          if (row >= M) continue;
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
            *reinterpret_cast<__nv_bfloat162*>(
                y + size_t(row) * N + wn + nf * 8 + 2 * t) =
                __floats2bfloat162_rn(acc[mf][nf][half * 2],
                                      acc[mf][nf][half * 2 + 1]);
        }
    }
  }
  jt::cp_async_wait<0>();
}

template <int N>
cudaError_t launch_streamed(const void* a, const void* b, void* y, int m,
                            int k, cudaStream_t stream) {
  static int grid_cap[MAX_DEVICES] = {};
  cudaError_t e;
  const int cap = jt::persistent_grid(probe_dot_kernel<N>, THREADS,
                                      smem_bytes<N>(K_MAX), grid_cap,
                                      MAX_DEVICES, &e);
  if (cap == 0) return e;
  const int tiles = (m + BM - 1) / BM;
  const int grid = tiles < cap ? tiles : cap;
  probe_dot_kernel<N><<<grid, THREADS, smem_bytes<N>(k), stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y),
      m, k);
  return cudaGetLastError();
}

cudaError_t launch_resident(const void* a, const void* b, void* y, int m,
                            int k, int n, int tile_m, cudaStream_t stream) {
  static int grid_cap[MAX_DEVICES] = {};
  cudaError_t e;
  const int cap = jt::persistent_grid(probe_dot_resident_kernel, R_THREADS,
                                      resident_smem_bytes(K_MAX), grid_cap,
                                      MAX_DEVICES, &e);
  if (cap == 0) return e;
  const int row_blocks = (tile_m + RBM - 1) / RBM;
  const int col_blocks = n / RBN;
  const int tiles = m / tile_m;
  int groups = cap / (row_blocks * col_blocks);
  if (groups < 1) groups = 1;
  if (groups > tiles) groups = tiles;
  if (groups > 65535) groups = 65535;
  const dim3 grid(row_blocks, col_blocks, groups);
  probe_dot_resident_kernel<<<grid, R_THREADS, resident_smem_bytes(k),
                              stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y),
      m, k, n, tile_m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (m, k), b (k, n), y (m, n), all bf16 row-major; n in {64, 128};
// k % 64 == 0, k <= 576; tile_m divides m.  Returns the cudaError_t
// after the launch.
int jt_probe_dot(const void* a, const void* b, void* y, int m, int k, int n,
                 int tile_m, int resident, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || k <= 0 || k % KC != 0 || k > K_MAX || tile_m <= 0 ||
      m % tile_m != 0)
    return int(cudaErrorInvalidValue);
  if (n != 64 && n != 128) return int(cudaErrorInvalidValue);
  if (resident) return int(launch_resident(a, b, y, m, k, n, tile_m, st));
  if (n == 64) return int(launch_streamed<64>(a, b, y, m, k, st));
  return int(launch_streamed<128>(a, b, y, m, k, st));
}

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
