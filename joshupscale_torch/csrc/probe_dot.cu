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
// reads 149 MB of A: bytes, about 49 us at 3.35 TB/s.
//
// Design, on the Hopper core of wgmma_tma.cuh: every operand reaches
// shared memory by TMA (128-byte swizzled boxes of 64 columns, completion
// on an mbarrier) and the product is wgmma m64nNk16 from shared memory,
// A K-major and B MN-major (as B is stored), f32 accumulators in
// registers, one rounding to bf16 on the store.  A warpgroup owns 64 rows.
// The stores exchange values within each quad of threads so that each
// thread writes 16 contiguous bytes.  At N = 64 a wgmma reads 4 KB of
// shared memory per 32 clocks of tensor-core work, the SM's whole
// shared-memory rate, so a product held in shared memory cannot reach
// the tensor cores' peak at this width.
//
// Resident: the TPU kernel keeps A_blk (tile_m x K, 1.49 MB at the
// probe's shape) in VMEM and multiplies it again at every grid step.
// No SM holds that much, so the rows are spread over the CTAs: a CTA
// owns 128 rows of A_blk and 64 columns of B, loads both once
// (128 x 576 + 576 x 64 bf16 = 221,184 B at K = 576; rows past tile_m
// arrive as TMA's zero fill; one mbarrier per k-chunk, so the first
// tile's products start as the chunks land) and then computes the
// product again for every tile of its tile group.  Its two warpgroups
// take turns to issue, so one's stores run under the other's products.
// The grid is (row blocks, N / 64, tile groups), with as many tile
// groups as fill the SMs once.  So this mode times the product with no
// operand traffic but the output stores.
//
// Streamed (bound by bytes): a persistent grid (one CTA an SM) walks
// 128-row output tiles.  B is resident, loaded once per CTA.  A comes
// through a ring of 128 x 64 k-chunk stages (8 at N = 64, 4 at N = 128)
// filled by one producer thread; two consumer warpgroups run wgmma on
// each stage, keep one wgmma group in flight, and release a stage on an
// "empty" mbarrier.  Rows past M arrive as zeros and are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace {

constexpr int BM = 128;             // output rows per tile (2 warpgroups)
constexpr int KC = 64;              // k-chunk: one 128-byte swizzle row
constexpr int ROW_BYTES = KC * 2;   // 128
constexpr int K_MAX = 576;
constexpr int KCH_MAX = K_MAX / KC;
constexpr int CONSUMERS = 2;        // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int MAX_DEVICES = 64;
constexpr uint32_t SW_ATOM = 1024;  // 8 rows of 128 bytes

constexpr int A_STAGE_BYTES = BM * ROW_BYTES;             // 16,384
constexpr uint32_t B_BLOCK_BYTES = K_MAX * ROW_BYTES;     // 64 columns of B

template <int N>
struct Streamed {
  static constexpr int STAGES = N == 64 ? 8 : 4;
  static constexpr size_t B_BYTES = size_t(N / 64) * B_BLOCK_BYTES;
  static constexpr size_t SMEM = 1024 + B_BYTES +
                                 size_t(STAGES) * A_STAGE_BYTES +
                                 (2 * STAGES + 1) * sizeof(uint64_t);
};

constexpr int RBM = 128;            // A_blk rows a resident CTA holds
constexpr int RBN = 64;             // columns of B a resident CTA holds
constexpr int R_THREADS = 256;
constexpr size_t R_A_BYTES = size_t(KCH_MAX) * RBM * ROW_BYTES;
constexpr size_t R_B_BYTES = size_t(K_MAX) * ROW_BYTES;
constexpr size_t R_SMEM =
    1024 + R_A_BYTES + R_B_BYTES + (KCH_MAX + 2) * sizeof(uint64_t);

// The k16 step j of k-chunk kc: A rows at `a` (a 1024-aligned K-major
// swizzled tile), B's k rows at `b` (MN-major, 64-column blocks
// `b_block` bytes apart).
__device__ __forceinline__ uint64_t a_desc(uint32_t a, int j) {
  return jt::make_desc(a + j * 32, 0, SW_ATOM);
}
__device__ __forceinline__ uint64_t b_desc(uint32_t b, int j,
                                           uint32_t b_block) {
  return jt::make_desc(b + j * 16 * ROW_BYTES, b_block, SW_ATOM);
}

// Stores a warpgroup's m64nN accumulator as rows row0.. of y (row stride
// ld elements, first column col0), rows at or past row_end skipped.  The
// four threads of a quad hold two columns of each 8-column block; a 4 x 4
// exchange among them gives each thread 8 whole columns, so every store
// is 16 contiguous bytes and a warp writes 64 contiguous bytes a row.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2],
                                           __nv_bfloat16* y, size_t ld,
                                           int row0, int row_end, int col0,
                                           int wt) {
  const int lane = wt & 31;
  const int t = lane & 3;
  const int r = row0 + (wt >> 5) * 16 + (lane >> 2);
  auto pick = [](const uint32_t (&v)[4], int i) {
    return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
  };
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < N / 32; ++q) {
      // v[i]: columns 8 (4q + i) + 2t, +1 of this row.
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            acc[4 * (4 * q + i) + 2 * half], acc[4 * (4 * q + i) + 2 * half + 1]);
        v[i] = *reinterpret_cast<const uint32_t*>(&p);
      }
      // w[u]: columns 8 (4q + t) + 2u, +1, which quad thread u holds as
      // its v[t]; partner t ^ s sends its v[t] in exchange for our v[t ^ s].
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      auto put = [&](int u, uint32_t val) {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = u == i ? val : w[i];
      };
      put(t, pick(v, t));
#pragma unroll
      for (int s = 1; s < 4; ++s)
        put(t ^ s, __shfl_xor_sync(0xffffffffu, pick(v, t ^ s), s));
      if (r + half * 8 < row_end)
        *reinterpret_cast<uint4*>(y + size_t(r + half * 8) * ld + col0 +
                                  8 * (4 * q + t)) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Resident mode.
__global__ void __launch_bounds__(R_THREADS, 1)
probe_dot_resident_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap bmap,
                          __nv_bfloat16* __restrict__ y, int M, int K,
                          int N, int tile_m) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = jt::align1024(smem_raw);
  unsigned char* bs = as + R_A_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + R_B_BYTES);  // k-chunks
  uint64_t* turn = bar + KCH_MAX;  // a warpgroup's turn to issue
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RBM;  // first A_blk row of this CTA
  const int c0 = blockIdx.y * RBN;  // first column of this CTA
  const int kchunks = K / KC;
  if (tid == 0) {
    for (int kb = 0; kb < KCH_MAX + 2; ++kb) jt::mbar_init(&bar[kb], 1);
    jt::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int kb = 0; kb < kchunks; ++kb) {
      jt::mbar_expect_tx(&bar[kb], (RBM + RBN) * ROW_BYTES);
      jt::tma_load_2d(as + kb * A_STAGE_BYTES, &amap, &bar[kb], kb * KC, r0);
      jt::tma_load_2d(bs + kb * KC * ROW_BYTES, &bmap, &bar[kb], c0,
                      kb * KC);
    }
  }

  const int wg = tid >> 7;
  const int wt = tid & 127;
  if (r0 + wg * 64 >= tile_m) return;  // its rows all lie past A_blk
  // With both warpgroups holding rows they take turns to issue, so one's
  // stores run under the other's products.
  const bool paired = r0 + 64 < tile_m;
  const uint32_t a0 = jt::smem_addr(as) + wg * 64 * ROW_BYTES;
  const uint32_t b0 = jt::smem_addr(bs);
  float acc[RBN / 2] = {};
  int i = 0;
  for (int tile = blockIdx.z; tile < M / tile_m; tile += gridDim.z, ++i) {
    if (paired) jt::mbar_wait(&turn[wg], wg == 0 ? (i & 1) ^ 1 : i & 1);
    jt::fence_operands(acc);
    jt::wgmma_fence();
#pragma unroll 1
    for (int kb = 0; kb < kchunks; ++kb) {
      if (i == 0) jt::mbar_wait(&bar[kb], 0);  // the first tile's chunk landed
#pragma unroll
      for (int j = 0; j < KC / 16; ++j)
        jt::wgmma<RBN, 1>(acc, a_desc(a0 + kb * A_STAGE_BYTES, j),
                          b_desc(b0 + kb * KC * ROW_BYTES, j, 0),
                          (kb | j) != 0);
    }
    jt::wgmma_commit();
    if (paired && wt == 0) jt::mbar_arrive(&turn[wg ^ 1]);
    jt::wgmma_wait<0>();
    jt::fence_operands(acc);
    store_rows<RBN>(acc, y + size_t(tile) * tile_m * N, N, r0 + wg * 64,
                    tile_m, c0, wt);
  }
}

// Streamed mode.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
probe_dot_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap,
                 __nv_bfloat16* __restrict__ y, int M, int K) {
  using S = Streamed<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* bs = jt::align1024(smem_raw);
  unsigned char* as = bs + S::B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(as + S::STAGES * A_STAGE_BYTES);
  uint64_t* empty = full + S::STAGES;
  uint64_t* bbar = empty + S::STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      jt::mbar_init(&full[s], 1);
      jt::mbar_init(&empty[s], CONSUMERS);
    }
    jt::mbar_init(bbar, 1);
    jt::mbar_init_fence();
  }
  __syncthreads();

  const int num_tiles = (M + BM - 1) / BM;
  const int kchunks = K / KC;
  if (tid >= CONSUMERS * 128) {  // the producer warp; one thread issues
    if (tid == CONSUMERS * 128) {
      jt::mbar_expect_tx(bbar, uint32_t(K) * N * 2);
      for (int cb = 0; cb < N / 64; ++cb)
        for (int kb = 0; kb < kchunks; ++kb)
          jt::tma_load_2d(bs + cb * B_BLOCK_BYTES + kb * KC * ROW_BYTES,
                          &bmap, bbar, cb * 64, kb * KC);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        for (int kc = 0; kc < kchunks; ++kc) {
          jt::mbar_wait(&empty[stage], phase ^ 1);
          jt::mbar_expect_tx(&full[stage], A_STAGE_BYTES);
          jt::tma_load_2d(as + stage * A_STAGE_BYTES, &amap, &full[stage],
                          kc * KC, tile * BM);
          if (++stage == S::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int wt = tid & 127;
  const uint32_t a_base = jt::smem_addr(as) + wg * 64 * ROW_BYTES;
  const uint32_t b_base = jt::smem_addr(bs);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  jt::mbar_wait(bbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  // One wgmma group stays in flight: a stage is released once the group
  // after the one that read it has been issued.
  int last = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    jt::fence_operands(acc);
    for (int kc = 0; kc < kchunks; ++kc) {
      jt::mbar_wait(&full[stage], phase);
      jt::wgmma_fence();
#pragma unroll
      for (int j = 0; j < KC / 16; ++j)
        jt::wgmma<N, 1>(acc, a_desc(a_base + stage * A_STAGE_BYTES, j),
                        b_desc(b_base + kc * KC * ROW_BYTES, j,
                               B_BLOCK_BYTES),
                        (kc | j) != 0);
      jt::wgmma_commit();
      if (kc > 0) {
        jt::wgmma_wait<1>();
        if (wt == 0) jt::mbar_arrive(&empty[last]);
      }
      last = stage;
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    jt::wgmma_wait<0>();
    jt::fence_operands(acc);
    if (wt == 0) jt::mbar_arrive(&empty[last]);
    store_rows<N>(acc, y, N, tile * BM + wg * 64, M, 0, wt);
  }
}

template <int N>
cudaError_t launch_streamed(const void* a, const void* b, void* y, int m,
                            int k, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  const uint64_t a_dims[2] = {uint64_t(k), uint64_t(m)};
  const uint64_t a_strides[2] = {2, uint64_t(k) * 2};
  const uint32_t a_box[2] = {KC, BM};
  const uint64_t b_dims[2] = {uint64_t(N), uint64_t(k)};
  const uint64_t b_strides[2] = {2, uint64_t(N) * 2};
  const uint32_t b_box[2] = {64, KC};
  cudaError_t e = jt::encode_bf16(&amap, a, 2, a_dims, a_strides, a_box);
  if (e != cudaSuccess) return e;
  e = jt::encode_bf16(&bmap, b, 2, b_dims, b_strides, b_box);
  if (e != cudaSuccess) return e;
  static int grid_cap[MAX_DEVICES] = {};
  const int cap = jt::persistent_grid(probe_dot_kernel<N>, THREADS,
                                      Streamed<N>::SMEM, grid_cap,
                                      MAX_DEVICES, &e);
  if (cap == 0) return e;
  const int tiles = (m + BM - 1) / BM;
  const int grid = tiles < cap ? tiles : cap;
  probe_dot_kernel<N><<<grid, THREADS, Streamed<N>::SMEM, stream>>>(
      amap, bmap, static_cast<__nv_bfloat16*>(y), m, k);
  return cudaGetLastError();
}

cudaError_t launch_resident(const void* a, const void* b, void* y, int m,
                            int k, int n, int tile_m, cudaStream_t stream) {
  // A's map covers A_blk only: rows past tile_m arrive as zeros.
  CUtensorMap amap, bmap;
  const uint64_t a_dims[2] = {uint64_t(k), uint64_t(tile_m)};
  const uint64_t a_strides[2] = {2, uint64_t(k) * 2};
  const uint32_t a_box[2] = {KC, RBM};
  const uint64_t b_dims[2] = {uint64_t(n), uint64_t(k)};
  const uint64_t b_strides[2] = {2, uint64_t(n) * 2};
  const uint32_t b_box[2] = {RBN, KC};
  cudaError_t e = jt::encode_bf16(&amap, a, 2, a_dims, a_strides, a_box);
  if (e != cudaSuccess) return e;
  e = jt::encode_bf16(&bmap, b, 2, b_dims, b_strides, b_box);
  if (e != cudaSuccess) return e;
  static int grid_cap[MAX_DEVICES] = {};
  const int cap = jt::persistent_grid(probe_dot_resident_kernel, R_THREADS,
                                      R_SMEM, grid_cap, MAX_DEVICES, &e);
  if (cap == 0) return e;
  const int row_blocks = (tile_m + RBM - 1) / RBM;
  const int col_blocks = n / RBN;
  const int tiles = m / tile_m;
  int groups = cap / (row_blocks * col_blocks);
  if (groups < 1) groups = 1;
  if (groups > tiles) groups = tiles;
  if (groups > 65535) groups = 65535;
  const dim3 grid(row_blocks, col_blocks, groups);
  probe_dot_resident_kernel<<<grid, R_THREADS, R_SMEM, stream>>>(
      amap, bmap, static_cast<__nv_bfloat16*>(y), m, k, n, tile_m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (m, k), b (k, n), y (m, n), all bf16 row-major; n in {64, 128};
// k % 64 == 0, k <= 576; tile_m divides m; a and b 16-byte aligned.
// Returns the cudaError_t after the launch.
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
