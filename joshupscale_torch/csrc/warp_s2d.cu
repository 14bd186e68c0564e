// K3: the s2d dense warp (bilinear, tfa edge clamp) for Hopper.
//
//   out[n, by, bx, (py*4 + px)*3 + c] = bilinear(image, (Y - fy, X - fx))
//   with Y = (row0 + by)*4 + py, X = bx*4 + px, (fy, fx) = flow[n, by, bx,
//   2p : 2p + 2], p = py*4 + px, and image read in s2d form: pixel (y, x)
//   at image[n, y/4, x/4, ((y%4)*4 + x%4)*3 + c].
//
// Replaces no TPU kernel: joshupscale_tpu/ops/warp.py dense_image_warp_s2d
// is plain XLA on the TPU (Mosaic has no in-kernel dynamic gather), and
// the port ran it as torch ops -- three cats into a 75-lane corner table,
// a row gather, a corner-major copy and a 25-term combine, about 170
// launches and 3.5 ms a frame at 270x480 on an H100.  This kernel does the
// same arithmetic in one launch and is bit-exact with that path
// (ops/warp.py dense_image_warp_s2d_plain), because it rounds at the same
// places in the same order:
//   - q = (Y or X) - f in float32; fl = clamp(floor(q), 0, size - 2);
//     a = clamp(q - fl, 0, 1), rounded to the compute type (float32 for a
//     float32 table, else bfloat16);
//   - weights r(r(1 - a_y or a_y) * r(1 - a_x or a_x)), r rounding to the
//     compute type (1 - a rounded once more);
//   - acc = r(r(r(r(0 + t00) + t01) + t10) + t11), t = r(v * w), in the
//     plain loop's order (corner row outer, column inner).  The plain
//     combine's other 21 terms are exact zeros (a zero weight times a
//     finite value) and leave the sum as it is;
//   - a uint8 table's values are exact in bfloat16; after the sum,
//     r_bf16(r32(acc * float(1/255)) - 0.5).
// Every product and sum is __fmul_rn / __fadd_rn / __fsub_rn, so nvcc
// contracts nothing into an FMA.  The floor corner is clamped to
// [0, size - 2], so the corners (y, y + 1) x (x, x + 1) always lie inside
// the image and the plain path's edge-shifted table copies never engage:
// the kernel reads the four corners straight from the s2d image.
//
// What bounds it on an H100: its bytes would allow 9.9 us at (1, 270,
// 480, 48) bf16 (it reads the flow, 8.3 MB, and the image, 12.4 MB, and
// writes 12.4 MB: 33 MB at 3.35 TB/s), but at about 200 instructions a
// thread its instruction count bounds it: 26-27 us.  (Rounding with
// integer ops instead of cvt took 48 us.)  Design: one thread an output
// pixel (s2d block, phase), 16 threads a block, 256 a CTA along a block
// row (grid: row chunks x block rows x images).  Neighbouring
// threads read neighbouring flow values and write neighbouring outputs
// (a warp stores 192 contiguous bytes); the corner reads go through the
// read-only path, where the 12.4 MB image sits in the 50 MB L2, and with
// a smooth flow a warp's corners fall in a few neighbouring blocks.  A
// bf16 pixel's three values are 6 bytes at an even element offset of a
// 4-byte-aligned 96-byte block, so they come in as two aligned 32-bit
// loads (8 loads for the four corners instead of 12).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 4;           // s2d block
constexpr int P = B * B;       // phases a block
constexpr int C = 3;           // channels
constexpr int CS = P * C;      // 48 values a block
constexpr int THREADS = 256;

// Image / flow type codes (jt_warp_s2d's arguments).
constexpr int F32 = 0, BF16 = 1, U8 = 2;

__device__ __forceinline__ float bf16_bits(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rounding to the compute type: float32 for a float32 image, else bf16.
template <int kImage>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kImage == F32) {
    return x;
  } else {
    return round_bf16(x);
  }
}

template <int kFlow>
__device__ __forceinline__ float load_flow(const void* flow, long long i) {
  if constexpr (kFlow == F32) {
    return __ldg(static_cast<const float*>(flow) + i);
  } else {
    return bf16_bits(__ldg(static_cast<const unsigned short*>(flow) + i));
  }
}

// The three values of the pixel at sub-position `sub` of the s2d block
// whose first value is element `blk` of the image.
template <int kImage>
__device__ __forceinline__ void load_pixel(const void* image, long long blk,
                                           int sub, float v[C]) {
  const long long e = blk + sub * C;
  if constexpr (kImage == F32) {
    const float* q = static_cast<const float*>(image) + e;
    v[0] = __ldg(q);
    v[1] = __ldg(q + 1);
    v[2] = __ldg(q + 2);
  } else if constexpr (kImage == U8) {
    const uint8_t* q = static_cast<const uint8_t*>(image) + e;
    v[0] = float(__ldg(q));
    v[1] = float(__ldg(q + 1));
    v[2] = float(__ldg(q + 2));
  } else {
    // e is even for an even sub, odd for an odd one; the two words start
    // at e - (sub & 1), an even element, and stay inside the block.
    const int odd = sub & 1;
    const unsigned int* w = reinterpret_cast<const unsigned int*>(
        static_cast<const unsigned short*>(image) + (e - odd));
    const uint32_t a = __ldg(w), b = __ldg(w + 1);
    v[0] = bf16_bits(odd ? a >> 16 : a & 0xffffu);
    v[1] = bf16_bits(odd ? b & 0xffffu : a >> 16);
    v[2] = bf16_bits(odd ? b >> 16 : b & 0xffffu);
  }
}

// The clamped floor corner and the weight of query q on an axis of
// `size` pixels (ops/warp.py _floor_and_alpha, then the cast).
template <int kImage>
__device__ __forceinline__ int floor_and_alpha(float q, int size, float* a) {
  const float fl = fminf(fmaxf(floorf(q), 0.0f), float(size - 2));
  *a = rnd<kImage>(fminf(fmaxf(__fsub_rn(q, fl), 0.0f), 1.0f));
  return int(fl);
}

template <int kImage, int kFlow>
__global__ void __launch_bounds__(THREADS) warp_s2d_bilinear(
    const void* __restrict__ image, const void* __restrict__ flow,
    void* __restrict__ out, int hb, int wb, int hq, int row0,
    long long fs_n, long long fs_y, long long fs_x, float inv255) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= wb * P) return;
  const int bx = t / P, p = t % P;
  const int by = blockIdx.y, img = blockIdx.z;
  const int py = p / B, px = p % B;
  const long long fo = img * fs_n + by * fs_y + bx * fs_x + 2 * p;
  const float fy = load_flow<kFlow>(flow, fo);
  const float fx = load_flow<kFlow>(flow, fo + 1);
  const float qy = __fsub_rn(float((row0 + by) * B + py), fy);
  const float qx = __fsub_rn(float(bx * B + px), fx);
  float ay, ax;
  const int y = floor_and_alpha<kImage>(qy, hb * B, &ay);
  const int x = floor_and_alpha<kImage>(qx, wb * B, &ax);

  const float wy[2] = {rnd<kImage>(__fsub_rn(1.0f, ay)), ay};
  const float wx[2] = {rnd<kImage>(__fsub_rn(1.0f, ax)), ax};
  const long long base = (long long)img * hb * wb * CS;
  float v[2][2][C];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int yy = y + dy, xx = x + dx;
      load_pixel<kImage>(
          image, base + ((long long)(yy / B) * wb + xx / B) * CS,
          (yy % B) * B + xx % B, v[dy][dx]);
    }
  }
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float w = rnd<kImage>(__fmul_rn(wy[dy], wx[dx]));
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] = rnd<kImage>(
            __fadd_rn(acc[c], rnd<kImage>(__fmul_rn(v[dy][dx][c], w))));
      }
    }
  }

  const long long o = (((long long)img * hq + by) * wb + bx) * CS + p * C;
  if constexpr (kImage == F32) {
    float* q = static_cast<float*>(out) + o;
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = acc[c];
  } else {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(out) + o;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a = kImage == U8
                          ? __fsub_rn(__fmul_rn(acc[c], inv255), 0.5f)
                          : acc[c];
      q[c] = __float2bfloat16_rn(a);
    }
  }
}

template <int kImage, int kFlow>
cudaError_t launch(const void* image, const void* flow, void* out, int n,
                   int hb, int wb, int hq, int row0, long long fs_n,
                   long long fs_y, long long fs_x, cudaStream_t stream) {
  const dim3 grid((wb * P + THREADS - 1) / THREADS, hq, n);
  // float(1.0 / 255.0): the f32 constant torch multiplies by.
  warp_s2d_bilinear<kImage, kFlow><<<grid, THREADS, 0, stream>>>(
      image, flow, out, hb, wb, hq, row0, fs_n, fs_y, fs_x,
      float(1.0 / 255.0));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// image_dtype: 0 = float32, 1 = bfloat16, 2 = uint8; flow_dtype: 0 =
// float32, 1 = bfloat16.  image: (n, hb, wb, 48) contiguous, a bf16 image
// 4-byte aligned; flow: (n, hq, wb, 32) with element strides fs_n, fs_y,
// fs_x and unit channel stride, rows [row0, row0 + hq) of the image's
// block grid; out: (n, hq, wb, 48) contiguous, float32 for a float32
// image, else bfloat16.  Returns the cudaError_t after the launch.
int jt_warp_s2d(int image_dtype, int flow_dtype, const void* image,
                const void* flow, void* out, int n, int hb, int wb, int hq,
                int row0, long long fs_n, long long fs_y, long long fs_x,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || hb <= 0 || wb <= 0 || hq <= 0 || hq > 65535 || n > 65535 ||
      (long long)wb * P > 0x7fffffffLL || hb * B < 2 || wb * B < 2) {
    return int(cudaErrorInvalidValue);
  }
#define JT_WARP_CASE(I, F)                                                  \
  if (image_dtype == I && flow_dtype == F) {                                \
    return int(launch<I, F>(image, flow, out, n, hb, wb, hq, row0, fs_n,   \
                            fs_y, fs_x, st));                               \
  }
  JT_WARP_CASE(F32, F32)
  JT_WARP_CASE(F32, BF16)
  JT_WARP_CASE(BF16, F32)
  JT_WARP_CASE(BF16, BF16)
  JT_WARP_CASE(U8, F32)
  JT_WARP_CASE(U8, BF16)
#undef JT_WARP_CASE
  return int(cudaErrorInvalidValue);
}

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
