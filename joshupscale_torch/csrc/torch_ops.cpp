// K1, K2 and K3 as registered torch ops: torch.ops.joshupscale.*.
//
// One binding serves the eager wrappers (kernels/resblock.py,
// kernels/display.py, kernels/warp.py), torch.export and an AOTInductor
// package, in a
// Python process or in the C++ host (joshupscale_torch/native/), which
// loads this library before it runs a CUDA package.
//
//   resblock_conv3x3(x, w, scale, offset, residual?, act, alpha) -> y
//   d2s_display_u8(x) -> u8 frame
//   warp_s2d(image, flow, row0) -> warped image (s2d form)
//
// The CUDA implementations check every operand (shape, dtype, device,
// contiguity, and the 16-byte alignment TMA needs; a bad operand raises
// ValueError, a wrong type TypeError), then call the
// kernels' plain C entry points (csrc/resblock_conv.cu,
// csrc/display_u8.cu, csrc/warp_s2d.cu) on the current stream of the
// operands' device.  warp_s2d takes any image layout and a strided flow:
// it makes a contiguous image (and a 4-byte-aligned bf16 one) and a flow
// with unit channel stride where they are not.
// The Meta implementations give the output's shape and type, which is
// what torch.export traces through.  A build without CUDA (a CPU-only
// torch) registers the schemas and the Meta implementations only.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/util/Exception.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>

#ifdef JOSHUPSCALE_OPS_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" {
int jt_resblock_conv3x3(int dtype, const void* x, const void* w,
                        const void* scale, const void* offset,
                        const void* residual, void* y, int n, int h, int wd,
                        int c, int act, float alpha, void* stream);
int jt_d2s_display_u8(int dtype, const void* x, void* out, int n, int hb,
                      int wb, void* stream);
int jt_warp_s2d(int image_dtype, int flow_dtype, const void* image,
                const void* flow, void* out, int n, int hb, int wb, int hq,
                int row0, long long fs_n, long long fs_y, long long fs_x,
                void* stream);
const char* jt_error_string(int err);
}
#endif

namespace {

int dtype_code(const at::Tensor& t) {
  if (t.scalar_type() == at::kFloat) return 0;
  if (t.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK_TYPE(false, "joshupscale: expected float32 or bfloat16, got ",
                   t.scalar_type());
  return -1;
}

// The operands' shapes and types, as kernels/resblock.py checks them.
void check_resblock(const at::Tensor& x, const at::Tensor& w,
                    const at::Tensor& scale, const at::Tensor& offset,
                    const std::optional<at::Tensor>& residual, int64_t act) {
  TORCH_CHECK_VALUE(act == 0 || act == 1, "resblock_conv3x3: act must be 0 "
                    "(relu) or 1 (lrelu), got ", act);
  TORCH_CHECK_VALUE(x.dim() == 4, "resblock_conv3x3: x must be NHWC (4-D), "
                    "got ", x.sizes());
  const int64_t c = x.size(3);
  TORCH_CHECK_VALUE(c == 32 || c == 48 || c == 64,
                    "resblock_conv3x3: C must be 32, 48 or 64, got ", c);
  dtype_code(x);
  TORCH_CHECK_VALUE(w.sizes() == at::IntArrayRef({c, 3, 3, c}) &&
                        w.scalar_type() == x.scalar_type(),
                    "resblock_conv3x3: w must be OHWI (C, 3, 3, C) in x's "
                    "dtype, got ", w.sizes(), " ", w.scalar_type());
  for (const at::Tensor* t : {&scale, &offset}) {
    TORCH_CHECK_VALUE(t->sizes() == at::IntArrayRef({c}) &&
                          t->scalar_type() == at::kFloat,
                      "resblock_conv3x3: scale and offset must be float32 "
                      "(C,), got ", t->sizes(), " ", t->scalar_type());
  }
  if (residual.has_value()) {
    TORCH_CHECK_VALUE(residual->sizes() == x.sizes() &&
                          residual->scalar_type() == x.scalar_type() &&
                          residual->device() == x.device(),
                      "resblock_conv3x3: residual must match x in shape, "
                      "dtype and device");
  }
  for (const at::Tensor* t : {&w, &scale, &offset}) {
    TORCH_CHECK_VALUE(t->device() == x.device(),
                      "resblock_conv3x3: all operands must be on one device");
  }
}

void check_display(const at::Tensor& x) {
  TORCH_CHECK_VALUE(x.dim() == 4 && x.size(3) == 48,
                    "d2s_display_u8: x must be (N, Hb, Wb, 48), got ",
                    x.sizes());
  dtype_code(x);
}

// warp_s2d's image: (N, Hb, Wb, 48) float32, bfloat16 or uint8; flow:
// (N, Hq, Wb, 32) float32 or bfloat16.  Returns the image's type code
// (0 float32, 1 bfloat16, 2 uint8).
int check_warp(const at::Tensor& image, const at::Tensor& flow,
               int64_t row0) {
  TORCH_CHECK_VALUE(image.dim() == 4 && image.size(3) == 48,
                    "warp_s2d: image must be (N, Hb, Wb, 48), got ",
                    image.sizes());
  TORCH_CHECK_VALUE(flow.dim() == 4 && flow.size(0) == image.size(0) &&
                        flow.size(2) == image.size(2) && flow.size(3) == 32,
                    "warp_s2d: flow must be (N, Hq, Wb, 32) for an image ",
                    image.sizes(), ", got ", flow.sizes());
  TORCH_CHECK_VALUE(row0 >= -(int64_t{1} << 28) &&
                        row0 + flow.size(1) <= (int64_t{1} << 28),
                    "warp_s2d: row0 out of range: ", row0);
  TORCH_CHECK_VALUE(flow.device() == image.device(),
                    "warp_s2d: image and flow must be on one device");
  dtype_code(flow);
  if (image.scalar_type() == at::kByte) return 2;
  return dtype_code(image);
}

at::Tensor warp_empty(const at::Tensor& image, const at::Tensor& flow) {
  const auto dtype =
      image.scalar_type() == at::kFloat ? at::kFloat : at::kBFloat16;
  return at::empty({image.size(0), flow.size(1), image.size(2), 48},
                   image.options().dtype(dtype));
}

at::Tensor resblock_meta(const at::Tensor& x, const at::Tensor& w,
                         const at::Tensor& scale, const at::Tensor& offset,
                         const std::optional<at::Tensor>& residual,
                         int64_t act, double alpha) {
  (void)alpha;
  check_resblock(x, w, scale, offset, residual, act);
  return at::empty_like(x, at::MemoryFormat::Contiguous);
}

at::Tensor display_meta(const at::Tensor& x) {
  check_display(x);
  return at::empty({x.size(0), 4 * x.size(1), 4 * x.size(2), 3},
                   x.options().dtype(at::kByte));
}

at::Tensor warp_meta(const at::Tensor& image, const at::Tensor& flow,
                     int64_t row0) {
  check_warp(image, flow, row0);
  return warp_empty(image, flow);
}

#ifdef JOSHUPSCALE_OPS_CUDA

// Contiguous and 16-byte aligned: what the kernels' TMA descriptors and
// vector loads take.
void check_operand(const at::Tensor& t, const char* op) {
  TORCH_CHECK_VALUE(t.is_cuda(), op, ": operands must be CUDA tensors");
  TORCH_CHECK_VALUE(t.is_contiguous(), op, ": operands must be contiguous");
  TORCH_CHECK_VALUE(
      reinterpret_cast<std::uintptr_t>(t.data_ptr()) % 16 == 0, op,
      ": operands must be 16-byte aligned");
}

void check_launch(int err, const char* op) {
  TORCH_CHECK(err == 0, op, " launch: CUDA error ", err, " (",
              jt_error_string(err), ")");
}

at::Tensor resblock_cuda(const at::Tensor& x, const at::Tensor& w,
                         const at::Tensor& scale, const at::Tensor& offset,
                         const std::optional<at::Tensor>& residual,
                         int64_t act, double alpha) {
  check_resblock(x, w, scale, offset, residual, act);
  for (const at::Tensor* t : {&x, &w, &scale, &offset}) {
    check_operand(*t, "resblock_conv3x3");
  }
  if (residual.has_value()) check_operand(*residual, "resblock_conv3x3");
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor y = at::empty_like(x, at::MemoryFormat::Contiguous);
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  check_launch(
      jt_resblock_conv3x3(
          dtype_code(x), x.data_ptr(), w.data_ptr(), scale.data_ptr(),
          offset.data_ptr(),
          residual.has_value() ? residual->data_ptr() : nullptr,
          y.data_ptr(), static_cast<int>(x.size(0)),
          static_cast<int>(x.size(1)), static_cast<int>(x.size(2)),
          static_cast<int>(x.size(3)), static_cast<int>(act),
          static_cast<float>(alpha), stream),
      "resblock_conv3x3");
  return y;
}

at::Tensor display_cuda(const at::Tensor& x) {
  check_display(x);
  check_operand(x, "d2s_display_u8");
  c10::cuda::CUDAGuard guard(x.device());
  at::Tensor out = at::empty({x.size(0), 4 * x.size(1), 4 * x.size(2), 3},
                             x.options().dtype(at::kByte));
  void* stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  check_launch(jt_d2s_display_u8(dtype_code(x), x.data_ptr(), out.data_ptr(),
                                 static_cast<int>(x.size(0)),
                                 static_cast<int>(x.size(1)),
                                 static_cast<int>(x.size(2)), stream),
               "d2s_display_u8");
  return out;
}

at::Tensor warp_cuda(const at::Tensor& image_in, const at::Tensor& flow_in,
                     int64_t row0) {
  const int image_dtype = check_warp(image_in, flow_in, row0);
  TORCH_CHECK_VALUE(image_in.is_cuda(), "warp_s2d: operands must be CUDA "
                    "tensors");
  at::Tensor image = image_in.contiguous();
  if (image_dtype == 1 &&
      reinterpret_cast<std::uintptr_t>(image.data_ptr()) % 4 != 0) {
    image = at::empty_like(image, at::MemoryFormat::Contiguous);
    image.copy_(image_in);
  }
  at::Tensor flow = flow_in.stride(3) == 1 ? flow_in : flow_in.contiguous();
  c10::cuda::CUDAGuard guard(image.device());
  at::Tensor out = warp_empty(image, flow);
  if (out.numel() == 0) return out;
  void* stream =
      c10::cuda::getCurrentCUDAStream(image.device().index()).stream();
  check_launch(
      jt_warp_s2d(image_dtype, dtype_code(flow), image.data_ptr(),
                  flow.data_ptr(), out.data_ptr(),
                  static_cast<int>(image.size(0)),
                  static_cast<int>(image.size(1)),
                  static_cast<int>(image.size(2)),
                  static_cast<int>(flow.size(1)), static_cast<int>(row0),
                  flow.stride(0), flow.stride(1), flow.stride(2), stream),
      "warp_s2d");
  return out;
}

#endif  // JOSHUPSCALE_OPS_CUDA

}  // namespace

TORCH_LIBRARY(joshupscale, m) {
  m.def(
      "resblock_conv3x3(Tensor x, Tensor w, Tensor scale, Tensor offset, "
      "Tensor? residual, int act, float alpha) -> Tensor");
  m.def("d2s_display_u8(Tensor x) -> Tensor");
  m.def("warp_s2d(Tensor image, Tensor flow, int row0) -> Tensor");
}

TORCH_LIBRARY_IMPL(joshupscale, Meta, m) {
  m.impl("resblock_conv3x3", &resblock_meta);
  m.impl("d2s_display_u8", &display_meta);
  m.impl("warp_s2d", &warp_meta);
}

#ifdef JOSHUPSCALE_OPS_CUDA
TORCH_LIBRARY_IMPL(joshupscale, CUDA, m) {
  m.impl("resblock_conv3x3", &resblock_cuda);
  m.impl("d2s_display_u8", &display_cuda);
  m.impl("warp_s2d", &warp_cuda);
}
#endif
