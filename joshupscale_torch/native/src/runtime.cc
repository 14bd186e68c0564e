// Runtime facade over the PyTorch port: frame validation,
// strided/bottom-up frame staging, backend selection and createRuntime.
// A copy of native/src/runtime.cc with the port's own backend choice.

#include <dlfcn.h>

#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "aoti_backend.h"
#include "backend.h"
#include "joshupscale/core.h"
#include "logging.h"
#include "python_backend.h"

#ifndef JOSHUPSCALE_TORCH_OPS_DEFAULT
#error "JOSHUPSCALE_TORCH_OPS_DEFAULT (the op library's path) is not defined"
#endif

namespace JoshUpscale {
namespace core {

namespace {

// Copy a possibly strided / bottom-up (negative stride) BGR24 frame to
// a contiguous buffer (host-side analog of the reference's
// cudaMemcpy2DAsync path, cuda_convert.cc.cu:380-436).
void copyToContiguous(const Image &img, std::vector<std::uint8_t> *dst) {
  std::size_t rowBytes = img.width * 3;
  dst->resize(rowBytes * img.height);
  const auto *src = static_cast<const std::uint8_t *>(img.ptr);
  for (std::size_t y = 0; y < img.height; ++y) {
    std::memcpy(dst->data() + y * rowBytes,
                src + static_cast<std::ptrdiff_t>(y) * img.stride,
                rowBytes);
  }
}

void copyFromContiguous(const std::vector<std::uint8_t> &src,
                        const Image &img) {
  std::size_t rowBytes = img.width * 3;
  if (src.size() != rowBytes * img.height) {
    throw std::runtime_error("Output size mismatch");
  }
  auto *dst = static_cast<std::uint8_t *>(img.ptr);
  for (std::size_t y = 0; y < img.height; ++y) {
    std::memcpy(dst + static_cast<std::ptrdiff_t>(y) * img.stride,
                src.data() + y * rowBytes, rowBytes);
  }
}

// The CPU is chosen only where the environment names it
// (JOSHUPSCALE_TORCH_DEVICE=cpu, the counterpart of the JAX host's
// JAX_PLATFORMS=cpu); otherwise the device id is a CUDA index, and no
// card is an error, never a quiet CPU run.
bool cpuRequested() {
  const char *device = std::getenv("JOSHUPSCALE_TORCH_DEVICE");
  if (device == nullptr || device[0] == '\0' ||
      std::strcmp(device, "cuda") == 0) {
    return false;
  }
  if (std::strcmp(device, "cpu") == 0) {
    return true;
  }
  throw std::runtime_error(
      std::string("JOSHUPSCALE_TORCH_DEVICE must be cpu or cuda, got ") +
      device);
}

// The op library's path: JOSHUPSCALE_TORCH_OPS_DEFAULT as compiled in,
// a file name in the directory that holds this library (the build tree
// and the install tree alike), or an absolute path.
std::string opsLibrary() {
  const std::string name = JOSHUPSCALE_TORCH_OPS_DEFAULT;
  if (name.empty() || name[0] == '/') {
    return name;
  }
  Dl_info info;
  if (dladdr(reinterpret_cast<void *>(&createRuntime), &info) == 0 ||
      info.dli_fname == nullptr) {
    throw std::runtime_error("Cannot locate libjoshupscale_torch to find "
                             "the op library " + name);
  }
  const std::string self = info.dli_fname;
  const std::size_t slash = self.rfind('/');
  return (slash == std::string::npos ? std::string(".")
                                     : self.substr(0, slash)) + '/' + name;
}

// Backend choice: JOSHUPSCALE_TORCH_AOTI=1 selects the Python-free
// AOTInductor path (the counterpart of JOSHUPSCALE_PJRT_PLUGIN), which
// needs the package's step.pt2 and raises without it; everything else
// serves through the embedded-CPython engine, which handles any package.
std::unique_ptr<Backend> createBackend(int deviceId,
                                       const char *modelPath) {
  const bool cpu = cpuRequested();
  const char *aoti = std::getenv("JOSHUPSCALE_TORCH_AOTI");
  if (aoti != nullptr && aoti[0] != '\0' && std::strcmp(aoti, "0") != 0) {
    return std::make_unique<AotiEngine>(modelPath, deviceId, cpu,
                                        opsLibrary());
  }
  return std::make_unique<TorchPythonEngine>(deviceId, cpu, modelPath);
}

class TorchRuntime final : public Runtime {
 public:
  TorchRuntime(int deviceId, const char *modelPath)
      : m_engine(createBackend(deviceId, modelPath)) {}

  void processImage(const Image &in, const Image &out) override {
    validate(in, m_engine->inputWidth(), m_engine->inputHeight(), "input");
    validate(out, m_engine->outputWidth(), m_engine->outputHeight(),
             "output");
    copyToContiguous(in, &m_inBuffer);
    m_engine->process(m_inBuffer.data(), m_inBuffer.size(), &m_outBuffer);
    copyFromContiguous(m_outBuffer, out);
  }

  bool processImageAsync(const Image &in, const Image &out) override {
    validate(in, m_engine->inputWidth(), m_engine->inputHeight(), "input");
    validate(out, m_engine->outputWidth(), m_engine->outputHeight(),
             "output");
    copyToContiguous(in, &m_inBuffer);
    if (!m_engine->processAsync(m_inBuffer.data(), m_inBuffer.size(),
                                &m_outBuffer)) {
      return false;
    }
    copyFromContiguous(m_outBuffer, out);
    return true;
  }

  bool flushImage(const Image &out) override {
    validate(out, m_engine->outputWidth(), m_engine->outputHeight(),
             "output");
    if (!m_engine->flush(&m_outBuffer)) {
      return false;
    }
    copyFromContiguous(m_outBuffer, out);
    return true;
  }

  void reset() override { m_engine->reset(); }

  std::size_t getInputWidth() const noexcept override {
    return m_engine->inputWidth();
  }
  std::size_t getInputHeight() const noexcept override {
    return m_engine->inputHeight();
  }
  std::size_t getOutputWidth() const noexcept override {
    return m_engine->outputWidth();
  }
  std::size_t getOutputHeight() const noexcept override {
    return m_engine->outputHeight();
  }

 private:
  static void validate(const Image &img, std::size_t width,
                       std::size_t height, const char *what) {
    if (img.location != DataLocation::CPU) {
      throw std::runtime_error(
          std::string("Only CPU frames are supported for ") + what);
    }
    if (img.ptr == nullptr) {
      throw std::runtime_error(std::string("Null ") + what + " frame");
    }
    if (img.width != width || img.height != height) {
      throw std::runtime_error(
          std::string("Invalid ") + what + " dimensions: got " +
          std::to_string(img.width) + 'x' + std::to_string(img.height) +
          ", expected " + std::to_string(width) + 'x' +
          std::to_string(height));
    }
  }

  std::unique_ptr<Backend> m_engine;
  std::vector<std::uint8_t> m_inBuffer;
  std::vector<std::uint8_t> m_outBuffer;
};

}  // namespace

Runtime *createRuntime(int deviceId, const char *modelPath) {
  JOSHUPSCALE_LOG_INFO << "createRuntime(device=" << deviceId
                       << ", model=" << modelPath << ')';
  return new TorchRuntime(deviceId, modelPath);
}

}  // namespace core
}  // namespace JoshUpscale
