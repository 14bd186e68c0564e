// Stage markers: three empty kernels that mark where a frame's stages
// end on the card's timeline.
//
// A replayed CUDA graph carries no op ranges, so a profiler trace of the
// frame graph cannot put its kernels down to a stage.  The engine's
// marked frame graph (replayed only while a profiler session is active)
// launches one of these after the flow net, after the warp and after
// the generator; a reader of the trace splits the frame's kernels at the
// markers' timestamps.  Each is <<<1, 1>>> on the given stream and
// touches no data, so the marked graph computes what the plain one
// does.  The kernels are extern "C", so the trace shows their names
// verbatim.
#include <cuda_runtime.h>

extern "C" {

__global__ void stage_end_flow() {}
__global__ void stage_end_warp() {}
__global__ void stage_end_generator() {}

// which: 0 flow, 1 warp, 2 generator.  Returns the cudaError_t after
// the launch.
int jt_stage_markers(int which, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: stage_end_flow<<<1, 1, 0, st>>>(); break;
    case 1: stage_end_warp<<<1, 1, 0, st>>>(); break;
    case 2: stage_end_generator<<<1, 1, 0, st>>>(); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

const char* jt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
