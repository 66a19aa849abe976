// One free-run 160-sample LPCNet frame for a batch of streams: the
// sample loop of lpcnet_sample.cuh without teacher forcing or freeze.
//
// Replaces the TPU kernels of lpcnet_tpu/kernels/sample_pallas.py:
//   K1 _frame_kernel_flat (flat sampling tree, the default variant) and
//   K2 _frame_kernel (walked sampling tree), both driven by
//   synthesize_frame_pallas / synthesize_frames_pallas. One kernel with a
//   compile-time sampler switch covers both; the two give the same bits.
// What bounds it on an H100 and what the design does about it is in
// lpcnet_sample.cuh.

#include "lpcnet_sample.cuh"

extern "C" {

// Launches one frame on `stream`; returns the cudaError_t of the launch.
int lpcnet_sample_frame(const LpcnetFrameParams* p, int flat, void* stream) {
  if (p->batch <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(flat ? lpcnet::launch_sample<true, false>(p, s)
                    : lpcnet::launch_sample<false, false>(p, s));
}

const char* lpcnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
