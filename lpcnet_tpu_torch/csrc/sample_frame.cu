// One free-run 160-sample LPCNet frame for a batch of streams: the
// sample loop of sample_loop.cuh without teacher forcing or freeze.
//
// Replaces the TPU kernels of lpcnet_tpu/kernels/sample_pallas.py:
//   K1 _frame_kernel_flat (flat sampling tree, the default variant) and
//   K2 _frame_kernel (walked sampling tree), both driven by
//   synthesize_frame_pallas / synthesize_frames_pallas. One kernel with a
//   compile-time sampler switch covers both; the two give the same bits.
//   Each has an instance on float32 embedding tables and one on bfloat16
//   tables (the TPU kernels' wdtype, table_dtype in the JAX package).
// What bounds it on an H100, the two launch plans and what each does about
// it are in sample_loop.cuh.

#include "sample_loop.cuh"

using lpcnet::FRAME;

extern "C" {

// Launches one frame under `plan` (0: L, 1: T) with `grid` CTAs on
// `stream`, with the flat or the walked sampler and on float32 or (bf16)
// bfloat16 embedding tables; `clusters` is the count lpcnet_prepare_plans
// gave. Returns the cudaError_t of the launch.
int lpcnet_sample_frame(const LpcnetFrameParams* p, int flat, int bf16,
                        int plan, int grid, int clusters, void* stream) {
  if (p->batch <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using lpcnet::launch_sample;
  if (bf16)
    return (int)(flat
        ? launch_sample<FRAME, true, false, true>(p, plan, grid, clusters, s)
        : launch_sample<FRAME, false, false, true>(p, plan, grid, clusters,
                                                   s));
  return (int)(flat
      ? launch_sample<FRAME, true, false>(p, plan, grid, clusters, s)
      : launch_sample<FRAME, false, false>(p, plan, grid, clusters, s));
}

// The same frame through the phase-split instance (flat sampler): the
// clock cycles of each phase on the first CTA into p->prof.
int lpcnet_sample_phases(const LpcnetFrameParams* p, int plan, int grid,
                         int clusters, void* stream) {
  if (p->batch <= 0 || p->prof == nullptr) return (int)cudaErrorInvalidValue;
  return (int)lpcnet::launch_sample<FRAME, true, true>(
      p, plan, grid, clusters, static_cast<cudaStream_t>(stream));
}

// Readies every instance of this library on the current device and lowers
// *count to the least number of plan-L clusters any of them runs at once.
int lpcnet_prepare_plans(int* count) {
  cudaError_t err = lpcnet::prepare_plans<FRAME, true, false>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<FRAME, false, false>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<FRAME, true, true>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<FRAME, true, false, true>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<FRAME, false, false, true>(count);
  return (int)err;
}

const char* lpcnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
