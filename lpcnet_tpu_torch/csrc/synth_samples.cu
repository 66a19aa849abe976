// `nsamples` autoregressive steps under one condition set for a batch of
// streams, with optional teacher forcing and per-stream active counts: the
// primitive of the packet-loss-concealment engines.
//
// Replaces the TPU kernels of lpcnet_tpu/kernels/sample_pallas.py:
//   K3 _tf_frame_kernel_flat (flat sampling tree) and _tf_frame_kernel
//   (walked tree), both driven by synth_samples_pallas.
// It is the sample loop of sample_loop.cuh with TF = true:
//   * target (B, ns): on steps i < preload[b] or i >= force_from[b] stream
//     b follows the target: tf_sig = tgt - preemph*deemph, exc =
//     lin2ulaw(tf_sig - pred), pcm = tf_sig, and the step emits the target
//     (sample_pallas.py:294-315). The sampler still runs and the RNG still
//     advances. One launch so serves lost rows (never forced), good rows
//     (forced throughout) and blend rows (forced from the middle).
//   * n_active (B): on steps i >= n_active[b] stream b keeps every state,
//     RNG included, and emits 0 (sample_pallas.py:317-326).
//   * nsamples is a run-time argument (whole frames and half frames both
//     occur); target and pcm are read and written as (B, ns) rows.
// The TPU kernel makes the presence of each input a compile-time flag; here
// a null target or n_active pointer, uniform over the grid, switches that
// part off, so two instances (one per sampler) serve every flag set.
// What bounds it on an H100, the two launch plans and what each does about
// it are in sample_loop.cuh.

#include "sample_loop.cuh"

using lpcnet::FORCED;

extern "C" {

// Launches one call under `plan` (0: L, 1: T) with `grid` CTAs on
// `stream`; `clusters` is the count lpcnet_prepare_plans gave. Returns the
// cudaError_t of the launch.
int lpcnet_synth_samples(const LpcnetFrameParams* p, int flat, int plan,
                         int grid, int clusters, void* stream) {
  if (p->batch <= 0 || p->nsamples <= 0) return (int)cudaErrorInvalidValue;
  if (p->target != nullptr && (p->preload == nullptr
                               || p->force_from == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(flat
      ? lpcnet::launch_sample<FORCED, true, false>(p, plan, grid, clusters, s)
      : lpcnet::launch_sample<FORCED, false, false>(p, plan, grid, clusters,
                                                    s));
}

// Readies both instances of this library on the current device and lowers
// *count to the least number of plan-L clusters either runs at once.
int lpcnet_prepare_plans(int* count) {
  cudaError_t err = lpcnet::prepare_plans<FORCED, true, false>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<FORCED, false, false>(count);
  return (int)err;
}

const char* lpcnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
