// The state advance of a batch of streams over a fully teacher-forced
// segment: the sample loop of sample_loop.cuh without its tail (KIND
// TEACHER).
//
// Replaces the TPU kernel K4 _teacher_kernel of
// lpcnet_tpu/kernels/sample_pallas.py and the work its driver
// teacher_advance_pallas does around it in XLA (the table indices of every
// step, the de-emphasis chain, the RNG advanced by 2*ns draws). Under full
// forcing the signal and excitation of every sample follow from the target
// alone, so the step is: prediction and mu-law indices from the forced
// signal (phase A, on the stream threads), the RNG advanced by two KISS99
// draws without threshold lookups, GRU-A, GRU-B, and the forced update of
// the signal, de-emphasis and excitation (phase H). No dual-FC, no
// sampler, no pcm: the forced output is the target itself. Every state
// field comes out: gru_a, gru_b, last_sig, last_exc, deemph, rng. The
// same code runs in a fully forced synth_samples launch (K3), so the two
// leave the same bits.
// What bounds it on an H100 and the two launch plans are in
// sample_loop.cuh; without the tail the step is GRU-A, the exchanges and
// GRU-B.

#include "sample_loop.cuh"

using lpcnet::TEACHER;

namespace {

int check(const LpcnetFrameParams* p) {
  if (p->batch <= 0 || p->nsamples <= 0 || p->target == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Launches one call over p->nsamples forced steps under `plan` (0: L, 1:
// T) with `grid` CTAs on `stream`; `clusters` is the count
// lpcnet_prepare_plans gave. Returns the cudaError_t of the launch.
int lpcnet_teacher_advance(const LpcnetFrameParams* p, int plan, int grid,
                           int clusters, void* stream) {
  if (int err = check(p)) return err;
  return (int)lpcnet::launch_sample<TEACHER, false, false>(
      p, plan, grid, clusters, static_cast<cudaStream_t>(stream));
}

// The same call through the phase-split instance: the clock cycles of
// each phase on the first CTA into p->prof.
int lpcnet_teacher_phases(const LpcnetFrameParams* p, int plan, int grid,
                          int clusters, void* stream) {
  if (int err = check(p)) return err;
  if (p->prof == nullptr) return (int)cudaErrorInvalidValue;
  return (int)lpcnet::launch_sample<TEACHER, false, true>(
      p, plan, grid, clusters, static_cast<cudaStream_t>(stream));
}

// Readies both instances of this library on the current device and lowers
// *count to the least number of plan-L clusters either runs at once.
int lpcnet_prepare_plans(int* count) {
  cudaError_t err = lpcnet::prepare_plans<TEACHER, false, false>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<TEACHER, false, true>(count);
  return (int)err;
}

const char* lpcnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
