// One free-run 160-sample LPCNet frame for a batch of streams in the
// ordering of the fused TPU loop: the sample loop of sample_loop.cuh with
// the walked sampling tree on the fused operands (KIND FUSE) and,
// optionally, the thresholds drawn one sample ahead (KIND OPT).
//
// Replaces the TPU kernel K5 _frame_kernel_opt (loop _synth_loop_opt) of
// lpcnet_tpu/kernels/sample_pallas.py, driven by synthesize_frame_pallas
// with variant 'fuse' or 'opt'. Its operands are the TPU kernel's, built
// once per tables dict (kernels/sample_scan.py::fused_operands): ONE
// embedding table tbl_cat (768, 3*NA) = [tbl_sig; tbl_pred; tbl_exc]
// (float32, or bfloat16 for the BF16 instances: the TPU kernel's wdtype),
// whose three rows of a step are read at lsu, 256 + pu and 512 + exc (the
// wrapper points the argument block's three table pointers into it), and
// ONE dual-FC weight dfc_w12 (NB, 512) = [w1 | w2] with its bias (512).
// With 'opt' the two KISS99 draws and eight logit lookups of sample i + 1
// happen during sample i on threads off the step's critical path; nothing
// is drawn for sample 160 (the TPU loop, which cannot branch, draws there
// and rolls the state back, which leaves the same RNG bits). Where each
// plan runs those draws, and why, is in sample_loop.cuh.
//
// It leaves the bits of the walked-tree frame kernel K2 (pcm, excitation,
// RNG, GRU states): the four terms of GRU-A's input are summed in K2's
// order ((cond_a + sig) + pred) + exc (the TPU loop sums the three rows
// inside one product and adds cond_a last, which can differ in the last
// bit), each of the 512 dual-FC columns sums over k = 0..15 in order, and
// the rest of the step is K2's code. What bounds it on an H100 and the two
// launch plans are in sample_loop.cuh.

#include "sample_loop.cuh"

using lpcnet::FUSE;
using lpcnet::OPT;

extern "C" {

// Launches one frame ('fuse', or 'opt' with `pipeline`) on float32 or
// (bf16) bfloat16 tables under `plan` (0: L, 1: T) with `grid` CTAs on
// `stream`; `clusters` is the count lpcnet_prepare_plans gave. Returns the
// cudaError_t of the launch.
int lpcnet_sample_frame_opt(const LpcnetFrameParams* p, int pipeline,
                            int bf16, int plan, int grid, int clusters,
                            void* stream) {
  if (p->batch <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using lpcnet::launch_sample;
  if (bf16)
    return (int)(pipeline
        ? launch_sample<OPT, false, false, true>(p, plan, grid, clusters, s)
        : launch_sample<FUSE, false, false, true>(p, plan, grid, clusters,
                                                  s));
  return (int)(pipeline
      ? launch_sample<OPT, false, false>(p, plan, grid, clusters, s)
      : launch_sample<FUSE, false, false>(p, plan, grid, clusters, s));
}

// Readies the four instances of this library on the current device and
// lowers *count to the least number of plan-L clusters any runs at once.
int lpcnet_prepare_plans(int* count) {
  cudaError_t err = lpcnet::prepare_plans<FUSE, false, false>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<OPT, false, false>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<FUSE, false, false, true>(count);
  if (err == cudaSuccess)
    err = lpcnet::prepare_plans<OPT, false, false, true>(count);
  return (int)err;
}

const char* lpcnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
