// LPC from the inverse transform of the band spectrum in one launch: the
// last part of ops/dsp.lpc_from_cepstrum on the card (reference
// src/freq.c:275-297 lpc_from_bands over freq.c:86-127 lpcn_lpc, order 16):
// the 17 lags 320 irfft(X)[n], n <= 16, the -40 dB noise floor, the lag
// window and Levinson-Durbin, with both guards of dsp.levinson (a row with
// ac[0] == 0 never updates; a row stops after the step whose error falls
// below 0.001 ac[0]).
//
// It replaces no TPU kernel: the JAX package's version (lpcnet_tpu/ops/
// dsp.py) is XLA fusions. It was added for the port's one-stream paths,
// where lpc_from_cepstrum as PyTorch operations took ~427 kernels a call
// inside the entry points' CUDA graphs, ~413 of them the 16-step Levinson
// loop (~0.5 ms of a 2.5-ms frame at one stream on an H100, twice in a PLC
// step). The IDCT, 10^x, the band spread and the inverse FFT before it stay
// PyTorch operations (~12 kernels): the sample loop quantizes the LPC
// prediction, so a row whose LPC differs from the plain version's in the
// last bit can take another sample, and only cuBLAS and cuFFT give their
// own bits. This kernel gives the plain version's bits: it repeats its
// float32 operations one by one, every product and sum rounded alone, as
// PyTorch's elementwise kernels round them (built with --fmad=false), and
// each step's sum over j < i of lpc[j] ac[i-j] in the order of PyTorch's
// CUDA reduction over a last axis of i < 32 floats (ATen's Reduce.cuh):
// with w the largest power of two <= i, lane x < w adds elements x and
// x + w, then the lanes fold in a tree of shuffles at offsets w/2 .. 1.
//
// What bounds it: the latency of the dependent 16-step recursion (each
// step's reflection coefficient needs the sums of the step before), not
// bytes (68 in, 68 out a row) nor operations (~700 a row). One warp a row,
// kRows rows to a CTA, the grid sized from the row count: lane k holds
// lpc[k], each step's sum is the reduction's shuffle tree, the update reads
// its partner lpc[i-1-k] with one shuffle, and the lags sit in the warp's
// shared memory.

#include <cuda_runtime.h>

namespace lpcnet {

constexpr int kOrder = 16;
constexpr int kLags = kOrder + 1;
constexpr int kRows = 8;                // rows (warps) a CTA
constexpr int kThreads = 32 * kRows;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kWindow = 320.0f;       // inverse_transform's scale
// the -40 dB floor: the reference's 320/12/38. with C's integer division
constexpr float kNoiseFloor = 26.0f / 38.0f;

__global__ void __launch_bounds__(kThreads)
lpc_levinson_kernel(const float* __restrict__ y, int row_stride,
                    const float* __restrict__ lag, float* __restrict__ lpc_out,
                    float* __restrict__ err_out, int* __restrict__ steps_out,
                    int rows) {
  __shared__ float s_ac[kRows][kLags];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + warp;
  if (row >= rows) return;
  float* ac = s_ac[warp];

  // the lags, the noise floor and the lag window (lpc_from_bands)
  if (lane < kLags) {
    const float v = kWindow * y[static_cast<size_t>(row) * row_stride + lane];
    ac[lane] = lane == 0 ? v + v * 1e-4f + kNoiseFloor : v * lag[lane - 1];
  }
  __syncwarp();

  // Levinson-Durbin (dsp.levinson), lpc[k] in lane k
  const float ac0 = ac[0];
  const float floor = 0.001f * ac0;
  float a = 0.0f, error = ac0;
  bool done = error == 0.0f;
  int steps = 0;
#pragma unroll
  for (int i = 0; i < kOrder; ++i) {
    if (done) break;
    float rr;
    if (i == 0) {
      rr = ac[1];
    } else {
      // sum_{j<i} lpc[j] ac[i-j] in the reduction's order, then ac[i+1]
      const int w = 1 << (31 - __clz(i));
      const float e = lane < i ? 0.0f + a * ac[i - lane] : 0.0f;
      const float far = __shfl_down_sync(kFull, e, w);
      float t = lane + w < i ? e + far : e;
#pragma unroll
      for (int off = kOrder / 4; off > 0; off >>= 1) {   // w <= 8
        const float other = __shfl_down_sync(kFull, t, off);
        if (off < w) t = t + other;
      }
      rr = __shfl_sync(kFull, t, 0) + ac[i + 1];
    }
    const float r = -rr / (error == 0.0f ? 1.0f : error);
    const float partner = __shfl_sync(kFull, a, lane < i ? i - 1 - lane
                                                         : lane);
    if (lane < i) a = a + r * partner;
    else if (lane == i) a = r;
    error = error - r * r * error;
    steps = i + 1;
    done = error < floor;
  }
  if (lane < kOrder) lpc_out[static_cast<size_t>(row) * kOrder + lane] = a;
  if (lane == 0) {
    err_out[row] = error;
    if (steps_out != nullptr) steps_out[row] = steps;
  }
}

}  // namespace lpcnet

extern "C" {

// Launches LPC of `rows` rows of the inverse transform irfft(X) (y, row r
// at y + r * row_stride floats, its first 17 read) into lpc (rows, 16) and
// err (rows,) on `stream`, with the lag window `lag` (16,); steps, if not
// null, gets (rows,): the Levinson steps each row ran (16 unless it
// stopped early). Returns the cudaError_t of the launch.
int lpcnet_lpc_levinson(const float* y, int row_stride, const float* lag,
                        float* lpc, float* err, int* steps, int rows,
                        void* stream) {
  if (rows <= 0 || row_stride < lpcnet::kLags)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (rows + lpcnet::kRows - 1) / lpcnet::kRows;
  lpcnet::lpc_levinson_kernel<<<grid, lpcnet::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      y, row_stride, lag, lpc, err, steps, rows);
  return static_cast<int>(cudaGetLastError());
}

const char* lpcnet_lpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
