// Burg's cepstral analysis of whole 10-ms frames in one launch: the CUDA
// version of ops/burg.burg_cepstral_analysis (reference src/freq.c:156-199
// compute_burg_cepstrum / burg_cepstral_analysis over src/burg.c:98-245
// silk_burg_analysis, one subframe of 79 samples, order 16).
//
// It replaces no TPU kernel: the JAX package's Burg (lpcnet_tpu/ops/burg.py)
// is XLA fusions. It was added for the port's PLC step, where the same
// analysis as PyTorch operations on a handful of floats each took 1710
// kernels a call inside the step's CUDA graph (about 1.96 ms of a 6-ms
// call at one stream on an H100).
//
// What bounds it: the latency of the dependent 16-step order recursion
// (each step's reflection coefficient needs the sums of the step before),
// not bytes (640 in, 144 out a frame) nor operations (a few tens of
// thousands a frame). On an H100 at 1.98 GHz a launch takes ~13 us at one
// frame, ~22 us at 1024; the recursion is ~60% of a warp's cycles, about
// 3x its chain of dependent latencies, as one warp issues the shuffles and
// products of each step's sums one after another.
//
// The design keeps that chain inside a warp. One CTA per frame, one warp per
// half-frame (80 samples). Lane k holds the k-th entries of the recursion's
// vectors (Af, CAf, CAb and the two C rows) in registers; every sum is taken
// in index order, as the C loops take it, by every lane at once from
// values broadcast with __shfl_sync, so each lane holds the step's scalars
// (num, the energies, rc, the gain guard's decision) without a barrier, and
// the element updates read their partners with shuffles too. The
// pre-emphasised samples and the per-bin values sit in the warp's own
// shared memory behind __syncwarp. The twiddles, the band weights and the
// DCT matrix are copied into shared memory asynchronously (cp.async) while
// the recursion runs, and waited for after it, at the first block barrier
// (read from L2 where they are used, they would put its latency into the
// band fold's 160-term sum; staged before the recursion, 2.4 us at one
// frame). The other block barrier is the last, before the two warps'
// cepstra are summed and differenced into 36 floats.
//
// After the recursion: the bandwidth-expanded inverse filter
// [1, Af[i] 0.995^(i+1)], its spectrum as a direct DFT of its 17 nonzero
// taps (the transform rfft(n=320) takes of the zero-padded impulse, for the
// 160 bins the band fold reads), 1 / (|X / 320|^2 + 1e-9) folded into the
// 18 bands, log10(1e-2 + E) under the follower, the DCT and c0 - 4.
//
// float32 throughout, as the plain version; built with --fmad=false, so
// every product is rounded before its sum as there. The tables (the
// 0.995^(i+1) powers, cos and sin of 2 pi m / 320 computed in float64, the
// band weights, the band edge scale and the DCT matrix) come from the host,
// the plain version's own constants on the device.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace lpcnet {

constexpr int kFrame = 160;
constexpr int kHalf = 80;               // samples of a half-frame
constexpr int kLen = kHalf - 1;         // after pre-emphasis
constexpr int kOrder = 16;
constexpr int kBands = 18;
constexpr int kBins = 160;              // the bins the band fold reads
constexpr int kWindow = 320;            // the transform's length
constexpr int kThreads = 64;            // two warps, one per half-frame
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPreemph = 0.85f;
constexpr float kCondFac = 1e-5f;       // FIND_LPC_COND_FAC (burg.c:40)
constexpr float kMinInvGain = 1e-3f;    // freq.c:170
constexpr float kGainDiv = kHalf - 2 * (kOrder - 1);
constexpr float kEnergyScale =
    static_cast<float>(1.0 / (static_cast<double>(kWindow) * kWindow
                              * kWindow));
constexpr float kDctScale = 1.0f / 3.0f;  // float32(sqrt(2 / 18))

struct BurgTables {
  const float* bw;        // (16,) 0.995^(i+1)
  const float* twiddle;   // (2, 320) cos, sin of 2 pi m / 320
  const float* band;      // (160, 18) triangular band weights
  const float* edge;      // (18,) edge doubling
  const float* dct;       // (18, 18) [time][frequency]
};

__device__ __forceinline__ float lane_of(float v, int src) {
  return __shfl_sync(kFull, v, src);
}

// Starts the copy of n floats (a multiple of 4, both 16-byte aligned) from
// global into shared memory, 16 bytes a thread at a time.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
    __pipeline_memcpy_async(dst + i, src + i, 16);
}

__global__ void __launch_bounds__(kThreads)
burg_cepstrum_kernel(const float* __restrict__ pcm, float* __restrict__ out,
                     int* __restrict__ hit, const BurgTables t) {
  __shared__ __align__(16) float s_tw[2 * kWindow];
  __shared__ __align__(16) float s_bandw[kBins * kBands];
  __shared__ __align__(16) float s_dct[kBands * kBands];
  __shared__ float s_x[2][kLen + kOrder + 1];   // zeros past kLen
  __shared__ float s_imp[2][kOrder + 1];
  __shared__ float s_inv[2][kBins];
  __shared__ float s_band[2][kBands];
  __shared__ float s_ceps[2][kBands];
  stage(s_tw, t.twiddle, 2 * kWindow);
  stage(s_bandw, t.band, kBins * kBands);
  stage(s_dct, t.dct, kBands * kBands);
  __pipeline_commit();
  const int half = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* p = pcm + static_cast<size_t>(blockIdx.x) * kFrame
                   + half * kHalf;
  float* x = s_x[half];
  for (int i = lane; i < kLen + kOrder + 1; i += 32)
    x[i] = i < kLen ? p[i + 1] - kPreemph * p[i] : 0.0f;
  __syncwarp();

  // C_first[k] = <x[0:L-k-1], x[k+1:L]> in lane k < 16, C0 in lane 16; the
  // terms past L are products with the zeros, which leave a sum as it is,
  // so every lane runs the same unrolled loop
  const int lag = lane < kOrder ? lane + 1 : 0;
  float corr = 0.0f;
#pragma unroll
  for (int i = 0; i < kLen; ++i) corr += x[i] * x[i + lag];
  const float c0 = lane_of(corr, kOrder);
  float cf = lane < kOrder ? corr : 0.0f, cl = cf;
  float caf = lane == 0 ? (c0 + kCondFac * c0) + 1e-9f : 0.0f, cab = caf;
  float af = 0.0f, inv_gain = 1.0f;
  bool reached = false;

#pragma unroll
  for (int n = 0; n < kOrder; ++n) {
    if (reached) continue;  // frozen once the guard hit (burg.c:199-205)
    // C row downdates (k < n)
    if (lane < n) {
      cf -= x[n] * x[n - lane - 1];
      cl -= x[kLen - n - 1] * x[kLen - n + lane];
    }
    float tmp1 = x[n], tmp2 = x[kLen - n - 1];
    float t1 = lane_of(cf, n), t2 = lane_of(cl, n);
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const float a = lane_of(af, k);
      tmp1 += x[n - k - 1] * a;
      tmp2 += x[kLen - n + k] * a;
      t1 += lane_of(cl, n - k - 1) * a;
      t2 += lane_of(cf, n - k - 1) * a;
    }
    // CAf[k] -= tmp1 x[n-k], CAb[k] -= tmp2 x[L-n+k-1] (k <= n); row n+1
    if (lane <= n) {
      caf -= tmp1 * x[n - lane];
      cab -= tmp2 * x[kLen - n + lane - 1];
    } else if (lane == n + 1) {
      caf = t1;
      cab = t2;
    }
    float num = lane_of(cab, n + 1), nrg_b = lane_of(cab, 0);
    float nrg_f = lane_of(caf, 0);
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const float a = lane_of(af, k);
      num += lane_of(cab, n - k) * a;
      nrg_b += lane_of(cab, k + 1) * a;
      nrg_f += lane_of(caf, k + 1) * a;
    }
    float rc = -2.0f * num / (nrg_f + nrg_b);

    // max-prediction-gain guard (burg.c:179-192)
    const float tmp_g = inv_gain * (1.0f - rc * rc);
    const bool hit_now = tmp_g <= kMinInvGain;
    if (hit_now) {
      rc = sqrtf(fmaxf(1.0f - kMinInvGain / inv_gain, 0.0f));
      if (num > 0.0f) rc = -rc;
      inv_gain = kMinInvGain;
    } else {
      inv_gain = tmp_g;
    }

    // Af[k] += rc Af[n-1-k] (k < n), from the values before; Af[n] = rc
    const float partner = lane_of(af, lane < n ? n - 1 - lane : lane);
    if (lane < n) af += rc * partner;
    else if (lane == n) af = rc;
    reached = hit_now;
    if (reached) continue;
    // CAf[k] += rc CAb[n+1-k], CAb[k] += rc CAf[n+1-k] (k <= n + 1)
    const int mirror = lane <= n + 1 ? n + 1 - lane : lane;
    const float pb = lane_of(cab, mirror), pf = lane_of(caf, mirror);
    if (lane <= n + 1) {
      caf += rc * pb;
      cab += rc * pf;
    }
  }

  // residual energy (burg.c:219-241)
  float nrg;
  if (reached) {
    float e = 0.0f;
#pragma unroll
    for (int i = 0; i < kOrder; ++i) e += x[i] * x[i];
    nrg = (c0 - e) * inv_gain;
  } else {
    float f = lane_of(caf, 0), s = 1.0f;
#pragma unroll
    for (int k = 0; k < kOrder; ++k) {
      const float a = lane_of(af, k);
      f += lane_of(caf, k + 1) * a;
      s += a * a;
    }
    nrg = f - kCondFac * c0 * s;
  }
  const float g = nrg / kGainDiv;
  __pipeline_wait_prior(0);
  __syncthreads();

  // the inverse filter's impulse and its spectrum's inverse power per bin
  float* imp = s_imp[half];
  if (lane < kOrder) imp[lane + 1] = af * t.bw[lane];
  if (lane == 0) imp[0] = 1.0f;
  __syncwarp();
  float* inv = s_inv[half];
#pragma unroll
  for (int j = 0; j < kBins / 32; ++j) {
    const int b = lane + 32 * j;
    float re = 0.0f, im = 0.0f;
    int m = 0;                               // b n mod 320
#pragma unroll
    for (int n = 0; n <= kOrder; ++n) {
      re += imp[n] * s_tw[m];
      im += imp[n] * s_tw[kWindow + m];
      m += b;
      if (m >= kWindow) m -= kWindow;
    }
    re = re / static_cast<float>(kWindow);
    im = im / static_cast<float>(kWindow);
    inv[b] = 1.0f / (re * re + im * im + 1e-9f);
  }
  __syncwarp();

  // band energies, log, follower (lpcnet_enc.c:512-520), DCT
  const int band = lane < kBands ? lane : 0;
  float e = 0.0f;
#pragma unroll
  for (int k = 0; k < kBins; ++k) e += inv[k] * s_bandw[k * kBands + band];
  e = e * t.edge[band];
  e = e * (0.45f * g * kEnergyScale);
  float* ly = s_band[half];
  if (lane < kBands) ly[lane] = log10f(1e-2f + e);
  __syncwarp();
  float log_max = -2.0f, follow = -2.0f, mine = 0.0f;
  for (int i = 0; i < kBands; ++i) {
    const float v = fmaxf(log_max - 8.0f, fmaxf(follow - 2.5f, ly[i]));
    log_max = fmaxf(log_max, v);
    follow = fmaxf(follow - 2.5f, v);
    if (i == lane) mine = v;
  }
  __syncwarp();
  if (lane < kBands) ly[lane] = mine;
  __syncwarp();
  float c = 0.0f;
#pragma unroll
  for (int i = 0; i < kBands; ++i) c += ly[i] * s_dct[i * kBands + band];
  c = c * kDctScale;
  if (lane == 0) c = c - 4.0f;
  if (lane < kBands) s_ceps[half][lane] = c;
  if (hit != nullptr && lane == 0) hit[2 * blockIdx.x + half] = reached;
  __syncthreads();

  // [.5 (c0 + c1) | c0 - c1]
  const int j = threadIdx.x;
  float* o = out + static_cast<size_t>(blockIdx.x) * 2 * kBands;
  if (j < kBands) o[j] = 0.5f * (s_ceps[0][j] + s_ceps[1][j]);
  else if (j < 2 * kBands)
    o[j] = s_ceps[0][j - kBands] - s_ceps[1][j - kBands];
}

}  // namespace lpcnet

extern "C" {

// Launches the analysis of `frames` frames of 160 samples (pcm, row-major)
// into out (frames, 36) on `stream`; hit, if not null, gets (frames, 2):
// 1 where the gain guard hit in that half-frame. Returns the cudaError_t
// of the launch.
int lpcnet_burg_cepstrum(const float* pcm, float* out, int* hit,
                         const float* bw, const float* twiddle,
                         const float* band, const float* edge,
                         const float* dct, int frames, void* stream) {
  if (frames <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const lpcnet::BurgTables t{bw, twiddle, band, edge, dct};
  lpcnet::burg_cepstrum_kernel<<<frames, lpcnet::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      pcm, out, hit, t);
  return static_cast<int>(cudaGetLastError());
}

const char* lpcnet_burg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
