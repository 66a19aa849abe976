// The pieces of the LPCNet vocoder's autoregressive sample loop (reference
// lpcnet.c:235-271, nnet.c:163-214) that the port's kernels share: the
// argument block, the widths, the bit-exact mu-law, KISS99 and GRU-B's
// phases as device functions. Their one user is the sample loop of
// sample_loop.cuh, whose instances are every kernel of the port:
//   sample_frame.cu     K1, K2 (one free-run frame)
//   synth_samples.cu    K3 (teacher forcing and freeze)
//   sample_frame_opt.cu K5 (the fused frame kernel, 'fuse' and 'opt')
//   teacher_advance.cu  K4 (a fully forced segment without the tail)
// They replace the TPU kernels of lpcnet_tpu/kernels/sample_pallas.py.
// What bounds the loop on an H100 and what each launch plan does about it
// is in sample_loop.cuh.
// Numerics: IEEE expf/tanhf, sigmoid = 1/(1+expf(-x)), no fast math, built
// with --fmad=false; every sum has a fixed order that the plain version
// (kernels/sample_scan.py) repeats; the mu-law bit trick and the
// de-emphasis/clip/floor(.5+x) chain follow sample_pallas.py:130-148 and
// :294-315 one rounded operation at a time.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The argument block of the sample loop; its ctypes twin is
// kernels/sample_cuda.py::_Params.
struct LpcnetFrameParams {
  const float* cond_a;      // (B, *) rows of stride ca_stride, 3*NA used
  const float* cond_b;      // (B, *) rows of stride cb_stride, 3*NB used
  const float* lpc;         // (B, *) rows of stride lpc_stride, ORDER used
  long long ca_stride, cb_stride, lpc_stride;
  const void* tbl_sig;      // (NL, 3*NA) embedding tables folded
  const void* tbl_pred;     //   through GRU-A's input kernel (K5: rows
  const void* tbl_exc;      //   0, NL, 2*NL of tbl_cat (3*NL, 3*NA)),
                            //   float32, or bfloat16 for the BF16
                            //   instances of K1, K2 and K5
  const float* wr_a;        // (NA, 3*NA)
  const float* br_a;        // (3*NA)
  const float* wi_b;        // (NA, 3*NB)
  const float* wr_b;        // (NB, 3*NB)
  const float* br_b;        // (3*NB)
  const float* dfc_w;       // (2, NB, NL); K5: dfc_w12 (NB, 2*NL) =
                            //   [w1 | w2]; K4: unused
  const float* dfc_b;       // (2, NL); K5: dfc_b12, the same layout
  const float* dfc_f;       // (2, NL)
  const float* logit_tbl;   // (2, NL): SAMPLING_LOGIT_TABLE, ULAW2LIN_TABLE
  const float* gru_a_in;    // (B, NA)
  const float* gru_b_in;    // (B, NB)
  const float* sig_in;      // (B, ORDER)
  const int* exc_in;        // (B)
  const float* deemph_in;   // (B)
  const long long* rng_in;  // (B, 4) uint32 values
  float* gru_a_out;         // outputs may alias the inputs: each CTA reads
  float* gru_b_out;         // its streams' state before it writes any
  float* sig_out;
  int* exc_out;
  float* deemph_out;
  long long* rng_out;
  float* pcm;               // (B, *) rows of stride pcm_stride; K4: unused
  long long pcm_stride;
  // teacher forcing (synth_samples.cu; teacher_advance.cu forces every
  // step from target) and freeze (synth_samples.cu)
  const float* target;      // (B, *) rows of stride tgt_stride, or null
  long long tgt_stride;
  const int* preload;       // (B): steps i < preload follow the target
  const int* force_from;    // (B): steps i >= force_from follow it too;
                            //   both are set whenever target is
  const int* n_active;      // (B): steps i >= n_active freeze, or null
  int batch;
  int nsamples;             // steps per launch (K1, K2, K5: FS)
  float preemph;
  const float* wr_a_l;      // (16, 3*NA/16, NA): wr_a repacked for plan L,
                            //   [cta][gate*24 + unit][k]
  unsigned long long* prof; // (11) clock stamps of the phase instance
};

namespace lpcnet {

constexpr int NA = 384;          // GRU-A units
constexpr int NB = 16;           // GRU-B units
constexpr int G3A = 3 * NA;      // GRU-A gate width
constexpr int G3B = 3 * NB;      // GRU-B gate width
constexpr int NL = 256;          // mu-law levels = dual-FC outputs
constexpr int ORDER = 16;        // LPC order
constexpr int FS = 160;          // samples per frame
constexpr int TILE = 8;          // streams per CTA
constexpr int THREADS = NA;      // one thread per GRU-A unit
constexpr int KPART = THREADS / G3B;   // slices of the wi_b product
constexpr int KSLICE = NA / KPART;     // rows of wi_b per slice
constexpr unsigned ALL_ACTIVE = (1u << TILE) - 1u;
static_assert(TILE == 8, "GRU-A state reads are two float4 per k");
static_assert(TILE * G3B == THREADS, "one thread per (stream, GRU-B gate)");
static_assert(KPART * KSLICE == NA, "wi_b slices cover GRU-A");

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Bit-exact mu-law (reference common.h:47-58; sample_pallas.py:130-148).
__device__ __forceinline__ int lin2ulaw(float x) {
  float ax = fabsf(x);
  float arg = 1.0f + (255.0f / 32768.0f) * ax;
  int xi = __float_as_int(arg);
  int integer = (xi >> 23) - 127;
  xi -= integer << 23;
  float frac = __int_as_float(xi) - 1.5f;
  float poly = -0.41445418f
      + frac * (0.95909232f + frac * (-0.33951290f + frac * 0.16541097f));
  float l2 = (float)(1 + integer) + poly;
  float s = x >= 0.0f ? 1.0f : -1.0f;
  float u = 128.0f + s * (128.0f * (0.69315f * l2) / 5.5451774445f);
  u = fminf(fmaxf(u, 0.0f), 255.0f);
  return (int)floorf(0.5f + u);
}

// KISS99 step (reference kiss99.c:59-81) on a uint32 state.
__device__ __forceinline__ uint32_t kiss99(uint32_t st[4]) {
  uint32_t znew = 36969u * (st[0] & 0xFFFFu) + (st[0] >> 16);
  uint32_t wnew = 18000u * (st[1] & 0xFFFFu) + (st[1] >> 16);
  uint32_t mwc = (znew << 16) + wnew;
  uint32_t shr3 = st[2] ^ (st[2] << 13);
  shr3 ^= shr3 >> 17;
  shr3 ^= shr3 << 5;
  uint32_t cong = 69069u * st[3] + 1234567u;
  st[0] = znew;
  st[1] = wnew;
  st[2] = shr3;
  st[3] = cong;
  return (mwc ^ cong) + shr3;
}

// GRU-B input product gru_a @ wi_b, one KSLICE-row slice per thread group;
// s_part is [slice][stream][gate].
__device__ __forceinline__ void gru_b_input_partial(
    const float* s_wi_b, const float* s_ha, float* s_part, int tid) {
  const int o = tid % G3B, part = tid / G3B;
  float acc[TILE];
  {
    const int k = part * KSLICE;
    const float w = s_wi_b[k * G3B + o];
#pragma unroll
    for (int s = 0; s < TILE; ++s) acc[s] = s_ha[k * TILE + s] * w;
  }
  for (int kk = 1; kk < KSLICE; ++kk) {
    const int k = part * KSLICE + kk;
    const float w = s_wi_b[k * G3B + o];
    const float4 ha = *reinterpret_cast<const float4*>(s_ha + k * TILE);
    const float4 hb = *reinterpret_cast<const float4*>(s_ha + k * TILE + 4);
    const float h[TILE] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
    for (int s = 0; s < TILE; ++s) acc[s] += h[s] * w;
  }
#pragma unroll
  for (int s = 0; s < TILE; ++s)
    s_part[(part * TILE + s) * G3B + o] = acc[s];
}

// GRU-B preactivations, thread = (stream, gate): the slices added in
// order plus the frame condition, and the recurrent product.
__device__ __forceinline__ void gru_b_preact(
    const float* s_part, const float* s_cb, const float* s_hb,
    const float* s_wr_b, const float* s_br_b, float* s_zrh_b,
    float* s_rec_b, int tid) {
  const int s = tid / G3B, o = tid % G3B;
  float dot = s_part[s * G3B + o];
#pragma unroll
  for (int part = 1; part < KPART; ++part)
    dot += s_part[(part * TILE + s) * G3B + o];
  s_zrh_b[tid] = s_cb[tid] + dot;
  float rec = s_hb[s * NB] * s_wr_b[o];
#pragma unroll
  for (int k = 1; k < NB; ++k) rec += s_hb[s * NB + k] * s_wr_b[k * G3B + o];
  s_rec_b[tid] = rec + s_br_b[o];
}

// GRU-B gates, thread = (stream, unit); s_hb is [stream][unit].
__device__ __forceinline__ void gru_b_update(
    const float* s_zrh_b, const float* s_rec_b, float* s_hb, int tid,
    unsigned active) {
  if (tid < TILE * NB) {
    const int s = tid / NB, u = tid % NB;
    const float* zrh = s_zrh_b + s * G3B;
    const float* rec = s_rec_b + s * G3B;
    const float z = sigmoidf(zrh[u] + rec[u]);
    const float r = sigmoidf(zrh[NB + u] + rec[NB + u]);
    const float hc = tanhf(zrh[2 * NB + u] + r * rec[2 * NB + u]);
    const float hn = z * s_hb[tid] + (1.0f - z) * hc;
    if ((active >> s) & 1u) s_hb[tid] = hn;
  }
}

}  // namespace lpcnet
