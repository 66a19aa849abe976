// The autoregressive sample loop of the LPCNet vocoder for a batch of
// streams, every state resident on chip for the whole call (reference
// lpcnet.c:235-271, nnet.c:163-214), shared by the port's three kernels:
//   sample_frame.cu     one free-run 160-sample frame      (K1, K2)
//   synth_samples.cu    nsamples steps with optional teacher forcing and
//                       per-stream active counts           (K3)
//   teacher_advance.cu  the two GRU recurrences alone over a fully forced
//                       segment                            (K4)
// They replace the TPU kernels of lpcnet_tpu/kernels/sample_pallas.py
// (_frame_kernel_flat, _frame_kernel, _tf_frame_kernel_flat,
// _tf_frame_kernel, _teacher_kernel). The sample loop is one kernel
// template, sample_kernel<FLAT, TF>: FLAT picks the sampler (flat sampling
// tree or the walked one; same bits), TF adds the forcing and freeze
// machinery, whose inputs are run-time fields that are uniform over the
// grid (a null target or n_active switches that part off for the launch).
// The GRU phases are device functions that teacher_advance.cu calls too, so
// a fully forced K3 launch and a K4 launch sum in the same order and leave
// the same GRU bits.
//
// What bounds it on an H100:
//   * The steps of a call are one serialized chain per stream
//     (pred -> mu-law -> GRU-A -> GRU-B -> dual-FC -> sample -> pcm), so a
//     CTA walks them in order with ~8 block barriers per step.
//   * Each step, each CTA reads all of GRU-A's recurrent matrix wr_a
//     (384 x 1152 f32 = 1.77 MB). It does not fit in shared memory, so it
//     is re-read from L2 every step: 1.77 MB x steps x (B / 8) CTAs.
//   * The arithmetic is ~0.47 M multiply-adds per stream and sample (GRU-A
//     recurrent 384x1152, wi_b 384x48, GRU-B 16x48, dual-FC 2x16x256), in
//     float32 without FMA contraction (built with --fmad=false).
// What the design does about it:
//   * A CTA holds a tile of TILE = 8 streams, so each wr_a element read
//     from L2 feeds 8 streams (8x fewer L2 bytes than one stream per CTA);
//     B = 1024 gives 128 CTAs for the 132 SMs.
//   * One thread per GRU-A unit j (384 threads) reads the three coalesced
//     columns wr_a[k, j + {0, 384, 768}] in a fixed sequential k order and
//     keeps 3 x TILE sums in registers: no cross-thread reduction. Every
//     sum of the kernels has a fixed order that the plain version
//     (kernels/sample_scan.py) repeats, so on the card the two agree bit
//     for bit wherever expf/tanhf do.
//   * The GRU-A states of the tile sit in shared memory as [k][stream], one
//     broadcast read per k; every smaller weight (wi_b, wr_b, dual-FC, the
//     logit and ULAW2LIN tables) is staged into shared memory once per
//     launch.
//   * The one-hot embedding products of the TPU kernel are plain row reads
//     of tbl_*[idx] (a one-hot row with f32 accumulation is a row gather),
//     summed in the TPU kernel's order cond_a + sig + pred + exc.
//   * Per-stream scalar work (prediction, mu-law, KISS99 in uint32,
//     thresholds, ULAW2LIN, teacher forcing, de-emphasis) runs on one
//     thread per stream.
//   * Flat sampler: every heap node of every stream is compared by its own
//     thread, and the leaf whose 8 path bits all agree is the sample. Walk
//     sampler: 8 dependent lookups on the stream's thread.
//   * Freeze (n_active): a stream past its count keeps every state. Its
//     GRU-A state lives in every thread's registers (h_own), so each thread
//     selects per stream from a bit mask of the tile's active streams.
// Numerics: IEEE expf/tanhf, sigmoid = 1/(1+expf(-x)), no fast math; the
// mu-law bit trick and the de-emphasis/clip/floor(.5+x) chain follow
// sample_pallas.py:130-148 and :294-315 one rounded operation at a time.
// Making it fast (tensor cores for the GRU-A product, weights kept on chip
// across steps, several frames per launch, CUDA graphs) is later work.
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
  const float* tbl_sig;     // (NL, 3*NA) embedding tables folded
  const float* tbl_pred;    //   through GRU-A's input kernel
  const float* tbl_exc;
  const float* wr_a;        // (NA, 3*NA)
  const float* br_a;        // (3*NA)
  const float* wi_b;        // (NA, 3*NB)
  const float* wr_b;        // (NB, 3*NB)
  const float* br_b;        // (3*NB)
  const float* dfc_w;       // (2, NB, NL)
  const float* dfc_b;       // (2, NL)
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
  float* pcm;               // (B, *) rows of stride pcm_stride
  long long pcm_stride;
  // teacher forcing and freeze (synth_samples.cu only)
  const float* target;      // (B, *) rows of stride tgt_stride, or null
  long long tgt_stride;
  const int* preload;       // (B): steps i < preload follow the target
  const int* force_from;    // (B): steps i >= force_from follow it too;
                            //   both are set whenever target is
  const int* n_active;      // (B): steps i >= n_active freeze, or null
  int batch;
  int nsamples;             // steps per launch (sample_frame.cu: FS)
  float preemph;
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

// Shared memory of the sample loop, in floats (every size is a multiple of
// 4: float4-aligned)
constexpr int OFF_WI_B = 0;
constexpr int OFF_WR_B = OFF_WI_B + NA * G3B;
constexpr int OFF_BR_B = OFF_WR_B + NB * G3B;
constexpr int OFF_DFC_W = OFF_BR_B + G3B;
constexpr int OFF_DFC_B = OFF_DFC_W + 2 * NB * NL;
constexpr int OFF_DFC_F = OFF_DFC_B + 2 * NL;
constexpr int OFF_LOGIT = OFF_DFC_F + 2 * NL;
constexpr int OFF_U2L = OFF_LOGIT + NL;
constexpr int OFF_HA = OFF_U2L + NL;
constexpr int OFF_PART = OFF_HA + NA * TILE;
constexpr int OFF_CB = OFF_PART + KPART * TILE * G3B;
constexpr int OFF_ZRH_B = OFF_CB + TILE * G3B;
constexpr int OFF_REC_B = OFF_ZRH_B + TILE * G3B;
constexpr int OFF_HB = OFF_REC_B + TILE * G3B;
constexpr int OFF_LOGITS = OFF_HB + TILE * NB;
constexpr int OFF_THR = OFF_LOGITS + TILE * NL;
constexpr int OFF_SIG = OFF_THR + TILE * 8;
constexpr int OFF_LPC = OFF_SIG + TILE * ORDER;
constexpr int OFF_IDX = OFF_LPC + TILE * ORDER;      // int: lsu, pu, exc
constexpr int OFF_EXC = OFF_IDX + TILE * 4;          // int: sampled exc
constexpr int OFF_NACT = OFF_EXC + TILE;             // int: active counts
constexpr int OFF_CMP = OFF_NACT + TILE;             // bytes: node compares
constexpr size_t SMEM_BYTES = OFF_CMP * sizeof(float) + TILE * NL;

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

// GRU-A: thread j computes unit j's three gates for every stream of the
// tile and updates its register copy h_own. s_ha is [k][stream], s_idx is
// [stream][lsu, pu, exc, -]; ca holds cond_a[stream][gate][j]. Streams whose
// bit in `active` is clear keep their state.
__device__ __forceinline__ void gru_a_update(
    const float* __restrict__ wr_a, const float* __restrict__ tbl_sig,
    const float* __restrict__ tbl_pred, const float* __restrict__ tbl_exc,
    const float* s_ha, const int* s_idx, const float (&ca)[TILE][3],
    float bra0, float bra1, float bra2, int j, unsigned active,
    float (&h_own)[TILE]) {
  // sums start from the k = 0 product, as the plain version's do
  float acc[TILE][3];
  const float* w = wr_a + j;
  {
    const float w0 = __ldg(w), w1 = __ldg(w + NA), w2 = __ldg(w + 2 * NA);
#pragma unroll
    for (int s = 0; s < TILE; ++s) {
      acc[s][0] = s_ha[s] * w0;
      acc[s][1] = s_ha[s] * w1;
      acc[s][2] = s_ha[s] * w2;
    }
  }
#pragma unroll 4
  for (int k = 1; k < NA; ++k) {
    const float w0 = __ldg(w + k * G3A);
    const float w1 = __ldg(w + k * G3A + NA);
    const float w2 = __ldg(w + k * G3A + 2 * NA);
    const float4 ha = *reinterpret_cast<const float4*>(s_ha + k * TILE);
    const float4 hb = *reinterpret_cast<const float4*>(s_ha + k * TILE + 4);
    const float h[TILE] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
    for (int s = 0; s < TILE; ++s) {
      acc[s][0] += h[s] * w0;
      acc[s][1] += h[s] * w1;
      acc[s][2] += h[s] * w2;
    }
  }
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    const int* idx = s_idx + s * 4;
    const float* ts = tbl_sig + idx[0] * G3A + j;
    const float* tp = tbl_pred + idx[1] * G3A + j;
    const float* te = tbl_exc + idx[2] * G3A + j;
    float zrh[3];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      zrh[g] = ((ca[s][g] + __ldg(ts + g * NA)) + __ldg(tp + g * NA))
               + __ldg(te + g * NA);
    const float z = sigmoidf(zrh[0] + (acc[s][0] + bra0));
    const float r = sigmoidf(zrh[1] + (acc[s][1] + bra1));
    const float hc = tanhf(zrh[2] + r * (acc[s][2] + bra2));
    const float hn = z * h_own[s] + (1.0f - z) * hc;
    h_own[s] = (active >> s) & 1u ? hn : h_own[s];
  }
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

template <bool FLAT, bool TF>
__global__ void __launch_bounds__(THREADS, 1)
sample_kernel(const LpcnetFrameParams p) {
  extern __shared__ __align__(16) float smem[];
  float* s_wi_b = smem + OFF_WI_B;
  float* s_wr_b = smem + OFF_WR_B;
  float* s_br_b = smem + OFF_BR_B;
  float* s_dfc_w = smem + OFF_DFC_W;
  float* s_dfc_b = smem + OFF_DFC_B;
  float* s_dfc_f = smem + OFF_DFC_F;
  float* s_logit = smem + OFF_LOGIT;
  float* s_u2l = smem + OFF_U2L;
  float* s_ha = smem + OFF_HA;          // [k][stream]
  float* s_part = smem + OFF_PART;      // [slice][stream][gate]
  float* s_cb = smem + OFF_CB;          // [stream][gate]
  float* s_zrh_b = smem + OFF_ZRH_B;
  float* s_rec_b = smem + OFF_REC_B;
  float* s_hb = smem + OFF_HB;          // [stream][unit]
  float* s_logits = smem + OFF_LOGITS;  // [stream][class]
  float* s_thr = smem + OFF_THR;        // [stream][level]
  float* s_sig = smem + OFF_SIG;        // [stream][lag]
  float* s_lpc = smem + OFF_LPC;        // [stream][coef]
  int* s_idx = reinterpret_cast<int*>(smem + OFF_IDX);
  int* s_exc = reinterpret_cast<int*>(smem + OFF_EXC);
  int* s_nact = reinterpret_cast<int*>(smem + OFF_NACT);
  unsigned char* s_cmp = reinterpret_cast<unsigned char*>(smem + OFF_CMP);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TILE;
  const int nvalid = min(TILE, p.batch - b0);
  const int ns = TF ? p.nsamples : FS;
  const bool forcing = TF && p.target != nullptr;
  const bool freezing = TF && p.n_active != nullptr;

  // ---- stage the small weights and this call's per-stream inputs
  for (int i = tid; i < NA * G3B; i += THREADS) s_wi_b[i] = p.wi_b[i];
  for (int i = tid; i < NB * G3B; i += THREADS) s_wr_b[i] = p.wr_b[i];
  for (int i = tid; i < G3B; i += THREADS) s_br_b[i] = p.br_b[i];
  for (int i = tid; i < 2 * NB * NL; i += THREADS) s_dfc_w[i] = p.dfc_w[i];
  for (int i = tid; i < 2 * NL; i += THREADS) {
    s_dfc_b[i] = p.dfc_b[i];
    s_dfc_f[i] = p.dfc_f[i];
    s_logit[i] = p.logit_tbl[i];      // s_logit and s_u2l are contiguous
  }
  for (int i = tid; i < TILE * G3B; i += THREADS) {
    const int s = i / G3B, o = i % G3B;
    s_cb[i] = s < nvalid ? p.cond_b[(b0 + s) * p.cb_stride + o] : 0.0f;
  }
  for (int i = tid; i < TILE * NB; i += THREADS) {
    const int s = i / NB, u = i % NB;
    s_hb[i] = s < nvalid ? p.gru_b_in[(b0 + s) * NB + u] : 0.0f;
  }
  for (int i = tid; i < TILE * ORDER; i += THREADS) {
    const int s = i / ORDER, k = i % ORDER;
    const bool ok = s < nvalid;
    s_sig[i] = ok ? p.sig_in[(b0 + s) * ORDER + k] : 0.0f;
    s_lpc[i] = ok ? p.lpc[(b0 + s) * p.lpc_stride + k] : 0.0f;
  }
  if (freezing && tid < TILE)
    s_nact[tid] = tid < nvalid ? p.n_active[b0 + tid] : 0;

  // GRU-A unit j = tid: its state and call condition stay in registers
  const int j = tid;
  float h_own[TILE], ca[TILE][3];
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    const bool ok = s < nvalid;
    h_own[s] = ok ? p.gru_a_in[(b0 + s) * NA + j] : 0.0f;
    s_ha[j * TILE + s] = h_own[s];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      ca[s][g] = ok ? p.cond_a[(b0 + s) * p.ca_stride + g * NA + j] : 0.0f;
  }
  const float bra0 = p.br_a[j], bra1 = p.br_a[NA + j],
              bra2 = p.br_a[2 * NA + j];

  // stream threads (lanes 0..TILE-1 of warp 0): scalar state in registers
  const bool stream_thread = tid < TILE;
  const bool writer = tid < nvalid;
  uint32_t rng[4] = {0u, 0u, 0u, 0u};
  float deemph = 0.0f, pred = 0.0f;
  int exc = 0, preload = 0, force_from = 0;
  if (writer) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rng[q] = (uint32_t)p.rng_in[(b0 + tid) * 4 + q];
    deemph = p.deemph_in[b0 + tid];
    exc = p.exc_in[b0 + tid];
    if (forcing) {
      preload = p.preload[b0 + tid];
      force_from = p.force_from[b0 + tid];
    }
  }
  __syncthreads();

  for (int i = 0; i < ns; ++i) {
    // the tile's streams that advance on this step, one bit each
    unsigned active = ALL_ACTIVE;
    if (freezing) {
      active = 0u;
#pragma unroll
      for (int s = 0; s < TILE; ++s) active |= (i < s_nact[s] ? 1u : 0u) << s;
    }
    const bool advance = (active >> (tid & (TILE - 1))) & 1u;

    // A. prediction, mu-law inputs, thresholds (stream threads)
    if (stream_thread) {
      const float* sig = s_sig + tid * ORDER;
      const float* lpc = s_lpc + tid * ORDER;
      float acc = sig[0] * lpc[0];
#pragma unroll
      for (int k = 1; k < ORDER; ++k) acc = acc + sig[k] * lpc[k];
      pred = -acc;
      s_idx[tid * 4 + 0] = lin2ulaw(sig[0]);
      s_idx[tid * 4 + 1] = lin2ulaw(pred);
      s_idx[tid * 4 + 2] = exc;
      uint32_t next[4] = {rng[0], rng[1], rng[2], rng[3]};
      const uint32_t r1 = kiss99(next);
      const uint32_t r2 = kiss99(next);
      if (advance) {
#pragma unroll
        for (int q = 0; q < 4; ++q) rng[q] = next[q];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_thr[tid * 8 + k] = s_logit[(r1 >> (8 * k)) & 0xFFu];
        s_thr[tid * 8 + 4 + k] = s_logit[(r2 >> (8 * k)) & 0xFFu];
      }
    }
    __syncthreads();

    // B. GRU-A
    gru_a_update(p.wr_a, p.tbl_sig, p.tbl_pred, p.tbl_exc, s_ha, s_idx, ca,
                 bra0, bra1, bra2, j, active, h_own);
    __syncthreads();   // every thread is done reading the old s_ha
#pragma unroll
    for (int s = 0; s < TILE; ++s) s_ha[j * TILE + s] = h_own[s];
    __syncthreads();

    // C-E. GRU-B
    gru_b_input_partial(s_wi_b, s_ha, s_part, tid);
    __syncthreads();
    gru_b_preact(s_part, s_cb, s_hb, s_wr_b, s_br_b, s_zrh_b, s_rec_b, tid);
    __syncthreads();
    gru_b_update(s_zrh_b, s_rec_b, s_hb, tid, active);
    __syncthreads();

    // F. dual-FC logits, thread = (stream, class)
    for (int q = tid; q < TILE * NL; q += THREADS) {
      const int s = q / NL, c = q % NL;
      const float* h = s_hb + s * NB;
      float y1 = h[0] * s_dfc_w[c], y2 = h[0] * s_dfc_w[NB * NL + c];
#pragma unroll
      for (int k = 1; k < NB; ++k) {
        y1 += h[k] * s_dfc_w[k * NL + c];
        y2 += h[k] * s_dfc_w[(NB + k) * NL + c];
      }
      y1 = tanhf(y1 + s_dfc_b[c]);
      y2 = tanhf(y2 + s_dfc_b[NL + c]);
      s_logits[q] = y1 * s_dfc_f[c] + y2 * s_dfc_f[NL + c];
    }
    __syncthreads();

    // G. flat sampler: compare every heap node, keep the agreeing leaf
    if (FLAT) {
      for (int q = tid; q < TILE * NL; q += THREADS) {
        const int s = q / NL, n = q % NL;
        const int level = 31 - __clz(n | 1);   // node 0 is unused
        s_cmp[q] = s_thr[s * 8 + level] < s_logits[q];
      }
      __syncthreads();
      for (int q = tid; q < TILE * NL; q += THREADS) {
        const int s = q / NL, c = q % NL;
        bool agree = true;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int node = (1 << b) + (c >> (8 - b));
          agree &= s_cmp[s * NL + node] == ((c >> (7 - b)) & 1);
        }
        if (agree) s_exc[s] = c;
      }
      __syncthreads();
    }

    // H. excitation -> signal, de-emphasis, clip, round (stream threads)
    if (stream_thread) {
      int e;
      if (FLAT) {
        e = s_exc[tid];
      } else {
        const float* lg = s_logits + tid * NL;
        int val = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b)
          val = (val << 1) | (s_thr[tid * 8 + b] < lg[val | (1 << b)]);
        e = val;
      }
      // a forced step takes signal and excitation from the target
      // (lpcnet.c:256-261) and emits the target itself
      bool forced = false;
      float tgt = 0.0f, tf_sig = 0.0f;
      if (forcing) {
        tgt = writer ? p.target[(b0 + tid) * p.tgt_stride + i] : 0.0f;
        tf_sig = tgt - p.preemph * deemph;
        forced = i < preload || i >= force_from;
        if (forced) e = lin2ulaw(tf_sig - pred);
      }
      const float pcm = forced ? tf_sig : pred + s_u2l[e];
      float out = pcm + p.preemph * deemph;
      if (advance) {
        float* sig = s_sig + tid * ORDER;
#pragma unroll
        for (int k = ORDER - 1; k > 0; --k) sig[k] = sig[k - 1];
        sig[0] = pcm;
        deemph = out;
        exc = e;
      }
      out = fminf(fmaxf(out, -32767.0f), 32767.0f);
      out = floorf(0.5f + out);
      if (forced) out = tgt;
      if (!advance) out = 0.0f;
      if (writer) p.pcm[(b0 + tid) * p.pcm_stride + i] = out;
    }
    // The next step's phase A runs on the same stream threads and reads
    // only what they wrote; every other shared buffer is rewritten only
    // after at least one more barrier.
  }

  // ---- write the state back
#pragma unroll
  for (int s = 0; s < TILE; ++s)
    if (s < nvalid) p.gru_a_out[(b0 + s) * NA + j] = h_own[s];
  if (tid < TILE * NB && tid / NB < nvalid)
    p.gru_b_out[b0 * NB + tid] = s_hb[tid];
  if (writer) {
#pragma unroll
    for (int k = 0; k < ORDER; ++k)
      p.sig_out[(b0 + tid) * ORDER + k] = s_sig[tid * ORDER + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) p.rng_out[(b0 + tid) * 4 + q] = rng[q];
    p.exc_out[b0 + tid] = exc;
    p.deemph_out[b0 + tid] = deemph;
  }
}

template <bool FLAT, bool TF>
cudaError_t launch_sample(const LpcnetFrameParams* p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sample_kernel<FLAT, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = (p->batch + TILE - 1) / TILE;
  sample_kernel<FLAT, TF><<<grid, THREADS, SMEM_BYTES, stream>>>(*p);
  return cudaGetLastError();
}

}  // namespace lpcnet
