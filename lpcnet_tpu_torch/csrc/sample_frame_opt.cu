// One free-run 160-sample LPCNet frame for a batch of streams in the
// ordering of the fused TPU loop: the walked-tree frame kernel with fused
// operands and, optionally, the sampling thresholds drawn one sample ahead.
//
// Replaces the TPU kernel K5 _frame_kernel_opt (loop _synth_loop_opt) of
// lpcnet_tpu/kernels/sample_pallas.py, driven by synthesize_frame_pallas
// with variant 'fuse' (PIPELINE = false) or 'opt' (PIPELINE = true).
// Against the walked-tree kernel of sample_frame.cu it differs in
//   * its operands, which are the TPU kernel's: ONE embedding table tbl_cat
//     (768, 3*NA) = [tbl_sig; tbl_pred; tbl_exc], whose three rows of a step
//     are read at lsu, 256 + pu and 512 + exc, and ONE dual-FC weight
//     dfc_w12 (NB, 512) = [w1 | w2] with its bias (512);
//   * its loop order with PIPELINE: the two KISS99 draws and eight logit
//     table lookups of sample i + 1 happen during sample i, into the other
//     half of a double-buffered threshold array. They run on RNG threads
//     (lanes 0..7 of warp 4), which hold no scalar chain state, in the
//     dual-FC phase, where warps 4-11 have one round less to do than warps
//     0-3; the serialized scalar phase on the stream threads is left with
//     the prediction and the two mu-laws. Measured on an H100, 'opt' is
//     no faster than 'fuse' (0 to 1.1% slower over three runs), here as
//     with the draws beside GRU-B's gate update: on a stream thread the
//     integer draws cost nothing beside the prediction's dependent float
//     chain. The
//     thresholds of sample 0 are drawn before the loop, and nothing is drawn
//     for sample 160: the TPU loop, which cannot branch, draws there and
//     rolls the state back, which leaves the same RNG bits.
// Free-run only and walked tree only, as the TPU kernel.
//
// It leaves the bits of the walked-tree kernel (pcm, excitation, RNG, GRU
// states): the four terms of GRU-A's input are summed in that kernel's order
// ((cond_a + sig) + pred) + exc (the TPU loop sums the three rows inside one
// product and adds cond_a last, which can differ in the last bit), each of
// the 512 dual-FC columns sums over k = 0..15 in order, and the GRU phases
// are the device functions of lpcnet_sample.cuh. Built like the others
// with --fmad=false and IEEE expf/tanhf.
//
// What bounds it on an H100 and what the design does about it is in
// lpcnet_sample.cuh: the same tile of 8 streams per CTA, one thread per
// GRU-A unit, wr_a re-read from L2 each step, ~8 block barriers per step.

#include "lpcnet_sample.cuh"

// The argument block; its ctypes twin is
// kernels/sample_cuda.py::_OptParams.
struct LpcnetOptParams {
  const float* cond_a;      // (B, *) rows of stride ca_stride, 3*NA used
  const float* cond_b;      // (B, *) rows of stride cb_stride, 3*NB used
  const float* lpc;         // (B, *) rows of stride lpc_stride, ORDER used
  long long ca_stride, cb_stride, lpc_stride;
  const float* tbl_cat;     // (3*NL, 3*NA): sig, pred, exc tables in a row
  const float* wr_a;        // (NA, 3*NA)
  const float* br_a;        // (3*NA)
  const float* wi_b;        // (NA, 3*NB)
  const float* wr_b;        // (NB, 3*NB)
  const float* br_b;        // (3*NB)
  const float* dfc_w12;     // (NB, 2*NL): channel 1 | channel 2
  const float* dfc_b12;     // (2*NL)
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
  int batch;
  float preemph;
};

namespace {

using namespace lpcnet;

// The shared-memory layout of the sample loop, with the two threshold
// buffers in place of the flat sampler's compare bytes.
constexpr int O_THR = OFF_CMP;                       // [buffer][stream][level]
constexpr size_t O_SMEM_BYTES = (O_THR + 2 * TILE * 8) * sizeof(float);
constexpr int RNG_T0 = 4 * 32;                       // first RNG thread
static_assert(RNG_T0 >= TILE * NL - (TILE * NL / THREADS) * THREADS,
              "RNG threads are among those with one dual-FC round less");

// Two KISS99 draws -> the 8 thresholds of one sample, low byte first.
__device__ __forceinline__ void draw_thresholds(uint32_t (&rng)[4],
                                                const float* s_logit,
                                                float* thr) {
  const uint32_t r1 = kiss99(rng);
  const uint32_t r2 = kiss99(rng);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    thr[k] = s_logit[(r1 >> (8 * k)) & 0xFFu];
    thr[4 + k] = s_logit[(r2 >> (8 * k)) & 0xFFu];
  }
}

template <bool PIPELINE>
__global__ void __launch_bounds__(THREADS, 1)
sample_opt_kernel(const LpcnetOptParams p) {
  extern __shared__ __align__(16) float smem[];
  float* s_wi_b = smem + OFF_WI_B;
  float* s_wr_b = smem + OFF_WR_B;
  float* s_br_b = smem + OFF_BR_B;
  float* s_dfc_w12 = smem + OFF_DFC_W;  // [k][2*NL]
  float* s_dfc_b12 = smem + OFF_DFC_B;  // [2*NL]
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
  float* s_sig = smem + OFF_SIG;        // [stream][lag]
  float* s_lpc = smem + OFF_LPC;        // [stream][coef]
  int* s_idx = reinterpret_cast<int*>(smem + OFF_IDX);   // rows of tbl_cat
  float* s_thr = smem + O_THR;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TILE;
  const int nvalid = min(TILE, p.batch - b0);

  // ---- stage the small weights and this call's per-stream inputs
  for (int i = tid; i < NA * G3B; i += THREADS) s_wi_b[i] = p.wi_b[i];
  for (int i = tid; i < NB * G3B; i += THREADS) s_wr_b[i] = p.wr_b[i];
  for (int i = tid; i < G3B; i += THREADS) s_br_b[i] = p.br_b[i];
  for (int i = tid; i < NB * 2 * NL; i += THREADS) s_dfc_w12[i] = p.dfc_w12[i];
  for (int i = tid; i < 2 * NL; i += THREADS) {
    s_dfc_b12[i] = p.dfc_b12[i];
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

  // stream threads (lanes 0..TILE-1 of warp 0) hold the scalar chain state;
  // the RNG belongs to them ('fuse') or to the RNG threads ('opt')
  const bool stream_thread = tid < TILE;
  const int rng_s = PIPELINE ? tid - RNG_T0 : tid;   // this thread's stream
  const bool rng_thread = rng_s >= 0 && rng_s < TILE;
  const bool rng_writer = rng_s >= 0 && rng_s < nvalid;
  const bool writer = tid < nvalid;
  uint32_t rng[4] = {0u, 0u, 0u, 0u};
  float deemph = 0.0f;
  int exc = 0;
  if (rng_writer) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rng[q] = (uint32_t)p.rng_in[(b0 + rng_s) * 4 + q];
  }
  if (writer) {
    deemph = p.deemph_in[b0 + tid];
    exc = p.exc_in[b0 + tid];
  }
  __syncthreads();
  // 'opt': the thresholds of sample 0, drawn ahead of the loop
  if (PIPELINE && rng_thread) draw_thresholds(rng, s_logit, s_thr + rng_s * 8);
  __syncthreads();

  for (int i = 0; i < FS; ++i) {
    // thresholds of this sample: buffer i & 1 ('opt'), buffer 0 ('fuse')
    float* thr_cur = s_thr + (PIPELINE ? (i & 1) * TILE * 8 : 0);
    float pred = 0.0f;

    // A. prediction and mu-law inputs; 'fuse' draws its thresholds here
    if (stream_thread) {
      const float* sig = s_sig + tid * ORDER;
      const float* lpc = s_lpc + tid * ORDER;
      float acc = sig[0] * lpc[0];
#pragma unroll
      for (int k = 1; k < ORDER; ++k) acc = acc + sig[k] * lpc[k];
      pred = -acc;
      s_idx[tid * 4 + 0] = lin2ulaw(sig[0]);
      s_idx[tid * 4 + 1] = NL + lin2ulaw(pred);
      s_idx[tid * 4 + 2] = 2 * NL + exc;
      if (!PIPELINE) draw_thresholds(rng, s_logit, thr_cur + tid * 8);
    }
    __syncthreads();

    // B. GRU-A; the three rows of a stream come from the one table
    gru_a_update(p.wr_a, p.tbl_cat, p.tbl_cat, p.tbl_cat, s_ha, s_idx, ca,
                 bra0, bra1, bra2, j, ALL_ACTIVE, h_own);
    __syncthreads();   // every thread is done reading the old s_ha
#pragma unroll
    for (int s = 0; s < TILE; ++s) s_ha[j * TILE + s] = h_own[s];
    __syncthreads();

    // C-E. GRU-B
    gru_b_input_partial(s_wi_b, s_ha, s_part, tid);
    __syncthreads();
    gru_b_preact(s_part, s_cb, s_hb, s_wr_b, s_br_b, s_zrh_b, s_rec_b, tid);
    __syncthreads();
    gru_b_update(s_zrh_b, s_rec_b, s_hb, tid, ALL_ACTIVE);
    __syncthreads();

    // F. dual-FC logits from the one (NB, 2*NL) weight, thread = (stream,
    // class): columns c and NL + c. The 2048 logits are 6 rounds for warps
    // 0-3 and 5 for the others; in that slack the RNG threads draw the next
    // sample's thresholds into the other buffer, which was last read in
    // phase H of the sample before this one.
    if (PIPELINE && rng_thread && i + 1 < FS)
      draw_thresholds(rng, s_logit,
                      s_thr + ((i + 1) & 1) * TILE * 8 + rng_s * 8);
    for (int q = tid; q < TILE * NL; q += THREADS) {
      const int s = q / NL, c = q % NL;
      const float* h = s_hb + s * NB;
      float y1 = h[0] * s_dfc_w12[c], y2 = h[0] * s_dfc_w12[NL + c];
#pragma unroll
      for (int k = 1; k < NB; ++k) {
        y1 += h[k] * s_dfc_w12[k * 2 * NL + c];
        y2 += h[k] * s_dfc_w12[k * 2 * NL + NL + c];
      }
      y1 = tanhf(y1 + s_dfc_b12[c]);
      y2 = tanhf(y2 + s_dfc_b12[NL + c]);
      s_logits[q] = y1 * s_dfc_f[c] + y2 * s_dfc_f[NL + c];
    }
    __syncthreads();

    // H. tree walk, excitation -> signal, de-emphasis, clip, round
    if (stream_thread) {
      const float* lg = s_logits + tid * NL;
      const float* thr = thr_cur + tid * 8;
      int val = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        val = (val << 1) | (thr[b] < lg[val | (1 << b)]);
      exc = val;
      const float pcm = pred + s_u2l[exc];
      float* sig = s_sig + tid * ORDER;
#pragma unroll
      for (int k = ORDER - 1; k > 0; --k) sig[k] = sig[k - 1];
      sig[0] = pcm;
      deemph = pcm + p.preemph * deemph;
      float out = fminf(fmaxf(deemph, -32767.0f), 32767.0f);
      out = floorf(0.5f + out);
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
  if (rng_writer) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p.rng_out[(b0 + rng_s) * 4 + q] = rng[q];
  }
  if (writer) {
#pragma unroll
    for (int k = 0; k < ORDER; ++k)
      p.sig_out[(b0 + tid) * ORDER + k] = s_sig[tid * ORDER + k];
    p.exc_out[b0 + tid] = exc;
    p.deemph_out[b0 + tid] = deemph;
  }
}

template <bool PIPELINE>
cudaError_t launch_opt(const LpcnetOptParams* p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sample_opt_kernel<PIPELINE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)O_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = (p->batch + TILE - 1) / TILE;
  sample_opt_kernel<PIPELINE><<<grid, THREADS, O_SMEM_BYTES, stream>>>(*p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one frame on `stream`; returns the cudaError_t of the launch.
int lpcnet_sample_frame_opt(const LpcnetOptParams* p, int pipeline,
                            void* stream) {
  if (p->batch <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pipeline ? launch_opt<true>(p, s) : launch_opt<false>(p, s));
}

const char* lpcnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
