// GRU-A / GRU-B advance over a fully teacher-forced segment for a batch of
// streams, from mu-law indices computed beforehand.
//
// Replaces the TPU kernel K4 _teacher_kernel of
// lpcnet_tpu/kernels/sample_pallas.py (driven by teacher_advance_pallas).
// Under full forcing the signal and excitation of every sample follow from
// the target alone, so the three table rows of each step are known before
// the launch (kernels/sample_scan.py::teacher_sequences) and the loop body
// is: cond_a + tbl_sig[i] + tbl_pred[i] + tbl_exc[i] -> GRU-A ->
// gru_a @ wi_b + cond_b -> GRU-B. No dual-FC, no sampler, no RNG: the
// non-GRU state and the RNG advance are computed outside the kernel.
//
// What bounds it on an H100: what bounds the sample loop
// (lpcnet_sample.cuh), less its dual-FC and sampler phases: each step each
// CTA re-reads wr_a (1.77 MB) from L2 and does 461,568 multiply-adds per
// stream in float32 without FMA, with 6 block barriers per step.
// Design: the same tile of 8 streams per CTA and one thread per GRU-A
// unit, and the very device functions of the sample loop for the two GRUs,
// so that a fully forced synth_samples launch and this kernel sum in one
// order and leave the same GRU bits. Each step's 24 indices of the tile are
// read by 24 threads ahead of the first barrier.

#include "lpcnet_sample.cuh"

// The argument block; its ctypes twin is
// kernels/sample_cuda.py::_TeacherParams.
struct LpcnetTeacherParams {
  const float* cond_a;      // (B, 3*NA)
  const float* cond_b;      // (B, 3*NB)
  const float* tbl_sig;     // (NL, 3*NA)
  const float* tbl_pred;
  const float* tbl_exc;
  const float* wr_a;        // (NA, 3*NA)
  const float* br_a;        // (3*NA)
  const float* wi_b;        // (NA, 3*NB)
  const float* wr_b;        // (NB, 3*NB)
  const float* br_b;        // (3*NB)
  const int* idx_sig;       // (B, ns) rows of tbl_sig, values in [0, NL)
  const int* idx_pred;      // (B, ns)
  const int* idx_exc;       // (B, ns)
  const float* gru_a_in;    // (B, NA)
  const float* gru_b_in;    // (B, NB)
  float* gru_a_out;         // may alias the inputs
  float* gru_b_out;
  int batch;
  int nsamples;
};

namespace {

using namespace lpcnet;

// Shared memory, in floats
constexpr int T_WI_B = 0;
constexpr int T_WR_B = T_WI_B + NA * G3B;
constexpr int T_BR_B = T_WR_B + NB * G3B;
constexpr int T_HA = T_BR_B + G3B;
constexpr int T_PART = T_HA + NA * TILE;
constexpr int T_CB = T_PART + KPART * TILE * G3B;
constexpr int T_ZRH_B = T_CB + TILE * G3B;
constexpr int T_REC_B = T_ZRH_B + TILE * G3B;
constexpr int T_HB = T_REC_B + TILE * G3B;
constexpr int T_IDX = T_HB + TILE * NB;              // int: sig, pred, exc
constexpr size_t T_SMEM_BYTES = (T_IDX + TILE * 4) * sizeof(float);

__global__ void __launch_bounds__(THREADS, 1)
teacher_advance_kernel(const LpcnetTeacherParams p) {
  extern __shared__ __align__(16) float smem[];
  float* s_wi_b = smem + T_WI_B;
  float* s_wr_b = smem + T_WR_B;
  float* s_br_b = smem + T_BR_B;
  float* s_ha = smem + T_HA;            // [k][stream]
  float* s_part = smem + T_PART;        // [slice][stream][gate]
  float* s_cb = smem + T_CB;            // [stream][gate]
  float* s_zrh_b = smem + T_ZRH_B;
  float* s_rec_b = smem + T_REC_B;
  float* s_hb = smem + T_HB;            // [stream][unit]
  int* s_idx = reinterpret_cast<int*>(smem + T_IDX);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TILE;
  const int nvalid = min(TILE, p.batch - b0);

  for (int i = tid; i < NA * G3B; i += THREADS) s_wi_b[i] = p.wi_b[i];
  for (int i = tid; i < NB * G3B; i += THREADS) s_wr_b[i] = p.wr_b[i];
  for (int i = tid; i < G3B; i += THREADS) s_br_b[i] = p.br_b[i];
  for (int i = tid; i < TILE * G3B; i += THREADS) {
    const int s = i / G3B, o = i % G3B;
    s_cb[i] = s < nvalid ? p.cond_b[(long long)(b0 + s) * G3B + o] : 0.0f;
  }
  for (int i = tid; i < TILE * NB; i += THREADS) {
    const int s = i / NB, u = i % NB;
    s_hb[i] = s < nvalid ? p.gru_b_in[(b0 + s) * NB + u] : 0.0f;
  }
  const int j = tid;
  float h_own[TILE], ca[TILE][3];
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    const bool ok = s < nvalid;
    h_own[s] = ok ? p.gru_a_in[(b0 + s) * NA + j] : 0.0f;
    s_ha[j * TILE + s] = h_own[s];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      ca[s][g] = ok ? p.cond_a[(long long)(b0 + s) * G3A + g * NA + j] : 0.0f;
  }
  const float bra0 = p.br_a[j], bra1 = p.br_a[NA + j],
              bra2 = p.br_a[2 * NA + j];
  // thread (stream s, table q) of the first 24 fetches index [s][q]
  const int is = tid / 3, iq = tid % 3;
  const int* idx_src = nullptr;
  if (tid < TILE * 3 && is < nvalid)
    idx_src = (iq == 0 ? p.idx_sig : iq == 1 ? p.idx_pred : p.idx_exc)
              + (long long)(b0 + is) * p.nsamples;
  __syncthreads();

  for (int i = 0; i < p.nsamples; ++i) {
    if (tid < TILE * 3) s_idx[is * 4 + iq] = idx_src ? idx_src[i] : 0;
    __syncthreads();
    gru_a_update(p.wr_a, p.tbl_sig, p.tbl_pred, p.tbl_exc, s_ha, s_idx, ca,
                 bra0, bra1, bra2, j, ALL_ACTIVE, h_own);
    __syncthreads();   // every thread is done reading the old s_ha
#pragma unroll
    for (int s = 0; s < TILE; ++s) s_ha[j * TILE + s] = h_own[s];
    __syncthreads();
    gru_b_input_partial(s_wi_b, s_ha, s_part, tid);
    __syncthreads();
    gru_b_preact(s_part, s_cb, s_hb, s_wr_b, s_br_b, s_zrh_b, s_rec_b, tid);
    __syncthreads();
    gru_b_update(s_zrh_b, s_rec_b, s_hb, tid, ALL_ACTIVE);
    // the next step rewrites s_idx, read above before two barriers, and
    // s_hb is read again only after four more
  }
  __syncthreads();

#pragma unroll
  for (int s = 0; s < TILE; ++s)
    if (s < nvalid) p.gru_a_out[(b0 + s) * NA + j] = h_own[s];
  if (tid < TILE * NB && tid / NB < nvalid)
    p.gru_b_out[b0 * NB + tid] = s_hb[tid];
}

}  // namespace

extern "C" {

// Launches one call on `stream`; returns the cudaError_t of the launch.
int lpcnet_teacher_advance(const LpcnetTeacherParams* p, void* stream) {
  if (p->batch <= 0 || p->nsamples <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      teacher_advance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (p->batch + TILE - 1) / TILE;
  teacher_advance_kernel<<<grid, THREADS, T_SMEM_BYTES,
                           static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

const char* lpcnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
