// The autoregressive sample loop of the LPCNet vocoder for a batch of
// streams, every state resident on chip for the whole call, redesigned for
// the H100. It replaces the TPU kernels of
// lpcnet_tpu/kernels/sample_pallas.py
//   K1 _frame_kernel_flat, K2 _frame_kernel      (sample_frame.cu)
//   K3 _tf_frame_kernel_flat, _tf_frame_kernel   (synth_samples.cu)
//   K5 _frame_kernel_opt ('fuse', 'opt')         (sample_frame_opt.cu)
//   K4 _teacher_kernel                           (teacher_advance.cu)
// KIND (enum Kind below) says which: FORCED adds the forcing and freeze
// machinery, whose inputs are run-time pointers uniform over the grid (a
// null target or n_active switches that part off); FUSE and OPT read K5's
// fused dual-FC weight and, OPT, draw each sample's thresholds one sample
// ahead; TEACHER forces every step and drops the tail. FLAT picks the
// sampler (flat sampling tree or the walked one; same bits). PROF adds
// clock stamps around each phase of the step on the first CTA (the
// phase-split instances; never the main path). BF16 reads the three
// embedding tables as bfloat16 (the JAX package's table_dtype of K1, K2
// and K5, which K3 and K4 do not take): each element is widened with
// __bfloat162float where the float32 instance reads a float, and the sum
// ((cond_a + sig) + pred) + exc keeps its order, so a BF16 instance gives
// the bits of its float32 instance on the tables rounded to bfloat16 and
// widened. Rounding happens once, on the host, to nearest even
// (kernels/sample_scan.py::bf16_tables); the kernel never rounds. The
// rows are half the bytes; the loop is otherwise the same.
//
// What bounds it on an H100 (132 SMs, 227 KB of shared memory per block):
//   * Each step of a stream is one serialized chain (pred -> mu-law ->
//     GRU-A -> GRU-B -> dual-FC -> sample -> pcm); 160 steps per frame.
//   * GRU-A's recurrent product is 384 x 1152 multiply-adds per stream and
//     step, 98% of the arithmetic. Bit parity with the plain version
//     fixes its order: every column sums k = 0..383 in sequence from the
//     k = 0 product, as separate multiplies and adds (--fmad=false: two
//     instructions each). Split-K, tensor cores and FMA would change bits.
//   * Floors: at B=1024, 76.96 G multiply-adds x 2 instructions over the
//     card's 33.5 T lane-instructions/s = 4.59 ms per 160-sample launch
//     (the 2.30 ms of the table counts an FMA as two operations). At B=1,
//     the dependent chain of 383 adds per column, ~0.9 us per step.
//   * wr_a is 1.77 MB: it does not fit in one SM's shared memory. The
//     first design re-read it from L2 with __ldg in every step and CTA;
//     its GRU-A loop waited on L2 latency (52 of 61 us per step, the same
//     for one stream as for 1024).
// The two launch plans, picked by the wrapper from the batch
// (kernels/sample_cuda.py::launch_plan):
//   Plan L (few streams, latency): a cluster of 16 CTAs per tile of 8
//     streams. CTA r owns GRU-A units 24r..24r+23, their 72 gate columns,
//     whose wr_a slice (110.6 KB, repacked per CTA) stays in shared memory
//     for the whole launch. 96 threads run GRU-A, each one unit's three
//     gates for two streams: six sums in registers, 5 float4 loads per 24
//     multiplies and adds (one column and stream per thread was bound by
//     shared-memory bandwidth, two operand loads per multiply-add). The
//     new states go to every CTA's double-buffered s_ha by st.async, whose
//     bytes complete on an mbarrier of the receiving CTA; CTAs 0-7 compute
//     one wi_b slice partial each and send it likewise. No cluster barrier
//     runs inside the loop (barrier.cluster compiles to a GPU-wide memory
//     barrier and an L1 invalidation, ~1.5 us per step each). The tail
//     (GRU-B, dual-FC, sampler, phases A and H) is replicated in every CTA
//     (the same code on the same inputs gives the same bits) and CTA 0
//     alone writes what the stream emits. Runs only when all its clusters
//     are co-resident (B <= 8 x cudaOccupancyMaxActiveClusters); a larger
//     launch is refused, never run in waves.
//   Plan T (many streams, throughput): one CTA per 8 streams in clusters
//     of 2. wr_a reaches GRU-A only through shared memory: a ring of
//     4-row chunks that one producer thread fills with cp.async.bulk
//     copies multicast to both CTAs (each CTA fetches half a chunk; L2
//     reads of wr_a halve), with full and empty mbarriers per slot. The 384
//     consumer threads keep one GRU-A unit each (3 x 8 sums in registers,
//     the k order) and read weights at shared-memory latency. A consumer
//     warp releases a slot with plain arrivals on both CTAs' empty
//     barriers (a cluster-scope release there compiled to a GPU-wide
//     memory barrier per warp and chunk, and made the loop 2.6x slower
//     than the first design). The rest of the step is the first design's,
//     on a named barrier of the consumers. Without the ring (wr_a by
//     __ldg, the same consumers; tools/plan_t_ablation.py) GRU-A took
//     75.1 us per step against the ring's 48.5 on an H100 80GB HBM3 at
//     700 W, and a frame 9.95 ms against 8.90.
// K5 and K4 are instances of the same two plans, so they keep K2's and
// K3's sums term for term and leave their bits:
//   * K5 reads the TPU kernel's fused operands: the wrapper points the
//     three table pointers at rows 0, NL and 2*NL of tbl_cat, and the
//     staging reads dfc_w12 (NB, 2*NL) into the (2, NB, NL) layout of
//     dfc_w through its own index map. 'opt' draws the two KISS99 numbers
//     and eight thresholds of sample i+1 during sample i on the RNG
//     threads (lanes 0-7 of warp 4) into the other half of a
//     double-buffered threshold array; nothing is drawn for the last
//     sample. Plan L: during the GRU-A loop, which leaves warp 4 idle.
//     Plan T has no idle thread among its consumers, and a lane of the
//     producer warp would serialise against the bulk-copy issue and is not
//     on the consumers' named barrier, so warp 4 draws in the dual-FC
//     phase, where it has one round less than warps 0-3. Measured on an
//     H100 80GB HBM3 at 700 W (chip_smoke.py), 'opt' is no faster than
//     'fuse' in either plan (+0.4% at B=1, -0.4% at B=1024), and no
//     faster with plan L's draws on warp 3, whose scheduler GRU-A leaves
//     idle: on a stream thread the integer draws run beside phase A's
//     dependent float chain (the prediction) and cost nothing.
//   * K4 is the loop without its tail: every step forced from the target
//     (phase A's prediction and mu-laws, the RNG advanced by two draws
//     with no lookups, GRU-A, GRU-B, phase H's forced update), no dual-FC,
//     sampler or pcm. The table indices and the de-emphasis chain that the
//     first design took precomputed from the host are computed in the
//     loop, where the stream threads were idle.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "lpcnet_sample.cuh"

namespace lpcnet {

namespace cg = cooperative_groups;

constexpr size_t SMEM_LIMIT = 232448;    // dynamic shared memory per block

// ---- the instances of the loop
enum Kind : int {
  FRAME = 0,     // K1, K2: one free-run frame
  FORCED = 1,    // K3: nsamples steps, teacher forcing and freeze
  FUSE = 2,      // K5 'fuse': K2 on the fused operands
  OPT = 3,       // K5 'opt': FUSE, thresholds drawn one sample ahead
  TEACHER = 4,   // K4: nsamples forced steps without the tail
};

template <int KIND>
struct Traits {
  static constexpr bool TF = KIND == FORCED;
  static constexpr bool FUSED = KIND == FUSE || KIND == OPT;
  static constexpr bool PIPELINE = KIND == OPT;
  static constexpr bool TEACH = KIND == TEACHER;
  static constexpr bool TAIL = !TEACH;         // dual-FC, sampler, pcm
  static constexpr bool NS_ARG = TF || TEACH;  // nsamples from the block
};


// Element i of an embedding table as a float: read through the read-only
// path, and from a bfloat16 table widened (exact).
template <bool BF16>
__device__ __forceinline__ float table_at(const void* tbl, int i) {
  if constexpr (BF16)
    return __bfloat162float(
        __ldg(static_cast<const __nv_bfloat16*>(tbl) + i));
  else
    return __ldg(static_cast<const float*>(tbl) + i);
}


// ---- plan L
constexpr int CLUSTER_L = 16;             // CTAs per tile
constexpr int UNITS_L = NA / CLUSTER_L;   // GRU-A units per CTA
constexpr int COLS_L = 3 * UNITS_L;       // wr_a columns per CTA
constexpr int PAIRS = TILE / 2;           // GRU-A thread = (unit, 2 streams)
constexpr int GRU_THREADS_L = UNITS_L * PAIRS;
constexpr int THREADS_L = THREADS;        // the tail's (stream, gate) width
constexpr int KPAD = NA + 4;              // padded row: conflict-free float4
constexpr unsigned SLAB_BYTES = TILE * UNITS_L * sizeof(float);
constexpr unsigned PART_BYTES = TILE * G3B * sizeof(float);
static_assert(KPART <= CLUSTER_L, "one wi_b slice per CTA at most");
static_assert(UNITS_L % 4 == 0, "the state exchange moves float4");
static_assert(GRU_THREADS_L <= THREADS_L, "GRU-A threads are a subset");
// the first RNG thread of the pipelined instance (K5 'opt'; one per stream
// of the tile): lane 0 of warp 4
constexpr int RNG_T0 = 4 * 32;
static_assert(RNG_T0 >= GRU_THREADS_L && RNG_T0 + TILE <= THREADS_L,
              "plan L: the RNG threads hold no GRU-A work");
static_assert(RNG_T0 >= TILE * NL % THREADS,
              "plan T: the RNG threads have one dual-FC round less");

// Shared memory of plan L per CTA, in floats:
//   wr_a slice [72][388]                  111,744 B
//   s_ha [2][8][388] (double buffer)       24,832 B
//   wi_b slice [48][48]                     9,216 B
//   wr_b, br_b                              3,264 B
//   dual-FC w, b, factor                   36,864 B
//   logit + ULAW2LIN tables                 2,048 B
//   slice partials [8][8][48]              12,288 B
//   GRU-B cb, zrh, rec, h                   5,120 B
//   logits, thresholds [2], sig, lpc        9,728 B
//   indices, exc, active counts, compares   2,240 B
//   3 mbarriers of the exchanges (+pad)        32 B
//   total                                 217,376 B
// (every instance takes this layout; K4 leaves the tail's buffers unused,
// and only K5 'opt' uses the second threshold buffer)
constexpr int L_WA = 0;
constexpr int L_HA = L_WA + COLS_L * KPAD;
constexpr int L_WIB = L_HA + 2 * TILE * KPAD;
constexpr int L_WR_B = L_WIB + KSLICE * G3B;
constexpr int L_BR_B = L_WR_B + NB * G3B;
constexpr int L_DFC_W = L_BR_B + G3B;
constexpr int L_DFC_B = L_DFC_W + 2 * NB * NL;
constexpr int L_DFC_F = L_DFC_B + 2 * NL;
constexpr int L_LOGIT = L_DFC_F + 2 * NL;
constexpr int L_U2L = L_LOGIT + NL;
constexpr int L_PART = L_U2L + NL;
constexpr int L_CB = L_PART + KPART * TILE * G3B;
constexpr int L_ZRH_B = L_CB + TILE * G3B;
constexpr int L_REC_B = L_ZRH_B + TILE * G3B;
constexpr int L_HB = L_REC_B + TILE * G3B;
constexpr int L_LOGITS = L_HB + TILE * NB;
constexpr int L_THR = L_LOGITS + TILE * NL;
constexpr int L_SIG = L_THR + 2 * TILE * 8;
constexpr int L_LPC = L_SIG + TILE * ORDER;
constexpr int L_IDX = L_LPC + TILE * ORDER;          // int: lsu, pu, exc
constexpr int L_EXC = L_IDX + TILE * 4;              // int: sampled exc
constexpr int L_NACT = L_EXC + TILE;                 // int: active counts
constexpr int L_CMP = L_NACT + TILE;                 // bytes: node compares
constexpr size_t L_BARS = L_CMP * sizeof(float) + TILE * NL;
constexpr size_t L_SMEM_BYTES = L_BARS + 4 * sizeof(uint64_t);
static_assert(L_BARS % 8 == 0, "mbarriers are 8-byte aligned");
static_assert(L_SMEM_BYTES == 217376, "the table above");
static_assert(L_SMEM_BYTES <= SMEM_LIMIT, "plan L fits one block");

// ---- plan T
constexpr int CLUSTER_T = 2;              // CTAs sharing each wr_a chunk
constexpr int THREADS_T = THREADS + 32;   // 384 consumers + producer warp
constexpr int RING_ROWS = 4;              // wr_a rows per chunk
constexpr int RING_STAGES = 4;
constexpr int CHUNKS = NA / RING_ROWS;    // chunks per step
constexpr int CHUNK_FLOATS = RING_ROWS * G3A;
constexpr unsigned CHUNK_BYTES = CHUNK_FLOATS * sizeof(float);
constexpr unsigned PIECE_BYTES = CHUNK_BYTES / CLUSTER_T;
static_assert(NA % RING_ROWS == 0 && RING_ROWS % CLUSTER_T == 0,
              "each CTA fetches whole rows of every chunk");
// The ablation of the ring: built with -DLPCNET_ABLATE_RING (only
// tools/plan_t_ablation.py does), plan T reads wr_a in GRU-A straight from
// L2 with __ldg and the producer idles; all else stays.
#ifdef LPCNET_ABLATE_RING
constexpr bool T_ABLATE_RING = true;
#else
constexpr bool T_ABLATE_RING = false;
#endif
// Shared memory of plan T, in floats (every size is a multiple of 4:
// float4-aligned):
//   wi_b, wr_b, br_b                       76,992 B
//   dual-FC w, b, factor                   36,864 B
//   logit + ULAW2LIN tables                 2,048 B
//   s_ha [k][stream]                       12,288 B
//   slice partials, GRU-B cb, zrh, rec, h  17,408 B
//   logits, thresholds [2], sig, lpc        9,728 B
//   indices, exc, active counts, compares   2,240 B
//   ring 4 x 4 rows of wr_a                73,728 B
//   8 mbarriers                                64 B
//   total                                 231,360 B
// (8 slots, with wi_b read through L2 instead, were no faster: the loop
// does not wait on the ring. Every instance takes this layout, as plan
// L's.)
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
constexpr int OFF_SIG = OFF_THR + 2 * TILE * 8;
constexpr int OFF_LPC = OFF_SIG + TILE * ORDER;
constexpr int OFF_IDX = OFF_LPC + TILE * ORDER;      // int: lsu, pu, exc
constexpr int OFF_EXC = OFF_IDX + TILE * 4;          // int: sampled exc
constexpr int OFF_NACT = OFF_EXC + TILE;             // int: active counts
constexpr int OFF_CMP = OFF_NACT + TILE;             // bytes: node compares
constexpr size_t T_RING = OFF_CMP * sizeof(float) + TILE * NL;
constexpr size_t T_BARS = T_RING + (size_t)RING_STAGES * CHUNK_BYTES;
constexpr size_t T_SMEM_BYTES = T_BARS + 2 * RING_STAGES * sizeof(uint64_t);
static_assert(T_RING % 128 == 0, "the ring is 128-byte aligned");
static_assert(T_SMEM_BYTES == 231360, "the table above");
static_assert(T_SMEM_BYTES <= SMEM_LIMIT, "plan T fits one block");

// ---- mbarriers and bulk copies (PTX)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of `parity` to complete. The consumers wait on their
// own CTA's copies (CTA scope); the producer waits on arrivals from both
// CTAs (CLUSTER: cluster-scope acquire).
template <bool CLUSTER>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    if (CLUSTER)
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(a), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// One arrival on the mbarrier at the same offset in CTA `cta` of the
// cluster (this CTA included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    unsigned cta) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n\t}"
      :: "r"(smem_addr(bar)), "r"(cta) : "memory");
}

// A float4 to the same offset as `dst` in CTA `cta` of the cluster,
// completing 16 bytes of the transaction on its mbarrier at `bar`'s offset.
__device__ __forceinline__ void st_async_peer(float* dst, float4 v,
                                              uint64_t* bar, unsigned cta) {
  asm volatile(
      "{\n\t.reg .b32 rd, rb;\n\t"
      "mapa.shared::cluster.u32 rd, %0, %6;\n\t"
      "mapa.shared::cluster.u32 rb, %5, %6;\n\t"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [rd], "
      "{%1, %2, %3, %4}, [rb];\n\t}"
      :: "r"(smem_addr(dst)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
         "r"(smem_addr(bar)), "r"(cta)
      : "memory");
}

// `bytes` from global memory to the same offset in the shared memory of
// every CTA in `mask`, each completing on its mbarrier at `bar`'s offset.
__device__ __forceinline__ void bulk_copy_multicast(void* dst,
                                                    const void* src,
                                                    unsigned bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
         "h"(mask)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {   // the 384 consumers
  asm volatile("bar.sync 1, %0;" :: "n"(THREADS) : "memory");
}

// ---- clock stamps of the phase instance: A, GRU-A loop, GRU-A
// epilogue, exchange and barriers, GRU-B, dual-FC, sampler, H
constexpr int NPHASES = 8;

template <bool PROF>
struct PhaseClock {
  unsigned long long cyc[NPHASES], last, c0, ns0;
  bool on;
  __device__ __forceinline__ void start(bool stamper) {
    on = PROF && stamper;
    if (PROF && on) {
#pragma unroll
      for (int q = 0; q < NPHASES; ++q) cyc[q] = 0;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
      c0 = last = clock64();
    }
  }
  __device__ __forceinline__ void stamp(int q) {
    if (PROF && on) {
      const unsigned long long t = clock64();
      cyc[q] += t - last;
      last = t;
    }
  }
  // prof: the cycles of each phase, all cycles, nanoseconds, steps
  __device__ __forceinline__ void finish(unsigned long long* prof, int ns) {
    if (PROF && on) {
      unsigned long long ns1;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
#pragma unroll
      for (int q = 0; q < NPHASES; ++q) prof[q] = cyc[q];
      prof[NPHASES] = clock64() - c0;
      prof[NPHASES + 1] = ns1 - ns0;
      prof[NPHASES + 2] = ns;
    }
  }
};

// ---- per-stream scalar state and the phases on one thread per stream
struct StreamState {
  uint32_t rng[4];
  float deemph, pred;
  int exc, preload, force_from;
};

// forcing: the block carries preload and force_from (K3 with a target)
__device__ __forceinline__ void load_stream(const LpcnetFrameParams& p,
                                            int b, bool forcing,
                                            StreamState& st) {
#pragma unroll
  for (int q = 0; q < 4; ++q) st.rng[q] = (uint32_t)p.rng_in[b * 4 + q];
  st.deemph = p.deemph_in[b];
  st.exc = p.exc_in[b];
  if (forcing) {
    st.preload = p.preload[b];
    st.force_from = p.force_from[b];
  }
}

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

// A. prediction and mu-law inputs of stream s, and its thresholds from two
// KISS99 draws; K4 advances the RNG by the two draws without lookups, K5
// 'opt' draws on the RNG threads instead.
template <int KIND>
__device__ __forceinline__ void phase_a(int s, bool advance,
                                        const float* s_sig,
                                        const float* s_lpc,
                                        const float* s_logit, int* s_idx,
                                        float* s_thr, StreamState& st) {
  const float* sig = s_sig + s * ORDER;
  const float* lpc = s_lpc + s * ORDER;
  float acc = sig[0] * lpc[0];
#pragma unroll
  for (int k = 1; k < ORDER; ++k) acc = acc + sig[k] * lpc[k];
  st.pred = -acc;
  s_idx[s * 4 + 0] = lin2ulaw(sig[0]);
  s_idx[s * 4 + 1] = lin2ulaw(st.pred);
  s_idx[s * 4 + 2] = st.exc;
  if (Traits<KIND>::PIPELINE) return;
  uint32_t next[4] = {st.rng[0], st.rng[1], st.rng[2], st.rng[3]};
  if (Traits<KIND>::TEACH) {
    kiss99(next);
    kiss99(next);
  } else {
    draw_thresholds(next, s_logit, s_thr + s * 8);
  }
  if (advance) {
#pragma unroll
    for (int q = 0; q < 4; ++q) st.rng[q] = next[q];
  }
}

// H. excitation -> signal, de-emphasis, clip, round of stream s at step i
// under the thresholds s_thr; `mine`: s is a real stream; `writer`: this
// CTA writes its pcm. K4 takes every step from the target and emits
// nothing.
template <int KIND, bool FLAT>
__device__ __forceinline__ void phase_h(const LpcnetFrameParams& p, int b,
                                        int s, int i, bool advance,
                                        bool forcing, bool mine,
                                        bool writer, float* s_sig,
                                        const float* s_logits,
                                        const float* s_thr, const int* s_exc,
                                        const float* s_u2l,
                                        StreamState& st) {
  using T = Traits<KIND>;
  int e = 0;
  if (T::TAIL && FLAT) {
    e = s_exc[s];
  } else if (T::TAIL) {
    const float* lg = s_logits + s * NL;
    int val = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      val = (val << 1) | (s_thr[s * 8 + q] < lg[val | (1 << q)]);
    e = val;
  }
  // a forced step takes signal and excitation from the target
  // (lpcnet.c:256-261) and emits the target itself
  bool forced = false;
  float tgt = 0.0f, tf_sig = 0.0f;
  if (forcing) {
    tgt = mine ? p.target[b * p.tgt_stride + i] : 0.0f;
    tf_sig = tgt - p.preemph * st.deemph;
    forced = T::TEACH || i < st.preload || i >= st.force_from;
    if (forced) e = lin2ulaw(tf_sig - st.pred);
  }
  const float pcm = forced ? tf_sig : st.pred + s_u2l[e];
  float out = pcm + p.preemph * st.deemph;
  if (advance) {
    float* sig = s_sig + s * ORDER;
#pragma unroll
    for (int k = ORDER - 1; k > 0; --k) sig[k] = sig[k - 1];
    sig[0] = pcm;
    st.deemph = out;
    st.exc = e;
  }
  if (T::TAIL) {
    out = fminf(fmaxf(out, -32767.0f), 32767.0f);
    out = floorf(0.5f + out);
    if (forced) out = tgt;
    if (!advance) out = 0.0f;
    if (writer) p.pcm[b * p.pcm_stride + i] = out;
  }
}

// rng: K5 'opt' keeps it on the RNG threads, which store it themselves
template <int KIND>
__device__ __forceinline__ void store_stream(const LpcnetFrameParams& p,
                                             int b, const float* sig,
                                             const StreamState& st) {
#pragma unroll
  for (int k = 0; k < ORDER; ++k) p.sig_out[b * ORDER + k] = sig[k];
  if (!Traits<KIND>::PIPELINE) {
#pragma unroll
    for (int q = 0; q < 4; ++q) p.rng_out[b * 4 + q] = st.rng[q];
  }
  p.exc_out[b] = st.exc;
  p.deemph_out[b] = st.deemph;
}

// K5 'opt': the RNG of stream s on its RNG thread, and its store
__device__ __forceinline__ void load_rng(const LpcnetFrameParams& p, int b,
                                         uint32_t (&rng)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) rng[q] = (uint32_t)p.rng_in[b * 4 + q];
}

__device__ __forceinline__ void store_rng(const LpcnetFrameParams& p, int b,
                                          const uint32_t (&rng)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) p.rng_out[b * 4 + q] = rng[q];
}

// F. dual-FC logits, item = (stream, class), over NT threads
template <int NT>
__device__ __forceinline__ void dual_fc(const float* s_hb,
                                        const float* s_dfc_w,
                                        const float* s_dfc_b,
                                        const float* s_dfc_f,
                                        float* s_logits, int tid) {
  for (int q = tid; q < TILE * NL; q += NT) {
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
}

// G. flat sampler, first pass: compare every heap node with its level's
// threshold (node 0 is unused)
template <int NT>
__device__ __forceinline__ void flat_compare(const float* s_thr,
                                             const float* s_logits,
                                             unsigned char* s_cmp, int tid) {
  for (int q = tid; q < TILE * NL; q += NT) {
    const int s = q / NL, n = q % NL;
    const int level = 31 - __clz(n | 1);
    s_cmp[q] = s_thr[s * 8 + level] < s_logits[q];
  }
}

// second pass: the leaf whose 8 path bits all agree is the sample
template <int NT>
__device__ __forceinline__ void flat_pick(const unsigned char* s_cmp,
                                          int* s_exc, int tid) {
  for (int q = tid; q < TILE * NL; q += NT) {
    const int s = q / NL, c = q % NL;
    bool agree = true;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int node = (1 << b) + (c >> (8 - b));
      agree &= s_cmp[s * NL + node] == ((c >> (7 - b)) & 1);
    }
    if (agree) s_exc[s] = c;
  }
}

// The tile's streams that advance on step i, one bit each.
__device__ __forceinline__ unsigned active_mask(bool freezing, int i,
                                                const int* s_nact) {
  if (!freezing) return ALL_ACTIVE;
  unsigned active = 0u;
#pragma unroll
  for (int s = 0; s < TILE; ++s) active |= (i < s_nact[s] ? 1u : 0u) << s;
  return active;
}

// K5's dfc_w12 (NB, 2*NL) = [w1 | w2] read into the (2, NB, NL) layout of
// dfc_w: the source of element i of that layout.
__host__ __device__ constexpr int fused_dfc_src(int i) {
  return (i / NL) % NB * 2 * NL + i / (NB * NL) * NL + i % NL;
}

// Staging shared by both plans: the GRU-B weights but wi_b, the dual-FC
// and the two tables (K4: none of the tail's), and the tile's per-stream
// inputs.
template <int KIND>
__device__ __forceinline__ void stage_tail(
    const LpcnetFrameParams& p, int b0, int nvalid, bool freezing, int tid,
    int nt, float* s_wr_b, float* s_br_b, float* s_dfc_w, float* s_dfc_b,
    float* s_dfc_f, float* s_logit, float* s_cb, float* s_hb, float* s_sig,
    float* s_lpc, int* s_nact) {
  using T = Traits<KIND>;
  for (int i = tid; i < NB * G3B; i += nt) s_wr_b[i] = p.wr_b[i];
  for (int i = tid; i < G3B; i += nt) s_br_b[i] = p.br_b[i];
  if (T::TAIL) {
    for (int i = tid; i < 2 * NB * NL; i += nt)
      s_dfc_w[i] = p.dfc_w[T::FUSED ? fused_dfc_src(i) : i];
    for (int i = tid; i < 2 * NL; i += nt) {
      s_dfc_b[i] = p.dfc_b[i];
      s_dfc_f[i] = p.dfc_f[i];
      s_logit[i] = p.logit_tbl[i];    // s_logit and s_u2l are contiguous
    }
  }
  for (int i = tid; i < TILE * G3B; i += nt) {
    const int s = i / G3B, o = i % G3B;
    s_cb[i] = s < nvalid ? p.cond_b[(b0 + s) * p.cb_stride + o] : 0.0f;
  }
  for (int i = tid; i < TILE * NB; i += nt) {
    const int s = i / NB, u = i % NB;
    s_hb[i] = s < nvalid ? p.gru_b_in[(b0 + s) * NB + u] : 0.0f;
  }
  for (int i = tid; i < TILE * ORDER; i += nt) {
    const int s = i / ORDER, k = i % ORDER;
    const bool ok = s < nvalid;
    s_sig[i] = ok ? p.sig_in[(b0 + s) * ORDER + k] : 0.0f;
    s_lpc[i] = ok ? p.lpc[(b0 + s) * p.lpc_stride + k] : 0.0f;
  }
  if (freezing && tid < TILE)
    s_nact[tid] = tid < nvalid ? p.n_active[b0 + tid] : 0;
}

// Plan L's GRU-A sums of one unit (gate columns w0, w1, w2) for two
// streams (states h0, h1) over k..k+3; FIRST starts them from the k = 0
// product.
template <bool FIRST>
__device__ __forceinline__ void gru_a_quad(const float* w0, const float* w1,
                                           const float* w2, const float* h0,
                                           const float* h1, int k,
                                           float (&acc)[2][3]) {
  const float4 a0 = *reinterpret_cast<const float4*>(w0 + k);
  const float4 a1 = *reinterpret_cast<const float4*>(w1 + k);
  const float4 a2 = *reinterpret_cast<const float4*>(w2 + k);
  const float4 x0 = *reinterpret_cast<const float4*>(h0 + k);
  const float4 x1 = *reinterpret_cast<const float4*>(h1 + k);
  const float wv[3][4] = {{a0.x, a0.y, a0.z, a0.w},
                          {a1.x, a1.y, a1.z, a1.w},
                          {a2.x, a2.y, a2.z, a2.w}};
  const float hv[2][4] = {{x0.x, x0.y, x0.z, x0.w},
                          {x1.x, x1.y, x1.z, x1.w}};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        if (FIRST && kk == 0)
          acc[e][g] = hv[e][kk] * wv[g][kk];
        else
          acc[e][g] += hv[e][kk] * wv[g][kk];
      }
}

// ---- plan L: a 16-CTA cluster per tile of 8 streams
template <int KIND, bool FLAT, bool PROF, bool BF16>
__global__ void __launch_bounds__(THREADS_L, 1)
sample_l_kernel(const LpcnetFrameParams p) {
  using T = Traits<KIND>;
  extern __shared__ __align__(128) float smem[];
  float* s_wa = smem + L_WA;            // [column][KPAD]: this CTA's slice
  float* s_ha = smem + L_HA;            // [parity][stream][KPAD]
  float* s_wib = smem + L_WIB;          // [k][gate]: slice `rank` of wi_b
  float* s_wr_b = smem + L_WR_B;
  float* s_br_b = smem + L_BR_B;
  float* s_dfc_w = smem + L_DFC_W;
  float* s_dfc_b = smem + L_DFC_B;
  float* s_dfc_f = smem + L_DFC_F;
  float* s_logit = smem + L_LOGIT;
  float* s_u2l = smem + L_U2L;
  float* s_part = smem + L_PART;        // [slice][stream][gate]
  float* s_cb = smem + L_CB;
  float* s_zrh_b = smem + L_ZRH_B;
  float* s_rec_b = smem + L_REC_B;
  float* s_hb = smem + L_HB;            // [stream][unit]
  float* s_logits = smem + L_LOGITS;    // [stream][class]
  float* s_thr = smem + L_THR;          // [buffer][stream][level]
  float* s_sig = smem + L_SIG;          // [stream][lag]
  float* s_lpc = smem + L_LPC;          // [stream][coef]
  int* s_idx = reinterpret_cast<int*>(smem + L_IDX);
  int* s_exc = reinterpret_cast<int*>(smem + L_EXC);
  int* s_nact = reinterpret_cast<int*>(smem + L_NACT);
  unsigned char* s_cmp = reinterpret_cast<unsigned char*>(smem + L_CMP);
  // the exchanges land in this CTA through st.async, each counted on an
  // mbarrier: the states of step parity 0 and 1, the slice partials
  uint64_t* bar_h = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(smem) + L_BARS);
  uint64_t* bar_p = bar_h + 2;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int b0 = (blockIdx.x / CLUSTER_L) * TILE;
  const int nvalid = max(0, min(TILE, p.batch - b0));
  const int ns = T::NS_ARG ? p.nsamples : FS;
  const bool tf_forcing = T::TF && p.target != nullptr;
  const bool forcing = T::TEACH || tf_forcing;
  const bool freezing = T::TF && p.n_active != nullptr;
  // bytes that reach this CTA per step: 15 state slabs, and a partial from
  // each of the slice CTAs but itself
  const unsigned h_bytes = (CLUSTER_L - 1) * SLAB_BYTES;
  const unsigned p_bytes = (KPART - (rank < KPART ? 1 : 0)) * PART_BYTES;

  if (tid == 0) {
    mbar_init(&bar_h[0], 1);
    mbar_init(&bar_h[1], 1);
    mbar_init(bar_p, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // ---- stage this CTA's wr_a slice, its wi_b slice, the tail's weights
  // and the tile's inputs
  {
    const float4* src = reinterpret_cast<const float4*>(
        p.wr_a_l + (size_t)rank * COLS_L * NA);
    for (int i = tid; i < COLS_L * NA / 4; i += THREADS_L) {
      const int c = i / (NA / 4), k4 = i % (NA / 4);
      *reinterpret_cast<float4*>(s_wa + c * KPAD + 4 * k4) = __ldg(src + i);
    }
  }
  if (rank < KPART)
    for (int i = tid; i < KSLICE * G3B; i += THREADS_L)
      s_wib[i] = p.wi_b[rank * KSLICE * G3B + i];
  stage_tail<KIND>(p, b0, nvalid, freezing, tid, THREADS_L, s_wr_b, s_br_b,
                   s_dfc_w, s_dfc_b, s_dfc_f, s_logit, s_cb, s_hb, s_sig,
                   s_lpc, s_nact);
  for (int i = tid; i < TILE * NA; i += THREADS_L) {
    const int s = i / NA, k = i % NA;
    s_ha[s * KPAD + k] = s < nvalid ? p.gru_a_in[(b0 + s) * NA + k] : 0.0f;
  }

  // GRU-A thread (tid < 96) = (unit u of this CTA, streams 2q and 2q+1):
  // the three gate columns of the unit for two streams, six sums
  const bool gru_thread = tid < GRU_THREADS_L;
  const int u = tid / PAIRS, q2 = 2 * (tid % PAIRS);
  const int unit = rank * UNITS_L + u;
  float ca[2][3], h_own[2], bra[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bra[g] = gru_thread ? p.br_a[g * NA + unit] : 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool ok = gru_thread && q2 + e < nvalid;
    h_own[e] = ok ? p.gru_a_in[(b0 + q2 + e) * NA + unit] : 0.0f;
#pragma unroll
    for (int g = 0; g < 3; ++g)
      ca[e][g] = ok ? p.cond_a[(b0 + q2 + e) * p.ca_stride + g * NA + unit]
                    : 0.0f;
  }

  // stream threads (lanes 0..TILE-1 of warp 0) in every CTA; CTA 0 writes
  const bool stream_thread = tid < TILE;
  const bool mine = tid < nvalid;
  const bool writer = mine && rank == 0;
  StreamState st = {{0u, 0u, 0u, 0u}, 0.0f, 0.0f, 0, 0, 0};
  if (mine) load_stream(p, b0 + tid, tf_forcing, st);
  // K5 'opt': RNG thread RNG_T0 + s draws stream s's thresholds
  const int rng_s = tid - RNG_T0;
  const bool rng_thread = T::PIPELINE && rng_s >= 0 && rng_s < TILE;
  uint32_t rng[4] = {0u, 0u, 0u, 0u};
  if (rng_thread && rng_s < nvalid) load_rng(p, b0 + rng_s, rng);
  __syncthreads();
  // the thresholds of sample 0, read first after the loop's barriers
  if (rng_thread) draw_thresholds(rng, s_logit, s_thr + rng_s * 8);
  cluster.sync();   // barriers initialised and every CTA running

  PhaseClock<PROF> clk;
  clk.start(blockIdx.x == 0 && tid == 0);
  for (int i = 0; i < ns; ++i) {
    float* ha_old = s_ha + (i & 1) * TILE * KPAD;
    float* ha_new = s_ha + ((i + 1) & 1) * TILE * KPAD;
    const unsigned active = active_mask(freezing, i, s_nact);
    const bool advance = (active >> (tid & (TILE - 1))) & 1u;
    if (tid == 0) {
      // this step's incoming bytes; a peer's may already have landed
      mbar_arrive_expect_tx(&bar_h[(i + 1) & 1], h_bytes);
      mbar_arrive_expect_tx(bar_p, p_bytes);
    }

    // this sample's thresholds: K5 'opt' alternates two buffers
    float* thr = s_thr + (T::PIPELINE ? (i & 1) * TILE * 8 : 0);

    // A. prediction, mu-law inputs, thresholds (stream threads)
    if (stream_thread)
      phase_a<KIND>(tid, advance, s_sig, s_lpc, s_logit, s_idx, thr, st);
    __syncthreads();
    clk.stamp(0);

    // B. GRU-A. K5 'opt': meanwhile the RNG threads draw the next sample's
    // thresholds into the other buffer, last read in phase H of sample
    // i - 1, before the barrier above
    if (rng_thread && i + 1 < ns)
      draw_thresholds(rng, s_logit,
                      s_thr + ((i + 1) & 1) * TILE * 8 + rng_s * 8);
    if (gru_thread) {
      // the table rows of the epilogue are fetched first, so that their
      // latency passes under the loop
      float zrh[2][3];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int* idx = s_idx + (q2 + e) * 4;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int c = g * NA + unit;
          zrh[e][g] = ((ca[e][g] + table_at<BF16>(p.tbl_sig,
                                                  idx[0] * G3A + c))
                       + table_at<BF16>(p.tbl_pred, idx[1] * G3A + c))
                      + table_at<BF16>(p.tbl_exc, idx[2] * G3A + c);
        }
      }
      const float* w0 = s_wa + u * KPAD;
      const float* w1 = w0 + UNITS_L * KPAD;
      const float* w2 = w1 + UNITS_L * KPAD;
      const float* h0 = ha_old + q2 * KPAD;
      const float* h1 = h0 + KPAD;
      float acc[2][3];
      gru_a_quad<true>(w0, w1, w2, h0, h1, 0, acc);
#pragma unroll 4
      for (int k = 4; k < NA; k += 4)
        gru_a_quad<false>(w0, w1, w2, h0, h1, k, acc);
      clk.stamp(1);
      // the GRU-A epilogue in the plain version's order: ((cond_a + sig)
      // + pred) + exc, then the gates (sample_scan.sample_step)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z = sigmoidf(zrh[e][0] + (acc[e][0] + bra[0]));
        const float r = sigmoidf(zrh[e][1] + (acc[e][1] + bra[1]));
        const float hc = tanhf(zrh[e][2] + r * (acc[e][2] + bra[2]));
        const float hn = z * h_own[e] + (1.0f - z) * hc;
        h_own[e] = (active >> (q2 + e)) & 1u ? hn : h_own[e];
        ha_new[(q2 + e) * KPAD + unit] = h_own[e];
      }
    }
    __syncthreads();
    clk.stamp(2);

    // exchange: this CTA's 24 units of every stream to the 15 others
    for (int q = tid; q < (CLUSTER_L - 1) * TILE * (UNITS_L / 4);
         q += THREADS_L) {
      const int peer = q / (TILE * (UNITS_L / 4));
      const int s = (q / (UNITS_L / 4)) % TILE, v = q % (UNITS_L / 4);
      float* src = ha_new + s * KPAD + rank * UNITS_L + 4 * v;
      st_async_peer(src, *reinterpret_cast<const float4*>(src),
                    &bar_h[(i + 1) & 1], peer < rank ? peer : peer + 1);
    }
    if (tid == 0) mbar_wait<true>(&bar_h[(i + 1) & 1], (i >> 1) & 1);
    __syncthreads();
    // CTAs 0..KPART-1: wi_b slice `rank` of the GRU-B input product
    // (gru_b_input_partial's sums), to every CTA
    if (rank < KPART) {
      if (tid < TILE * G3B) {
        const int s = tid / G3B, o = tid % G3B;
        const float* hq = ha_new + s * KPAD + rank * KSLICE;
        float pa = hq[0] * s_wib[o];
        for (int kk = 1; kk < KSLICE; ++kk) pa += hq[kk] * s_wib[kk * G3B + o];
        s_part[(rank * TILE + s) * G3B + o] = pa;
      }
      __syncthreads();
      float* part = s_part + rank * TILE * G3B;
      for (int q = tid; q < (CLUSTER_L - 1) * (TILE * G3B / 4);
           q += THREADS_L) {
        const int peer = q / (TILE * G3B / 4), v = q % (TILE * G3B / 4);
        st_async_peer(part + 4 * v,
                      reinterpret_cast<const float4*>(part)[v], bar_p,
                      peer < rank ? peer : peer + 1);
      }
    }
    if (tid == 0) mbar_wait<true>(bar_p, i & 1);
    __syncthreads();
    clk.stamp(3);

    // C-E. GRU-B (replicated)
    gru_b_preact(s_part, s_cb, s_hb, s_wr_b, s_br_b, s_zrh_b, s_rec_b, tid);
    __syncthreads();
    gru_b_update(s_zrh_b, s_rec_b, s_hb, tid, active);
    __syncthreads();
    clk.stamp(4);

    // F. dual-FC logits
    if (T::TAIL) {
      dual_fc<THREADS_L>(s_hb, s_dfc_w, s_dfc_b, s_dfc_f, s_logits, tid);
      __syncthreads();
    }
    clk.stamp(5);

    // G. flat sampler
    if (T::TAIL && FLAT) {
      flat_compare<THREADS_L>(thr, s_logits, s_cmp, tid);
      __syncthreads();
      flat_pick<THREADS_L>(s_cmp, s_exc, tid);
      __syncthreads();
    }
    clk.stamp(6);

    // H. (stream threads) The next step's phase A runs on the same stream
    // threads and reads only what they wrote; every other shared buffer is
    // rewritten only after at least one more barrier, and a peer writes
    // this CTA's s_ha or s_part again only after this CTA has sent its
    // next states.
    if (stream_thread)
      phase_h<KIND, FLAT>(p, b0 + tid, tid, i, advance, forcing, mine,
                          writer, s_sig, s_logits, thr, s_exc, s_u2l, st);
    clk.stamp(7);
  }
  clk.finish(p.prof, ns);

  // ---- write the state back: GRU-A by the unit's CTA, the rest by CTA 0
  if (gru_thread) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (q2 + e < nvalid) p.gru_a_out[(b0 + q2 + e) * NA + unit] = h_own[e];
  }
  if (rank == 0) {
    if (tid < TILE * NB && tid / NB < nvalid)
      p.gru_b_out[b0 * NB + tid] = s_hb[tid];
    if (writer) store_stream<KIND>(p, b0 + tid, s_sig + tid * ORDER, st);
    if (rng_thread && rng_s < nvalid) store_rng(p, b0 + rng_s, rng);
  }
  __syncwarp();
  cluster.sync();   // no CTA leaves while its stores to a peer may fly
}

// GRU-A's sums of unit j over one chunk of the ring: rows k0..k0+ROWS-1
// of wr_a, read at columns j, j + NA, j + 2*NA; FIRST starts the sums from
// the k = 0 product. LDG: the rows are wr_a's own in global memory, read
// through the read-only path (the ablation without the ring).
template <bool FIRST, bool LDG = false>
__device__ __forceinline__ void gru_a_chunk(const float* rows,
                                            const float* s_ha, int k0,
                                            float (&acc)[TILE][3]) {
#pragma unroll
  for (int rr = 0; rr < RING_ROWS; ++rr) {
    const float w0 = LDG ? __ldg(rows + rr * G3A) : rows[rr * G3A];
    const float w1 = LDG ? __ldg(rows + rr * G3A + NA) : rows[rr * G3A + NA];
    const float w2 = LDG ? __ldg(rows + rr * G3A + 2 * NA)
                         : rows[rr * G3A + 2 * NA];
    const float4 ha = *reinterpret_cast<const float4*>(s_ha + (k0 + rr) * TILE);
    const float4 hb =
        *reinterpret_cast<const float4*>(s_ha + (k0 + rr) * TILE + 4);
    const float hv[TILE] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
    for (int s = 0; s < TILE; ++s) {
      if (FIRST && rr == 0) {
        acc[s][0] = hv[s] * w0;
        acc[s][1] = hv[s] * w1;
        acc[s][2] = hv[s] * w2;
      } else {
        acc[s][0] += hv[s] * w0;
        acc[s][1] += hv[s] * w1;
        acc[s][2] += hv[s] * w2;
      }
    }
  }
}

// ---- plan T: one CTA per tile, clusters of 2 sharing wr_a's chunks
template <int KIND, bool FLAT, bool PROF, bool BF16>
__global__ void __launch_bounds__(THREADS_T, 1)
sample_t_kernel(const LpcnetFrameParams p) {
  using T = Traits<KIND>;
  extern __shared__ __align__(128) float smem[];
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
  float* s_thr = smem + OFF_THR;        // [buffer][stream][level]
  float* s_sig = smem + OFF_SIG;        // [stream][lag]
  float* s_lpc = smem + OFF_LPC;        // [stream][coef]
  int* s_idx = reinterpret_cast<int*>(smem + OFF_IDX);
  int* s_exc = reinterpret_cast<int*>(smem + OFF_EXC);
  int* s_nact = reinterpret_cast<int*>(smem + OFF_NACT);
  unsigned char* s_cmp =
      reinterpret_cast<unsigned char*>(smem + OFF_CMP);
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  float* ring = reinterpret_cast<float*>(base + T_RING);  // [slot][row][col]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T_BARS);
  uint64_t* empty = full + RING_STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * TILE;
  const int nvalid = max(0, min(TILE, p.batch - b0));  // 0: a CTA that
  const int ns = T::NS_ARG ? p.nsamples : FS;         // only shares wr_a
  const bool tf_forcing = T::TF && p.target != nullptr;
  const bool forcing = T::TEACH || tf_forcing;
  const bool freezing = T::TF && p.n_active != nullptr;

  if (tid == 0) {
    for (int q = 0; q < RING_STAGES; ++q) {
      mbar_init(&full[q], 1);                          // own producer
      mbar_init(&empty[q], CLUSTER_T * (THREADS / 32));  // every consumer
    }                                                  // warp of the cluster
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < NA * G3B; i += THREADS_T) s_wi_b[i] = p.wi_b[i];
  stage_tail<KIND>(p, b0, nvalid, freezing, tid, THREADS_T, s_wr_b, s_br_b,
                   s_dfc_w, s_dfc_b, s_dfc_f, s_logit, s_cb, s_hb, s_sig,
                   s_lpc, s_nact);
  // GRU-A unit j = tid: its state and call condition stay in registers
  const int j = tid;
  float h_own[TILE], ca[TILE][3];
  float bra0 = 0.0f, bra1 = 0.0f, bra2 = 0.0f;
  if (tid < THREADS) {
#pragma unroll
    for (int s = 0; s < TILE; ++s) {
      const bool ok = s < nvalid;
      h_own[s] = ok ? p.gru_a_in[(b0 + s) * NA + j] : 0.0f;
      s_ha[j * TILE + s] = h_own[s];
#pragma unroll
      for (int g = 0; g < 3; ++g)
        ca[s][g] = ok ? p.cond_a[(b0 + s) * p.ca_stride + g * NA + j] : 0.0f;
    }
    bra0 = p.br_a[j];
    bra1 = p.br_a[NA + j];
    bra2 = p.br_a[2 * NA + j];
  }
  const bool stream_thread = tid < TILE;
  const bool writer = tid < nvalid;
  StreamState st = {{0u, 0u, 0u, 0u}, 0.0f, 0.0f, 0, 0, 0};
  if (writer) load_stream(p, b0 + tid, tf_forcing, st);
  // K5 'opt': RNG thread RNG_T0 + s draws stream s's thresholds
  const int rng_s = tid - RNG_T0;
  const bool rng_thread = T::PIPELINE && rng_s >= 0 && rng_s < TILE;
  uint32_t rng[4] = {0u, 0u, 0u, 0u};
  if (rng_thread && rng_s < nvalid) load_rng(p, b0 + rng_s, rng);
  __syncthreads();
  // the thresholds of sample 0, read first after the loop's barriers
  if (rng_thread) draw_thresholds(rng, s_logit, s_thr + rng_s * 8);
  cluster.sync();   // barriers initialised in both CTAs

  if (tid >= THREADS) {
    // the producer: one thread walks wr_a chunk by chunk, every step,
    // through the ring; it fetches its half of each chunk for both CTAs
    if (tid == THREADS && !T_ABLATE_RING) {
      const long long total = (long long)ns * CHUNKS;
      for (long long it = 0; it < total; ++it) {
        const int slot = (int)(it % RING_STAGES);
        const long long use = it / RING_STAGES;
        if (use > 0) mbar_wait<false>(&empty[slot], (unsigned)((use - 1) & 1));
        mbar_arrive_expect_tx(&full[slot], CHUNK_BYTES);
        const int row = (int)(it % CHUNKS) * RING_ROWS
                        + (int)rank * (RING_ROWS / CLUSTER_T);
        bulk_copy_multicast(
            ring + slot * CHUNK_FLOATS
                + (int)rank * (RING_ROWS / CLUSTER_T) * G3A,
            p.wr_a + (size_t)row * G3A, PIECE_BYTES, &full[slot],
            (uint16_t)((1u << CLUSTER_T) - 1u));
      }
    }
    __syncwarp();
  } else {
    PhaseClock<PROF> clk;
    clk.start(blockIdx.x == 0 && tid == 0);
    long long it = 0;                   // chunks consumed
    for (int i = 0; i < ns; ++i) {
      const unsigned active = active_mask(freezing, i, s_nact);
      const bool advance = (active >> (tid & (TILE - 1))) & 1u;

      // this sample's thresholds: K5 'opt' alternates two buffers
      float* thr = s_thr + (T::PIPELINE ? (i & 1) * TILE * 8 : 0);

      // A. prediction, mu-law inputs, thresholds (stream threads)
      if (stream_thread)
        phase_a<KIND>(tid, advance, s_sig, s_lpc, s_logit, s_idx, thr, st);
      consumer_sync();
      clk.stamp(0);

      // B. GRU-A from the ring
      float acc[TILE][3];
      for (int kc = 0; kc < CHUNKS; ++kc, ++it) {
        if (T_ABLATE_RING) {
          const float* rows = p.wr_a + (size_t)kc * CHUNK_FLOATS + j;
          if (kc == 0)
            gru_a_chunk<true, true>(rows, s_ha, 0, acc);
          else
            gru_a_chunk<false, true>(rows, s_ha, kc * RING_ROWS, acc);
          continue;
        }
        const int slot = (int)(it % RING_STAGES);
        mbar_wait<false>(&full[slot], (unsigned)((it / RING_STAGES) & 1));
        const float* rows = ring + slot * CHUNK_FLOATS + j;
        if (kc == 0)
          gru_a_chunk<true>(rows, s_ha, 0, acc);
        else
          gru_a_chunk<false>(rows, s_ha, kc * RING_ROWS, acc);
        __syncwarp();
        if ((tid & 31) == 0) {
#pragma unroll
          for (unsigned c = 0; c < CLUSTER_T; ++c)
            mbar_arrive_cluster(&empty[slot], c);
        }
      }
      clk.stamp(1);
      // the GRU-A epilogue in the plain version's order: ((cond_a + sig)
      // + pred) + exc, then the gates (sample_scan.sample_step)
#pragma unroll
      for (int s = 0; s < TILE; ++s) {
        const int* idx = s_idx + s * 4;
        const int ts = idx[0] * G3A + j;
        const int tp = idx[1] * G3A + j;
        const int te = idx[2] * G3A + j;
        float zrh[3];
#pragma unroll
        for (int g = 0; g < 3; ++g)
          zrh[g] = ((ca[s][g] + table_at<BF16>(p.tbl_sig, ts + g * NA))
                    + table_at<BF16>(p.tbl_pred, tp + g * NA))
                   + table_at<BF16>(p.tbl_exc, te + g * NA);
        const float z = sigmoidf(zrh[0] + (acc[s][0] + bra0));
        const float r = sigmoidf(zrh[1] + (acc[s][1] + bra1));
        const float hc = tanhf(zrh[2] + r * (acc[s][2] + bra2));
        const float hn = z * h_own[s] + (1.0f - z) * hc;
        h_own[s] = (active >> s) & 1u ? hn : h_own[s];
      }
      clk.stamp(2);
      consumer_sync();   // every consumer is done reading the old s_ha
#pragma unroll
      for (int s = 0; s < TILE; ++s) s_ha[j * TILE + s] = h_own[s];
      consumer_sync();
      clk.stamp(3);

      // C-E. GRU-B
      gru_b_input_partial(s_wi_b, s_ha, s_part, tid);
      consumer_sync();
      gru_b_preact(s_part, s_cb, s_hb, s_wr_b, s_br_b, s_zrh_b, s_rec_b, tid);
      consumer_sync();
      gru_b_update(s_zrh_b, s_rec_b, s_hb, tid, active);
      consumer_sync();
      clk.stamp(4);

      // F. dual-FC logits. K5 'opt': first the RNG threads, which have one
      // round less, draw the next sample's thresholds into the other
      // buffer, last read in phase H of sample i - 1
      if (rng_thread && i + 1 < ns)
        draw_thresholds(rng, s_logit,
                        s_thr + ((i + 1) & 1) * TILE * 8 + rng_s * 8);
      if (T::TAIL) {
        dual_fc<THREADS>(s_hb, s_dfc_w, s_dfc_b, s_dfc_f, s_logits, tid);
        consumer_sync();
      }
      clk.stamp(5);

      // G. flat sampler
      if (T::TAIL && FLAT) {
        flat_compare<THREADS>(thr, s_logits, s_cmp, tid);
        consumer_sync();
        flat_pick<THREADS>(s_cmp, s_exc, tid);
        consumer_sync();
      }
      clk.stamp(6);

      // H. (stream threads) as in plan L
      if (stream_thread)
        phase_h<KIND, FLAT>(p, b0 + tid, tid, i, advance, forcing, writer,
                            writer, s_sig, s_logits, thr, s_exc, s_u2l, st);
      clk.stamp(7);
    }
    clk.finish(p.prof, ns);

    // ---- write the state back
#pragma unroll
    for (int s = 0; s < TILE; ++s)
      if (s < nvalid) p.gru_a_out[(b0 + s) * NA + j] = h_own[s];
    if (tid < TILE * NB && tid / NB < nvalid)
      p.gru_b_out[b0 * NB + tid] = s_hb[tid];
    if (writer) store_stream<KIND>(p, b0 + tid, s_sig + tid * ORDER, st);
    if (rng_thread && rng_s < nvalid) store_rng(p, b0 + rng_s, rng);
  }
  // neither CTA leaves while the other may still arrive on its barriers
  cluster.sync();
}

// ---- launches
enum Plan : int { PLAN_L = 0, PLAN_T = 1 };

inline cudaLaunchConfig_t cluster_config(int grid, int threads, size_t smem,
                                         int cluster, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Readies both plans' kernels of one instance on the current device (their
// shared memory, plan L's 16-CTA clusters) and gives the smaller of *count
// and the number of plan-L clusters the card runs at once
// (cudaOccupancyMaxActiveClusters). The wrapper calls it for every
// instance once per device, before any launch there, and keeps the least
// count.
template <int KIND, bool FLAT, bool PROF, bool BF16 = false>
cudaError_t prepare_plans(int* count) {
  auto kernel_l = sample_l_kernel<KIND, FLAT, PROF, BF16>;
  auto kernel_t = sample_t_kernel<KIND, FLAT, PROF, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel_l, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel_l, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel_t, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      CLUSTER_L, THREADS_L, L_SMEM_BYTES, CLUSTER_L, 0, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel_l, &cfg);
  if (err != cudaSuccess) return err;
  if (n < *count) *count = n;
  return cudaSuccess;
}

// One launch under `plan` with `grid` CTAs (kernels/sample_cuda.py::
// launch_plan computes both from the batch and `clusters`, the card's
// count of co-resident plan-L clusters; the grid is checked here). A
// plan-L grid with more clusters than that is refused: plan L never runs
// in waves.
template <int KIND, bool FLAT, bool PROF, bool BF16 = false>
cudaError_t launch_sample(const LpcnetFrameParams* p, int plan, int grid,
                          int clusters, cudaStream_t stream) {
  const int tiles = (p->batch + TILE - 1) / TILE;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err;
  if (plan == PLAN_L) {
    if (grid != tiles * CLUSTER_L) return cudaErrorInvalidValue;
    if (tiles > clusters) return cudaErrorCooperativeLaunchTooLarge;
    cfg = cluster_config(grid, THREADS_L, L_SMEM_BYTES, CLUSTER_L, stream,
                         &attr);
    err = cudaLaunchKernelEx(&cfg, sample_l_kernel<KIND, FLAT, PROF, BF16>,
                             *p);
  } else {
    if (plan != PLAN_T
        || grid != (tiles + CLUSTER_T - 1) / CLUSTER_T * CLUSTER_T)
      return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(p->wr_a) % 16 != 0)
      return cudaErrorMisalignedAddress;         // bulk copies need 16 B
    cfg = cluster_config(grid, THREADS_T, T_SMEM_BYTES, CLUSTER_T, stream,
                         &attr);
    err = cudaLaunchKernelEx(&cfg, sample_t_kernel<KIND, FLAT, PROF, BF16>,
                             *p);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace lpcnet
