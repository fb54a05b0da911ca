// Fused <pf, ph, pw> parallelism search, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/mccm_eval/kernel.py::parallelism_search_call (body
// _search_kernel).  Same function as the plain PyTorch version
// repro_torch/kernels/mccm_eval/ref.py::parallelism_search_ref: for every
// design and each of its NC compute engines (CEs), over the static pair
// list <pf, ph> (P pairs), the PE budget pes/(pf*ph), the largest pw
// candidate <= floor(budget), the per-layer Eq. 1 cost
// ceil(F/pf)*CKK * ceil(OH/ph) * ceil(OW/pw) summed over the CE's layers,
// infeasible pairs (budget < 1) at inf, and the argmin over pairs with the
// first index winning ties.
//
// Design.  One block per design.  The block reads the design's PE split and
// the CE index of each of its layers (-1 for a layer mapped to no CE) once,
// and keeps them, the (NC, P) pw table and the (NC, P) cost accumulators in
// shared memory (2*NC*P*4 bytes: 28 KB at P = 219).
// Thread p owns pair p: it walks the layers in ascending order and adds
// each layer's cost into acc[ce(l)][p].  That is a fixed-order f32 sum
// without atomics, the order of the plain version, so the result is the
// same bit for bit and the same run to run.  fc_pair/coh_pair (L, P) are
// shared by every block and come from L2.  The argmin runs one warp per
// CE over <value, index> pairs.  No tensor cores: the contraction is a
// one-hot select, not a product.
//
// Numerics.  Every division, product and sum goes through the _rn
// intrinsics: correctly rounded, and never contracted into an FMA, which
// would round the product differently from the plain version.  Do not
// build with --use_fast_math: ceil(x/p) needs the correctly rounded
// quotient.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores).  Per design it reads NC*4 bytes of PEs and L*4 bytes of CE
// indices, writes 4*NC*4 bytes, and does about 5*P f32 operations (the
// division, the ceil, two multiplies, the add) for each layer that maps to
// a CE.  For ResNet-50 (53 such layers, padded to L = 160) at P = 219 that
// is 960 bytes and 58 kop a design: 0.29 ns of memory against 0.87 ns of
// arithmetic, so the operations bound it.  The shared (L, P) tables are
// read once per launch; every block after the first finds them in L2.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NC = 16;   // CEs per design (the encoding's NC)

__global__ void parallelism_search_kernel(
    const float* __restrict__ pes_ce,    // (B, NC)
    const int* __restrict__ ce_idx,      // (B, L), -1: no CE
    const float* __restrict__ fc_pair,   // (L, P)
    const float* __restrict__ coh_pair,  // (L, P)
    const float* __restrict__ ow,        // (L,)
    const float* __restrict__ cand,      // (K,) ascending
    const float* __restrict__ pair_prod, // (P,)
    const float* __restrict__ pair_pf,   // (P,)
    const float* __restrict__ pair_ph,   // (P,)
    float* __restrict__ pf_out, float* __restrict__ ph_out,
    float* __restrict__ pw_out, float* __restrict__ cost_out,  // (B, NC)
    int L, int P, int K) {
  extern __shared__ float smem[];
  float* s_pw = smem;                    // (NC, P) pw of each CE and pair
  float* s_acc = s_pw + NC * P;          // (NC, P) cost accumulators
  float* s_pes = s_acc + NC * P;         // (NC,)
  int* s_ce = reinterpret_cast<int*>(s_pes + NC);   // (L,)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  if (tid < NC) s_pes[tid] = pes_ce[b * NC + tid];
  const int* ce_row = ce_idx + static_cast<size_t>(b) * L;
  for (int l = tid; l < L; l += nthreads) s_ce[l] = ce_row[l];
  __syncthreads();

  // pw table: the largest candidate <= floor(pes / (pf*ph)), else cand[0]
  for (int i = tid; i < NC * P; i += nthreads) {
    const int c = i / P, p = i - c * P;
    const float flb = floorf(__fdiv_rn(s_pes[c], pair_prod[p]));
    float pw = cand[0];
    for (int k = 0; k < K; ++k)
      if (flb >= cand[k]) pw = cand[k];
    s_pw[i] = pw;
    s_acc[i] = 0.f;
  }
  __syncthreads();

  // per-layer costs, summed per CE in ascending layer order
  for (int p = tid; p < P; p += nthreads) {
    for (int l = 0; l < L; ++l) {
      const int c = s_ce[l];
      if (c < 0) continue;
      const float cow = ceilf(__fdiv_rn(ow[l], s_pw[c * P + p]));
      const float cost = __fmul_rn(
          __fmul_rn(fc_pair[l * P + p], coh_pair[l * P + p]), cow);
      s_acc[c * P + p] = __fadd_rn(s_acc[c * P + p], cost);
    }
  }
  __syncthreads();

  // argmin over pairs, one warp per CE; lower value wins, then lower index
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  for (int c = warp; c < NC; c += nwarps) {
    float best_v = CUDART_INF_F;
    int best_i = 0x7fffffff;
    for (int p = lane; p < P; p += 32) {
      const bool feasible = __fdiv_rn(s_pes[c], pair_prod[p]) >= 1.f;
      const float v = feasible ? s_acc[c * P + p] : CUDART_INF_F;
      if (v < best_v || (v == best_v && p < best_i)) {
        best_v = v;
        best_i = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      if (ov < best_v || (ov == best_v && oi < best_i)) {
        best_v = ov;
        best_i = oi;
      }
    }
    if (lane == 0) {
      const int o = b * NC + c;
      pf_out[o] = pair_pf[best_i];
      ph_out[o] = pair_ph[best_i];
      pw_out[o] = s_pw[c * P + best_i];
      cost_out[o] = best_v;
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Every
// pointer is device memory and contiguous; ce_idx is int32 with entries in
// [-1, NC), the rest float32; P >= 1, K >= 1, L >= 1.
int mccm_parallelism_search(
    const void* pes_ce, const void* ce_idx, const void* fc_pair,
    const void* coh_pair, const void* ow, const void* cand,
    const void* pair_prod, const void* pair_pf, const void* pair_ph,
    void* pf_out, void* ph_out, void* pw_out, void* cost_out,
    int B, int L, int P, int K, void* stream) {
  const int smem = static_cast<int>((2 * NC * P + NC) * sizeof(float) +
                                    L * sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        parallelism_search_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // one thread per pair, in whole warps (the argmin loops warps over CEs)
  int threads = ((P + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  parallelism_search_kernel<<<B, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pes_ce), static_cast<const int*>(ce_idx),
      static_cast<const float*>(fc_pair), static_cast<const float*>(coh_pair),
      static_cast<const float*>(ow), static_cast<const float*>(cand),
      static_cast<const float*>(pair_prod),
      static_cast<const float*>(pair_pf), static_cast<const float*>(pair_ph),
      static_cast<float*>(pf_out), static_cast<float*>(ph_out),
      static_cast<float*>(pw_out), static_cast<float*>(cost_out), L, P, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
