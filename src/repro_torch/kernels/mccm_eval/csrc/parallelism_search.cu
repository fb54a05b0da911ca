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
// Design.  A block stages the tables every design shares once, then
// evaluates designs one warp a design, striding over the batch.  The launch
// plan (ops.py::search_plan) picks the warps a block, the blocks and the
// staged rows R; the entry point checks the plan and refuses one it cannot
// run.
//  1. Staging.  The block finds the last layer among the first R that one
//     of its designs maps to a CE, and stores, for every layer up to it,
//     fc*coh (P floats, read 16 bytes a load: the product is formed once a
//     block, not once a design) and ceil(OW/cand[k]) for all K candidates
//     (the only division by a candidate, once a block).  Every net the
//     batch path pads to 160 layers is staged whole; a layer past R (only
//     where L*(P+K) floats pass 227 KB) is read from L2 and pays the
//     product and the division per term.  With at most 32 candidates, all
//     below LUT_N, it also tabulates pw's index for each floor of
//     pes/(pf*ph) below LUT_N.
//  2. Per design, CE by CE.  Lane t of the warp holds pairs p = 32*j + t,
//     NPL of them (the least of NPLS with 32*NPL >= P: the batch path's
//     lists of 219, 264, 312 and 324 pairs take 7, 9, 10 and 11; a longer
//     list is walked in groups of 352), and for each one quotient
//     pes/(pf*ph), its feasibility and its pw's index (one read of the
//     table, else a binary search).  The warp walks the CE's layers in
//     ascending order, 32 at a time from a ballot over the design's CE row,
//     and keeps one f32 sum a pair in registers: a term is two
//     shared-memory loads, a multiply and an add.  The argmin is two warp
//     reductions.  No shared-memory accumulator, no division in the walk.
//     Two kinds of CE need no walk:
//     one with 0 PEs is infeasible for every pair (0/x is never >= 1), so
//     it takes pair 0 at inf; one that owns no layer costs 0 for every
//     feasible pair, so it takes its first feasible pair at 0.  Lane c
//     keeps CE c's winner, and lanes 0..NC-1 write the design's row.
//
// Numerics.  Each (design, CE, pair) cost is ((0 + t_0) + t_1) + ... over
// the CE's layers in ascending order, each term (fc*coh)*ceil(OW/pw), and
// every product and sum an _rn intrinsic: the order and the roundings of
// the plain version, which adds the layers one at a time, so the costs are
// equal bit for bit.  Never contracted into an FMA (build with
// --fmad=false), never fast math.  Every quotient is the correctly rounded
// one, as the plain version's: ceil(OW/cand) and pes/(pf*ph) by
// __fdiv_rn.  No atomics on a sum, no tensor cores: the layer -> CE
// contraction is a one-hot select.  The argmin
// orders a NaN cost below every other, the first NaN winning, as
// torch.argmin does.  Where a term is not finite, the plain version's
// one-hot product carries it to the CEs that do not own its layer
// (x*0 is NaN there) and this kernel does not: bit equality holds where
// every term is finite, as on every table the batch path builds.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores).  Per design it reads NC*4 bytes of PEs and L*4 bytes of CE
// indices and writes 4*NC*4 bytes.  The function needs a multiply and an
// add for each (design, mapped layer, feasible pair of its CE): fc*coh
// and ceil(OW/cand) are tables that every design shares, and the quotient
// pes/(pf*ph), its floor and the argmin's compare come once a (design, CE,
// pair), not once a layer.  For a 2048-design ResNet-50 chunk (53 mapped
// layers, padded to L = 160, P = 219) that is about 2.3 MB and 30 M
// operations: bytes and operations are near even, about 0.0007 ms.  This
// design issues about 6 instructions per (design, mapped layer, pair),
// feasible or not, and a design's CEs run one after another in its warp:
// with 16 designs an SM and one warp each, the issue slots and the
// latency of each CE's quotient, search and argmin set its pace.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NC = 16;          // CEs per design (the encoding's NC)
constexpr int NPL_MAX = 11;     // pairs a lane holds: 352 pairs a group
constexpr int MAX_WARPS = 16;   // designs a block has in flight, a warp each
constexpr int SLACK = 32 * NPL_MAX;  // floats past the fc*coh rows, read by
                                     // lanes past P and discarded
constexpr int MAX_SMEM = 232448;     // dynamic shared memory a block may have
constexpr unsigned FULL = 0xffffffffu;
constexpr int BATCH = 8;        // loads a thread has in flight at a time
constexpr int LUT_N = 2048;     // floors the pw table covers (bytes)

// The CEs that own a layer of the design whose CE row is `row`, and one
// past its last layer that maps to a CE (0 if none), both warp-wide.
__device__ __forceinline__ void scan_row(const int* __restrict__ row, int L,
                                         int lane, unsigned& present,
                                         int& end) {
  present = 0u;
  end = 0;
  for (int w0 = 0; w0 < L; w0 += 32 * BATCH) {
    int c[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int l = w0 + 32 * u + lane;
      c[u] = l < L ? row[l] : -1;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (c[u] >= 0 && c[u] < NC) {
        present |= 1u << c[u];
        end = w0 + 32 * u + lane + 1;
      }
  }
  present = __reduce_or_sync(FULL, present);
  end = __reduce_max_sync(FULL, static_cast<unsigned>(end));
}

// Index of pw in cand (ascending) for each of a lane's N quotients q: the
// last candidate <= floor(q), else 0.  A NaN floor counts as above every
// candidate, as torch.searchsorted has it.  With the block's table (`lut`,
// built where there are at most 32 candidates, all below LUT_N) it is one
// shared-memory read a quotient: lut[v] is the index for a floor of v.
// Otherwise N binary searches over cand run step by step together (`top`
// is the largest power of two <= K).
template <int N>
__device__ __forceinline__ void pw_indices(const float (&q)[N], int (&kk)[N],
                                           const unsigned char* lut,
                                           const float* __restrict__ cand,
                                           int K, int top) {
  float fl[N];
#pragma unroll
  for (int j = 0; j < N; ++j) fl[j] = floorf(q[j]);
  if (lut) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      kk[j] = !(fl[j] < LUT_N) ? K - 1
              : fl[j] < 0.f    ? 0
                               : lut[static_cast<int>(fl[j])];
    return;
  }
  int n[N];  // candidates <= fl
#pragma unroll
  for (int j = 0; j < N; ++j) n[j] = 0;
  for (int s = top; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int t = n[j] + s;
      const float c = __ldg(cand + min(t, K) - 1);
      n[j] = t <= K && !(fl[j] < c) ? t : n[j];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) kk[j] = n[j] > 0 ? n[j] - 1 : 0;
}

// The float at shared-memory address `at`.
__device__ __forceinline__ float lds(unsigned at) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(at));
  return v;
}

// A cost as an unsigned key that orders as the cost does, a NaN below
// every other (key 0), and back, for the warp's reduction: key_cost(0) is
// a NaN.  (A sum that starts at +0 is never -0, the one value the keys
// part from the float order on.)
__device__ __forceinline__ unsigned cost_key(float v) {
  const unsigned u = __float_as_uint(v);
  return isnan(v) ? 0u : u & 0x80000000u ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float key_cost(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// A lane's best pair so far: its first pair, then a NaN cost over any
// but a NaN, else a lower cost.  A lane sees its pairs in ascending order,
// so of equal costs, and of NaNs, the first stays.
__device__ __forceinline__ void take_min(float v, int i, int k, bool first,
                                         float& bv, int& bi, int& bk) {
  if (first || (!(v >= bv) && !isnan(bv))) {
    bv = v;
    bi = i;
    bk = k;
  }
}

template <int NPL>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
parallelism_search_kernel(
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
    int B, int L, int P, int K, int R) {
  extern __shared__ float smem[];
  float* s_fcoh = smem;                     // (R, P) fc*coh, then SLACK
  float* s_cow = s_fcoh + R * P + SLACK;    // (R, K) ceil(OW/cand)
  int* s_rows = reinterpret_cast<int*>(s_cow + R * K);  // rows to stage
  unsigned char* s_lut = reinterpret_cast<unsigned char*>(s_rows + 1);
  const unsigned s_cow_at =
      static_cast<unsigned>(__cvta_generic_to_shared(s_cow));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int first = blockIdx.x * warps + warp, stride = gridDim.x * warps;
  const int top = 1 << (31 - __clz(K));
  const float cand_lane = cand[min(lane, K - 1)];
  const bool one_group = P <= 32 * NPL;
  // this warp's first design's PEs, loaded while the block stages
  float pes_lane =
      lane < NC && first < B ? pes_ce[static_cast<size_t>(first) * NC + lane]
                             : 0.f;
  // a lane's pf*ph, for the whole kernel when the pairs take one group
  float pr[NPL];
  const auto load_pairs = [&](int pb) {
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      pr[j] = pair_prod[min(pb + 32 * j + lane, P - 1)];
  };
  load_pairs(0);

  if (threadIdx.x == 0) *s_rows = 0;
  for (int i = threadIdx.x; i < SLACK; i += blockDim.x) s_fcoh[R * P + i] = 0.f;
  __syncthreads();
  // 1. stage the rows up to the last staged one a design of this block maps
  {
    int mapped = 0;
    for (int b = first; b < B; b += stride) {
      unsigned present;
      int end;
      scan_row(ce_idx + static_cast<size_t>(b) * L, L, lane, present, end);
      mapped = max(mapped, min(end, R));
    }
    if (lane == 0 && mapped > 0) atomicMax(s_rows, mapped);
  }
  __syncthreads();
  const int rows = *s_rows;
  const int n = rows * P;  // fc*coh, flat: the smem rows have L2's pitch
  int i0 = 0;
  if (((reinterpret_cast<uintptr_t>(fc_pair) |
        reinterpret_cast<uintptr_t>(coh_pair)) & 15) == 0) {
    const float4* f4 = reinterpret_cast<const float4*>(fc_pair);
    const float4* h4 = reinterpret_cast<const float4*>(coh_pair);
    float4* s4 = reinterpret_cast<float4*>(s_fcoh);
    const int n4 = n >> 2;
    for (int v0 = threadIdx.x; v0 < n4; v0 += blockDim.x * BATCH) {
      float4 a[BATCH], e[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int v = min(v0 + u * static_cast<int>(blockDim.x), n4 - 1);
        a[u] = f4[v];
        e[u] = h4[v];
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int v = v0 + u * blockDim.x;
        if (v < n4)
          s4[v] = make_float4(__fmul_rn(a[u].x, e[u].x),
                              __fmul_rn(a[u].y, e[u].y),
                              __fmul_rn(a[u].z, e[u].z),
                              __fmul_rn(a[u].w, e[u].w));
      }
    }
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x)
    s_fcoh[i] = __fmul_rn(fc_pair[i], coh_pair[i]);
  for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
    const int l = i / K;
    s_cow[i] = ceilf(__fdiv_rn(ow[l], cand[i - l * K]));
  }
  // the pw table: lut[v] = (candidates <= v) - 1, at least 0
  const bool use_lut = K <= 32 && __shfl_sync(FULL, cand_lane, K - 1) <
                                      static_cast<float>(LUT_N);
  if (use_lut) {
    for (int v0 = 32 * warp; v0 < LUT_N; v0 += blockDim.x) {
      const float v = static_cast<float>(v0 + lane);
      int c = 0;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float ck = __shfl_sync(FULL, cand_lane, k);
        c += k < K && !(v < ck);
      }
      s_lut[v0 + lane] = static_cast<unsigned char>(c > 0 ? c - 1 : 0);
    }
  }
  const unsigned char* lut = use_lut ? s_lut : nullptr;
  __syncthreads();

  // pw of a CE with 0 PEs: it takes pair 0, at 0/(pf*ph)
  int k_zero[1];
  {
    const float q[1] = {__fdiv_rn(0.f, pair_prod[0])};
    pw_indices<1>(q, k_zero, lut, cand, K, top);
  }

  // 2. one design a warp
  for (int b = first; b < B; b += stride) {
    const float pes_here = pes_lane;
    pes_lane = lane < NC && b + stride < B
                   ? pes_ce[static_cast<size_t>(b + stride) * NC + lane]
                   : 0.f;
    const int* row = ce_idx + static_cast<size_t>(b) * L;
    unsigned present;  // CEs that own a layer
    int end;
    scan_row(row, L, lane, present, end);
    const int chunks = (end + 31) >> 5;
    // lane c keeps CE c's winner: a CE with 0 PEs is infeasible for
    // every pair (0/x is never >= 1) and takes pair 0 at inf
    const bool zero = lane < NC && pes_here == 0.f;
    float out_v = CUDART_INF_F;
    int out_i = 0, out_k = k_zero[0];
    unsigned todo = __ballot_sync(FULL, lane < NC && !zero);
    while (todo) {
      const int c = __ffs(todo) - 1;
      todo &= todo - 1;
      const float pes = __shfl_sync(FULL, pes_here, c);
      float bv = CUDART_INF_F;
      int bi = INT_MAX, bk = 0;
      for (int pb = 0; pb < P; pb += 32 * NPL) {
        if (!one_group) load_pairs(pb);
        float q[NPL], acc[NPL];
        int kk[NPL];
        unsigned feas = 0u;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          q[j] = __fdiv_rn(pes, pr[j]);
          acc[j] = 0.f;
          feas |= pb + 32 * j + lane < P && q[j] >= 1.f ? 1u << j : 0u;
        }
        pw_indices<NPL>(q, kk, lut, cand, K, top);
        // shared-memory address of ceil(OW/cand[kk]) in layer 0's row
        unsigned cow_at[NPL];
#pragma unroll
        for (int j = 0; j < NPL; ++j) cow_at[j] = s_cow_at + 4u * kk[j];
        // a CE that owns no layer costs 0 on every pair, and a group with
        // no feasible pair inf throughout: neither walks
        if (((present >> c) & 1u) && __any_sync(FULL, feas != 0u)) {
          for (int w = 0; w < chunks; ++w) {
            const int l0 = 32 * w;
            const int cl = l0 + lane < L ? row[l0 + lane] : -1;
            unsigned m = __ballot_sync(FULL, cl == c);
            while (m) {
              const int l = l0 + __ffs(m) - 1;
              m &= m - 1;
              if (l < rows) {
                const float* f = s_fcoh + l * P + pb + lane;
                const unsigned t = 4u * static_cast<unsigned>(l * K);
#pragma unroll
                for (int j = 0; j < NPL; ++j)
                  acc[j] = __fadd_rn(acc[j],
                                     __fmul_rn(f[32 * j], lds(cow_at[j] + t)));
              } else {
                const size_t r = static_cast<size_t>(l) * P;
                const float o = ow[l];
#pragma unroll
                for (int j = 0; j < NPL; ++j) {
                  const int p = pb + 32 * j + lane;
                  if (p < P) {
                    const float fcoh =
                        __fmul_rn(fc_pair[r + p], coh_pair[r + p]);
                    const float cow = ceilf(__fdiv_rn(o, cand[kk[j]]));
                    acc[j] = __fadd_rn(acc[j], __fmul_rn(fcoh, cow));
                  }
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const int p = pb + 32 * j + lane;
          if (p < P)
            take_min((feas >> j) & 1u ? acc[j] : CUDART_INF_F, p, kk[j],
                     pb == 0 && j == 0, bv, bi, bk);
        }
      }
      // the warp's argmin: the least cost, then the least pair index
      // at it; the lane that holds that pair has its pw
      const unsigned key = cost_key(bv);
      const unsigned least = __reduce_min_sync(FULL, key);
      bi = static_cast<int>(__reduce_min_sync(
          FULL, key == least ? static_cast<unsigned>(bi) : UINT_MAX));
      bk = __shfl_sync(FULL, bk, bi & 31);
      if (lane == c) {
        out_v = key_cost(least);
        out_i = bi;
        out_k = bk;
      }
    }
    if (lane < NC) {
      const size_t o = static_cast<size_t>(b) * NC + lane;
      pf_out[o] = pair_pf[out_i];
      ph_out[o] = pair_ph[out_i];
      pw_out[o] = cand[out_k];
      cost_out[o] = out_v;
    }
  }
}

using Kernel = decltype(&parallelism_search_kernel<NPL_MAX>);

// One kernel for each count of pairs a lane holds that a pair list of the
// batch path needs, ascending; the last is NPL_MAX.
constexpr int NPLS[] = {7, 9, 10, 11};
const Kernel KERNELS[] = {
    parallelism_search_kernel<7>, parallelism_search_kernel<9>,
    parallelism_search_kernel<10>, parallelism_search_kernel<11>};
constexpr int N_KERNELS = sizeof(NPLS) / sizeof(NPLS[0]);

}  // namespace

extern "C" {

// Launch on `stream` under the plan of ops.py::search_plan: `warps` designs
// in flight a block, `blocks` blocks, the first `rows` layers staged, `npl`
// pairs a lane, `smem` bytes of shared memory.  Every pointer is device
// memory and contiguous; ce_idx is int32 (an entry outside [0, NC) maps its
// layer to no CE), the rest float32.  Returns a negative code for a plan it
// cannot run (nothing launched), else cudaGetLastError() (0 on success).
int mccm_parallelism_search(
    const void* pes_ce, const void* ce_idx, const void* fc_pair,
    const void* coh_pair, const void* ow, const void* cand,
    const void* pair_prod, const void* pair_pf, const void* pair_ph,
    void* pf_out, void* ph_out, void* pw_out, void* cost_out,
    int B, int L, int P, int K, int warps, int blocks, int rows, int npl,
    int smem, void* stream) {
  if (B < 1 || L < 1 || P < 1 || K < 1) return -1;
  int which = 0;  // the least NPLS that holds the list, else NPL_MAX
  while (which < N_KERNELS - 1 && 32 * NPLS[which] < P) ++which;
  if (npl != NPLS[which]) return -2;
  if (warps < 1 || warps > MAX_WARPS) return -3;
  if (rows < 0 || rows > L) return -4;
  const long long need =
      4LL * (static_cast<long long>(rows) * (P + K) + SLACK + 1) + LUT_N;
  if (smem != need || smem > MAX_SMEM) return -5;
  const long long per_block = (static_cast<long long>(B) + warps - 1) / warps;
  if (blocks < 1 || blocks > per_block) return -6;
  const Kernel kernel = KERNELS[which];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pes_ce), static_cast<const int*>(ce_idx),
      static_cast<const float*>(fc_pair), static_cast<const float*>(coh_pair),
      static_cast<const float*>(ow), static_cast<const float*>(cand),
      static_cast<const float*>(pair_prod),
      static_cast<const float*>(pair_pf), static_cast<const float*>(pair_ph),
      static_cast<float*>(pf_out), static_cast<float*>(ph_out),
      static_cast<float*>(pw_out), static_cast<float*>(cost_out), B, L, P, K,
      rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
