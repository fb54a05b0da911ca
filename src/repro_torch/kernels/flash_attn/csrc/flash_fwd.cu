// FlashAttention forward in f32 on Hopper's FMA units, hand-written for
// sm_90a.
//
// Replaces the Pallas kernel repro/kernels/flash_attn/kernel.py::flash_fwd
// (body _flash_fwd_kernel) and its GQA wrapper ops.py::flash_attention for
// f32 inputs (csrc/flash_fwd_bf16.cu is the bf16 route, on the tensor
// cores), and computes its function; so does the plain PyTorch version
// repro_torch/kernels/flash_attn/ref.py::flash_fwd_ref.  For every
// (batch, query head, query row), the online-softmax recurrence over tiles
// of keys, with
//   q·scale in f32, scores in f32 (here in log2 units: q is staged as
//   q·(scale·log2 e), rounded to f32, so exp(x) is exp2f of the scaled
//   score; exp2f is correctly computed to 2 ulp, subnormals kept: no
//   --use_fast_math, see _nvcc.NVCC_FLAGS),
//   the running max made -inf safe (m_safe = 0 where the max is -inf,
//   alpha = 0 where the old max is -inf),
//   p kept in f32 and p·v summed into an f32 accumulator,
//   l == 0 -> 1, so a row that no key may see gives 0,
//   the result written in f32.
// Masks: keys at or past the real Sk, causal (key <= q_offset + row) and a
// sliding window (key > q_offset + row - window).  Inputs f32, in the JAX
// package's layout q (B, Sq, H, D), k/v (B, Sk, Hkv, D), read through
// their strides (16-byte aligned rows: ops.readable); GQA by reading KV
// head h / (H / Hkv), never a repeated copy.  Output (B, Sq, H, D),
// contiguous.  No TF32: both products are f32 FMAs.
//
// Bound on an H100 SXM at Llama-3.2-1B's prefill shape (B 4, S 4096, 32
// query heads, 8 KV heads, D 64, causal): 4·D operations a visible (query,
// key) pair, 275 GFLOP, 4.1 ms at the 67 TFLOP/s of the f32 FMA units,
// against 336 MB of q, k, v and output, 0.1 ms: operations bound it, and
// an SM issues one warp instruction a cycle on each of its 4 schedulers,
// the same rate as its FMAs, so every instruction that is not an FMA (a
// load, a compare, an exp2f) costs an FMA's slot.
//
// So what keeps an FMA kernel from that rate is what it issues besides its
// FMAs (shared-memory loads for small register tiles, per-element copy
// and address arithmetic, mask compares and exp range reduction on every
// score) and copies whose latency no product hides.  The design below
// answers each.
//
// Design.  One CTA of 128 threads (4 warps) per (batch·head, 128 query
// rows), on a 1-D grid of ceil(Sq / 128)·B·H CTAs whose first CTAs take the
// last (for causal attention the heaviest) query tiles of every head.  Two
// CTAs an SM for D <= 96 (shared memory allows them; registers allow each
// thread up to 255 with two), one above.
// * A thread owns 8 query rows (a row group of 8 lanes shares them) and,
//   in each key tile, 8 keys of it (4 for D > 64, where the output tile
//   grows): an 8 x 8 score tile and an 8 x D/8 output tile in registers,
//   with m and its share of l for its 8 rows.
// * q·scale·log2 e is staged once a CTA, d-major (Qt[d][row]), so a
//   thread's 8 rows are two float4 loads.  K tiles are staged row-major
//   with their 16-byte pieces swizzled (piece c of key j at c ^ (j % 8))
//   where a row has a multiple of 8 pieces, padded by one piece otherwise,
//   so the 8 keys a row group reads, j = tx + 8c, hit 8 distinct bank
//   groups.  Q·Kᵀ, per 4 of D: 8 float4 loads of K, then per d 2 of Q, for
//   8·8·4 = 256 FMAs: one load per 16 FMAs.  Shared-memory wavefronts
//   (a wavefront moves 128 bytes; an SM serves one a cycle and issues 4
//   warp-FMAs a cycle): each K load is 8 distinct 16-byte pieces in 8 bank
//   groups, each Q load 4 row groups' pieces in 4, one wavefront each, so
//   16 wavefronts per 256 warp-FMAs, 1/16 against the 1/4 an SM can serve.
// * K/V ring: 2 stages, filled by 16-byte cp.async.cg (keys past Sk arrive
//   as zeros: src-size 0).  A thread copies one fixed 16-byte column of
//   every CR-th row (CR = 128 / (D / 4)), stepping its row pointers by a
//   fixed stride, so a piece costs a pointer step and a compare, not a
//   64-bit row product.  At the top of tile j every thread waits for its
//   own copies and the CTA meets at one __syncthreads(), after which tile
//   j + 1 is issued into the stage tile j - 1 used: its copy is in flight
//   during tile j's products.  One block-wide barrier a tile.
// * A tile that no real row of a warp may see (causal, window) leaves that
//   warp's state exactly as it is, and the warp skips it.  Only a tile that
//   some row of the warp does not see whole (the causal diagonal, the
//   window's lower edge, keys past Sk) is masked, two compares a score
//   against the row's visible key interval; interior tiles go straight to
//   the softmax.
// * Softmax: the row max over the row group by 3 shuffles; p = exp2f(s -
//   m_safe) (a masked score is -inf, its p exactly 0); each thread keeps
//   the sum of its own p, scaled by alpha like the accumulator, and the 8
//   shares of a row are added once, at the end.
// * P·V: p goes to shared memory key-major (Pt[key][row], rows padded by 4
//   floats), 32 keys at a time; only the warp that wrote a row reads it,
//   so a __syncwarp() orders them, not the CTA.  Per key: 2 float4 loads
//   of p (8 rows) and D/32 float4 (D/16 float2) loads of V along D, for
//   8·D/8 FMAs: at D = 64, 4 loads and 4 wavefronts per 64 FMAs.
// * Epilogue: l summed over the row group, acc / l by IEEE division,
//   float4 (float2) stores, contiguous.
// Shared memory a CTA: 4·(D·128 + 32·132 + 2·(BK·KS + BK·D)) bytes, BK
// keys a tile (64 for D <= 64, else 32), KS the K row stride: 115,200 at
// D = 64, two CTAs in the SM's 233,472 with their 1 KB reserves.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;     // 4 warps
constexpr int BQ = 128;          // query rows a CTA
constexpr int RPT = 8;           // rows a thread
constexpr int TPR = 8;           // threads (lanes) a row group
constexpr int STAGES = 2;        // K/V ring
constexpr int PK = 32;           // keys of p staged at once
constexpr int PS = BQ + 4;       // row stride of the p chunk
constexpr int SM_SMEM = 233472;  // shared memory of an SM
constexpr int CTA_RESERVE = 1024;

static_assert(THREADS == BQ / RPT * TPR, "a row group a row of 8 threads");

__host__ __device__ constexpr int keys_a_tile(int D) {
  return D <= 64 ? 64 : 32;
}
__host__ __device__ constexpr bool swizzled(int D) {
  return (D / 4) % 8 == 0;
}
// row stride of a K tile: padded by one 16-byte piece where the swizzle
// does not apply
__host__ __device__ constexpr int k_stride(int D) {
  return swizzled(D) ? D : D + 4;
}
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return sizeof(float) * (size_t(D) * BQ + size_t(PK) * PS
                          + size_t(STAGES) * keys_a_tile(D)
                                * (k_stride(D) + D));
}
__host__ __device__ constexpr int ctas_per_sm(int D) {
  return 2 * (smem_bytes(D) + CTA_RESERVE) <= size_t(SM_SMEM) ? 2 : 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float lane4(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// VW floats along D: a float4 or a float2
template <int VW> struct Vec;
template <> struct Vec<4> {
  typedef float4 T;
  __device__ static float get(const float4& x, int i) { return lane4(x, i); }
};
template <> struct Vec<2> {
  typedef float2 T;
  __device__ static float get(const float2& x, int i) {
    return i == 0 ? x.x : x.y;
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, ctas_per_sm(D))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Sq,
                 int Sk, int H, int BH, int rep, int n_qt, long long qsb,
                 long long qss, long long qsh, long long ksb, long long kss,
                 long long ksh, long long vsb, long long vss, long long vsh,
                 int causal, int has_window, int window, int q_offset,
                 float scale) {
  constexpr int BK = keys_a_tile(D);
  constexpr int KPT = BK / TPR;           // keys a thread: 8 or 4
  constexpr int C4 = D / 4;               // 16-byte pieces of a row
  constexpr int KS = k_stride(D);
  constexpr int CPT = D / TPR;            // output columns a thread
  constexpr int VW = CPT % 4 == 0 ? 4 : 2;
  constexpr int NV = CPT / VW;
  constexpr int NCH = BK / PK;            // p chunks a tile
  constexpr int KPC = PK / TPR;           // a thread's keys a chunk: 4
  // pieces of D in Q·Kᵀ and keys in P·V whose loads are issued together:
  // fewer where the output tile takes most registers (at D 128 more spill)
  constexpr int CU = D > 96 ? 1 : 2;
  constexpr int JU = D > 96 ? 2 : 4;
  typedef typename Vec<VW>::T VT;

  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // D x BQ
  float* Pt = Qt + D * BQ;                       // PK x PS
  float* Ks = Pt + PK * PS;                      // STAGES x BK x KS
  float* Vs = Ks + STAGES * BK * KS;             // STAGES x BK x D

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = tid >> 3, tx = tid & 7;   // row group, lane in it
  // the first CTAs take the last query tile of every (batch, head)
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H, hk = h / rep;
  const int q0 = qt * BQ;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  // keys any row of this CTA may see (ref.py::kv_range)
  const int qa_lo = q0 + q_offset;
  const int qa_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, qa_hi + 1) : Sk;
  const int k_lo = has_window ? max(0, qa_lo - window + 1) : 0;
  const int k_first = k_lo / BK * BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_first + BK - 1) / BK : 0;

  // The copies of a tile: thread tid takes the 16-byte piece cc = tid % C4
  // of rows cr, cr + CR, ... (CR = THREADS / C4 rows a round; threads past
  // CR·C4 copy nothing), so a warp's pieces lie side by side in memory and
  // a thread steps its row pointers by a fixed stride.  Rows past Sk
  // arrive as zeros, read from nowhere (the tile's first row, which
  // exists, stands in as the address).
  constexpr int CR = THREADS / C4;
  constexpr int ROUNDS = (BK + CR - 1) / CR;
  const int cr = tid / C4, cc = tid % C4;
  const bool copier = cr < CR;
  // where CR is a multiple of 8, every row a thread copies has one swizzle
  const int pc0 = swizzled(D) ? cc ^ (cr & 7) : cc;
  auto load_tile = [&](int it) {
    const int k0 = k_first + it * BK;
    float* kd = Ks + (it % STAGES) * BK * KS + cr * KS;
    float* vd = Vs + (it % STAGES) * BK * D + cr * D + 4 * cc;
    const float* k_row0 = kb + k0 * kss + 4 * cc;
    const float* v_row0 = vb + k0 * vss + 4 * cc;
    const float* ks = k_row0 + cr * kss;
    const float* vs = v_row0 + cr * vss;
    const int rows = min(BK, Sk - k0) - cr;   // this thread's rows that exist
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      if (copier && (CR * (r + 1) <= BK || cr + CR * r < BK)) {
        const bool in = CR * r < rows;
        const int pc = CR % 8 == 0 || !swizzled(D)
                           ? pc0 : cc ^ ((cr + CR * r) & 7);
        cp_async16(kd + CR * r * KS + 4 * pc, in ? ks : k_row0, in ? 16 : 0);
        cp_async16(vd + CR * r * D, in ? vs : v_row0, in ? 16 : 0);
      }
      ks += CR * kss;
      vs += CR * vss;
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_tile(0);
  // scores in log2 units: exp(x) = exp2(x·log2 e), so q is staged as
  // q·scale·log2 e, d-major; rows past Sq are zeros (never written out)
  const float scale2 = __fmul_rn(scale, 1.4426950408889634f);
  for (int e = tid; e < BQ * C4; e += THREADS) {
    const int i = e % BQ, c = e / BQ;
    const int qi = q0 + i;
    const float4 x = qi < Sq
        ? *reinterpret_cast<const float4*>(qb + qi * qss + 4 * c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    Qt[(4 * c + 0) * BQ + i] = __fmul_rn(x.x, scale2);
    Qt[(4 * c + 1) * BQ + i] = __fmul_rn(x.y, scale2);
    Qt[(4 * c + 2) * BQ + i] = __fmul_rn(x.z, scale2);
    Qt[(4 * c + 3) * BQ + i] = __fmul_rn(x.w, scale2);
  }

  float acc[RPT][CPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < CPT; ++n) acc[r][n] = 0.f;
  }

  // absolute positions of the warp's first and last real row
  const int wrow = q0 + 32 * warp;
  const bool warp_real = wrow < Sq;
  const int wa_lo = wrow + q_offset;
  const int wa_hi = min(wrow + 31, Sq - 1) + q_offset;
  const float* Qg = Qt + RPT * g;         // this thread's rows
  float* Pg = Pt + RPT * g;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();    // tile it has landed; tile it - 1's stage is free
    if (it + 1 < n_tiles) load_tile(it + 1);
    const int k0 = k_first + it * BK;
    // a tile that no real row of the warp may see leaves its state
    // exactly as it is (p = 0, alpha = 1, or 0 on a zero state)
    const bool seen = warp_real && (!causal || k0 <= wa_hi)
                      && (!has_window || k0 + BK - 1 > wa_lo - window);
    if (!seen) continue;
    const float* Kt = Ks + (it % STAGES) * BK * KS;
    const float* Vt = Vs + (it % STAGES) * BK * D;

    // S = (q·scale·log2 e)·Kᵀ: rows 8g + r, keys tx + 8c
    float s[RPT][KPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < KPT; ++c) s[r][c] = 0.f;
    const float* Kx = Kt + tx * KS;
#pragma unroll 1
    for (int c40 = 0; c40 < C4; c40 += CU)
#pragma unroll
    for (int c4 = c40; c4 < c40 + CU; ++c4) {
      const int pc = swizzled(D) ? c4 ^ tx : c4;
      float4 kf[KPT];
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        kf[c] = *reinterpret_cast<const float4*>(Kx + 8 * c * KS + 4 * pc);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float* qr = Qg + (4 * c4 + dd) * BQ;
        const float4 qa = *reinterpret_cast<const float4*>(qr);
        const float4 qz = *reinterpret_cast<const float4*>(qr + 4);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float a = r < 4 ? lane4(qa, r) : lane4(qz, r - 4);
#pragma unroll
          for (int c = 0; c < KPT; ++c)
            s[r][c] = fmaf(a, lane4(kf[c], dd), s[r][c]);
        }
      }
    }

    // masks, only on a tile that some real row of the warp does not see
    // whole: row r may see the tile's keys [lo, hi]
    const bool whole = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= wa_lo)
                       && (!has_window || k0 > wa_hi - window);
    if (!whole) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int qa = q0 + RPT * g + r + q_offset;
        const int hi = (causal ? min(Sk - 1, qa) : Sk - 1) - k0;
        const int lo = has_window ? qa - window + 1 - k0 : 0;
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          const int j = tx + 8 * c;
          if (j < lo || j > hi) s[r][c] = -INFINITY;
        }
      }
    }

    // online softmax in log2 units
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      float tmax = s[r][0];
#pragma unroll
      for (int c = 1; c < KPT; ++c) tmax = fmaxf(tmax, s[r][c]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[r], tmax);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha =
          m[r] == -INFINITY ? 0.f : exp2f(__fsub_rn(m[r], m_safe));
      m[r] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        s[r][c] = exp2f(__fsub_rn(s[r][c], m_safe));
        psum = __fadd_rn(psum, s[r][c]);
      }
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), psum);
#pragma unroll
      for (int n = 0; n < CPT; ++n) acc[r][n] = __fmul_rn(acc[r][n], alpha);
    }

    // O += P·V, PK keys at a time through the warp's rows of Pt
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      __syncwarp();     // the warp's reads of the last chunk are done
#pragma unroll
      for (int c = 0; c < KPC; ++c) {
        float* dst = Pg + (tx + 8 * c) * PS;
        const int sc = ch * KPC + c;
        *reinterpret_cast<float4*>(dst) =
            make_float4(s[0][sc], s[1][sc], s[2][sc], s[3][sc]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(s[4][sc], s[5][sc], s[6][sc], s[7][sc]);
      }
      __syncwarp();
      const float* Vc = Vt + ch * PK * D + tx * VW;
#pragma unroll 1
      for (int j0 = 0; j0 < PK; j0 += JU)
#pragma unroll
      for (int j = j0; j < j0 + JU; ++j) {
        const float4 pa = *reinterpret_cast<const float4*>(Pg + j * PS);
        const float4 pz = *reinterpret_cast<const float4*>(Pg + j * PS + 4);
        VT vv[NV];
#pragma unroll
        for (int n = 0; n < NV; ++n)
          vv[n] = *reinterpret_cast<const VT*>(Vc + j * D + n * TPR * VW);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float p = r < 4 ? lane4(pa, r) : lane4(pz, r - 4);
#pragma unroll
          for (int n = 0; n < NV; ++n)
#pragma unroll
            for (int e = 0; e < VW; ++e)
              acc[r][n * VW + e] =
                  fmaf(p, Vec<VW>::get(vv[n], e), acc[r][n * VW + e]);
        }
      }
    }
  }

  // l over the row group, then acc / l, written contiguous
  const long long osh = D, oss = static_cast<long long>(H) * D;
  const long long osb = oss * Sq;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float lt = l[r];
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 4));
    const int qi = q0 + RPT * g + r;
    if (qi >= Sq) continue;
    const float denom = lt == 0.f ? 1.f : lt;
    float* o = out + b * osb + qi * oss + h * osh + tx * VW;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      float w[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) w[e] = acc[r][n * VW + e] / denom;
      VT val;
      if constexpr (VW == 4) {
        val = make_float4(w[0], w[1], w[2], w[3]);
      } else {
        val = make_float2(w[0], w[1]);
      }
      *reinterpret_cast<VT*>(o + n * TPR * VW) = val;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, long long qsb, long long qss,
           long long qsh, long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, int causal,
           int has_window, int window, int q_offset, float scale,
           cudaStream_t s) {
  auto kern = flash_fwd_kernel<D>;
  constexpr size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Sq + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(n_qt) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H,
      B * H, H / Hkv, n_qt, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
      causal, has_window, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error of the launch (0 on success).
// q, k, v: float32 device memory, element strides (batch, sequence, head)
// given, the head dimension contiguous, every base address 16-byte aligned
// and every stride of a dimension longer than 1 a multiple of 4 elements
// (the 16-byte copies' rule); out: contiguous (B, Sq, H, D) float32.  The
// caller checks the shapes: B, Sq >= 1, Sk >= 0, H a multiple of Hkv,
// ceil(Sq / 128)·B·H < 2**31, D a multiple of 16 in [16, 128].
int flash_fwd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int Hkv, int D, long long qsb,
              long long qss, long long qsh, long long ksb, long long kss,
              long long ksh, long long vsb, long long vss, long long vsh,
              int causal, int has_window, int window, int q_offset,
              float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(DIM)                                                     \
  case DIM:                                                                 \
    return launch<DIM>(q, k, v, out, B, Sq, Sk, H, Hkv, qsb, qss, qsh, ksb, \
                       kss, ksh, vsb, vss, vsh, causal, has_window, window, \
                       q_offset, scale, s);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

// The CTA of a launch at head dim D: plan[0..6] = threads, query rows,
// keys a tile, stages of the K/V ring, dynamic shared-memory bytes, CTAs an
// SM (the launch bound), and the most CTAs a launch may have: the grid is
// one-dimensional, ceil(Sq / rows)·B·H CTAs, the last query tiles first.
// Returns 0, or cudaErrorInvalidValue for a D the kernel does not take.
int flash_fwd_f32_plan(int D, int* plan) {
  if (D < 16 || D > 128 || D % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = THREADS;
  plan[1] = BQ;
  plan[2] = keys_a_tile(D);
  plan[3] = STAGES;
  plan[4] = static_cast<int>(smem_bytes(D));
  plan[5] = ctas_per_sm(D);
  plan[6] = 0x7fffffff;
  return 0;
}

}  // extern "C"
