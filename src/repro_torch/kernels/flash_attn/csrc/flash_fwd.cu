// FlashAttention forward in f32, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attn/kernel.py::flash_fwd
// (body _flash_fwd_kernel) and its GQA wrapper ops.py::flash_attention for
// f32 inputs (csrc/flash_fwd_bf16.cu is the bf16 route, on the tensor
// cores), and computes its function; so does the plain PyTorch version
// repro_torch/kernels/flash_attn/ref.py::flash_fwd_ref.  For every
// (batch, query head, query row), the online-softmax recurrence over tiles
// of keys, with
//   q·scale in f32, scores in f32,
//   the running max made -inf safe (m_safe = 0 where the max is -inf,
//   alpha = 0 where the old max is -inf),
//   p kept in f32 and p·v summed into an f32 accumulator (the Pallas body
//   widens v to f32 before its p.astype(v.dtype), so p is never rounded;
//   the JAX model code's jnp twin, layers.py::chunked_attention, does
//   round p to v's type in bf16 and so differs from both),
//   l == 0 -> 1, so a row that no key may see gives 0,
//   the result written in f32.
// Masks: keys at or past the real Sk, causal (key <= q_offset + row) and a
// sliding window (key > q_offset + row - window).  Inputs f32, in the JAX
// package's layout q (B, Sq, H, D), k/v (B, Sk, Hkv, D), read
// through their strides; GQA by reading KV head h / (H / Hkv), never a
// repeated copy.  Output (B, Sq, H, D), contiguous.
//
// Design.  One block of 256 threads per (batch·head, tile of 64 query
// rows).  The block stages q·scale for its rows in shared memory once, then
// walks the key tiles its rows may see (tiles that the causal or window
// mask hides from all 64 rows are skipped: they leave the recurrence's
// state unchanged).  Each key tile (64 keys of K and V) is staged in
// shared memory; the 16 x 16 threads compute the 64 x 64 score
// tile as 4 x 4 register tiles (rows ty + 16 r, keys tx + 16 c, float4
// loads along D), reduce row max and row sum across the 16 threads of a
// row with warp shuffles, keep m and l in registers, write p to shared
// memory and add p·V into a 4 x D/16 register accumulator per thread
// (columns tx + 16 n).  Shared memory is (2·64·(D+4) + 64·D + 64·80)·4
// bytes: 70 KB at D = 64, 117 KB at D = 128.  The kernel is instantiated for
// D = 16, 32, ..., 128.
//
// Bound on an H100 SXM at Llama-3.2-1B's prefill shape (B = 4, S = 4096,
// 32 query heads, 8 KV heads, D = 64, causal): 2·2·B·H·D·S²/2 ≈ 275 GFLOP,
// 4.1 ms at the 67 TFLOP/s of the f32 FMA units, against 336 MB of q, k,
// v and output, 0.1 ms: operations bound it.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int RPT = BQ / 16;    // rows per thread
constexpr int KPT = BK / 16;    // keys per thread
constexpr int PS = BK + 16;     // row stride of the p tile: the two rows a
                                // warp touches fall 16 banks apart

template <int NC>
constexpr size_t smem_bytes() {
  constexpr int D = 16 * NC;
  return sizeof(float) * (size_t(BQ) * (D + 4) + size_t(BK) * (D + 4)
                          + size_t(BK) * D + size_t(BQ) * PS);
}

template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Sq,
                 int Sk, int H, int rep, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, int causal,
                 int has_window, int window, int q_offset, float scale) {
  constexpr int D = 16 * NC;
  constexpr int DP = D + 4;     // padded row of the q and k tiles: float4
                                // reads of 8 neighbouring rows hit 32 banks
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x DP, q·scale
  float* Ks = Qs + BQ * DP;                       // BK x DP
  float* Vs = Ks + BK * DP;                       // BK x D
  float* Ps = Vs + BK * D;                        // BQ x PS

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / rep;
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int i = e / D, d = e % D;
    const int qi = q0 + i;
    Qs[i * DP + d] =
        qi < Sq ? __fmul_rn(qb[qi * qss + d], scale) : 0.f;
  }

  float acc[RPT][NC];
  float m[RPT], l[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[r][n] = 0.f;
  }

  // keys any row of this tile may see (ref.py::kv_range)
  const int qa_lo = q0 + q_offset;
  const int qa_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, qa_hi + 1) : Sk;
  const int k_lo = has_window ? max(0, qa_lo - window + 1) : 0;

  for (int k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();            // the last tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D;
      const int kj = k0 + j;
      const bool in = kj < Sk;
      Ks[j * DP + d] = in ? kb[kj * kss + d] : 0.f;
      Vs[j * D + d] = in ? vb[kj * vss + d] : 0.f;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < KPT; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[RPT], kk[KPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        a[r] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * r) * DP + d);
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        kk[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * DP + d);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          s[r][c] = fmaf(a[r].x, kk[c].x, s[r][c]);
          s[r][c] = fmaf(a[r].y, kk[c].y, s[r][c]);
          s[r][c] = fmaf(a[r].z, kk[c].z, s[r][c]);
          s[r][c] = fmaf(a[r].w, kk[c].w, s[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qa = q0 + ty + 16 * r + q_offset;
      bool ok[KPT];
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int kj = k0 + tx + 16 * c;
        ok[c] = kj < Sk && (!causal || kj <= qa)
                && (!has_window || kj > qa - window);
        if (ok[c]) tmax = fmaxf(tmax, s[r][c]);
      }
      // the 16 threads of a row are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[r], tmax);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_safe) : 0.f;
        psum += p;
        Ps[(ty + 16 * r) * PS + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = m[r] == -INFINITY ? 0.f : expf(m[r] - m_safe);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[r][n] *= alpha;
    }
    __syncthreads();            // the p tile is complete

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 p[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        p[r] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * r) * PS + j);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float v0 = Vs[(j + 0) * D + tx + 16 * n];
        const float v1 = Vs[(j + 1) * D + tx + 16 * n];
        const float v2 = Vs[(j + 2) * D + tx + 16 * n];
        const float v3 = Vs[(j + 3) * D + tx + 16 * n];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          acc[r][n] = fmaf(p[r].x, v0, acc[r][n]);
          acc[r][n] = fmaf(p[r].y, v1, acc[r][n]);
          acc[r][n] = fmaf(p[r].z, v2, acc[r][n]);
          acc[r][n] = fmaf(p[r].w, v3, acc[r][n]);
        }
      }
    }
  }

  const long long osh = D, oss = static_cast<long long>(H) * D;
  const long long osb = oss * Sq;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    float* o = out + b * osb + qi * oss + h * osh;
#pragma unroll
    for (int n = 0; n < NC; ++n) o[tx + 16 * n] = acc[r][n] / denom;
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, long long qsb, long long qss,
           long long qsh, long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, int causal,
           int has_window, int window, int q_offset, float scale,
           cudaStream_t s) {
  auto kern = flash_fwd_kernel<NC>;
  constexpr size_t smem = smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H,
      H / Hkv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
      has_window, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error of the launch (0 on success).
// q, k, v: float32 device memory, element strides (batch, sequence, head)
// given, the head dimension contiguous; out: contiguous (B, Sq, H, D)
// float32.  The caller checks the shapes: B, Sq >= 1, Sk >= 0, H a
// multiple of Hkv, B * H <= 65535, D a multiple of 16 in [16, 128].
int flash_fwd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int Hkv, int D, long long qsb,
              long long qss, long long qsh, long long ksb, long long kss,
              long long ksh, long long vsb, long long vss, long long vsh,
              int causal, int has_window, int window, int q_offset,
              float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(NC)                                                      \
  case 16 * NC:                                                             \
    return launch<NC>(q, k, v, out, B, Sq, Sk, H, Hkv, qsb, qss, qsh, ksb, \
                      kss, ksh, vsb, vss, vsh, causal, has_window, window, \
                      q_offset, scale, s);
  switch (D) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // extern "C"
