// A compute engine (CE) as a tiled direct convolution whose launch grid is
// the paper's Eq. 1, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/conv_ce/kernel.py::conv_ce_call
// (body _conv_kernel).  Same function as the plain PyTorch version
// repro_torch/kernels/conv_ce/ref.py::conv_ref: a valid-padding convolution
// x (C, H, W) * w (F, C, KH, KW) -> out (F, OH, OW) at one stride, inputs
// f32 or bf16, each output one f32 sum of x*w over (c, kh, kw) in
// ascending order, written in the input's type.
//
// Contract.  The CE's parallelism vector <par_f, par_oh, par_ow> is the
// output tile and one block computes one tile, so the grid is
//   (ceil(F/par_f), ceil(OH/par_oh), ceil(OW/par_ow))
// and grid size * C*KH*KW is Eq. 1's cycle count (ops.grid_size,
// ops.predicted_cycles); the launch reports the grid it used.  Each output
// is one f32 accumulator in one thread, adding __fmul_rn(x, w) with
// __fadd_rn in (c, kh, kw) order (no FMA: the build passes --fmad=false;
// no tensor cores, whose sums have their own order), so the kernel equals
// the plain version bit for bit.
//
// Bound on an H100 SXM: operations.  One ResNet-50 pass is 4.087 GMAC:
// 0.122 ms at the card's f32 rate (67 TFLOP/s, a MAC one FMA), 0.244 ms at
// the rate this contract allows (a multiply and an add issued apart on 132
// SMs x 128 lanes at 1.98 GHz); its inputs, weights and outputs are about
// 0.2 GB, 0.06 ms.  The grid adds its own floor: a block runs on one SM, so
// a layer of fewer blocks than SMs leaves SMs idle.
//
// Design.  The launch plan (ops.launch_plan, checked here) gives each
// thread a register tile of RF filters x RH rows x RW columns of outputs,
// a block of `threads` (whole warps, at most 1024; 512 past 4 outputs a
// thread) laid out as tf x th x tw thread groups, and a channel chunk Cc.
// Thread t has
//   gw = t % tw, gh = (t / tw) % th, gf = t / (tw * th)
// and owns the tile-local outputs
//   (gf*RF + i, gh + j*th, gw + k*tw),  i < RF, j < RH, k < RW,
// so the threads cover the tile once; those past the tile or the layer's
// edge are computed and never stored (the ragged tail is masked here, and
// nothing is padded in global memory).  A first kernel transposes w into
// the caller's scratch wt, (C*KH*KW, F), so that a (c, kh, kw) row of the
// tile's filters is one contiguous run.  Then for each chunk of Cc
// channels the block stages, double-buffered, into shared memory:
//   * the tile's weights, (c, kh, kw, f), filter fastest, rows f_pitch
//     floats apart: a thread's RF weights are one vector load, and a
//     broadcast to the threads of one filter group;
//   * the tile's input window, ((th*RH-1)*s + KH) rows x ((tw*RW-1)*s + KW)
//     columns, each row split by column phase (column col at
//     (col % s)*wq + col / s), rows row_pitch floats apart: neighbouring
//     threads read neighbouring words at any stride, and the plan picks
//     row_pitch so that the rows a warp reads fall on distinct banks.
// The next chunk is in flight while this one is computed.  The window is
// copied 4 bytes a thread with cp.async (zero-filled past the tile), f32
// weight runs on a 16-byte boundary 16 bytes a thread (the plan's
// w_copy); bf16 is widened to f32 as it is staged, by ordinary loads.  Each (c, kh, kw) step is then RF + RH*RW
// shared-memory loads and RF*RH*RW multiply-adds from registers, the
// steps unrolled so their loads issue ahead of their arithmetic; 1x1 and
// 3x3 layers keep a channel's step offsets in registers, other sizes read
// them from a table in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;   // 227 KB, a block's dynamic limit

// The register tiles (RF, RH, RW) the kernel is built for; ops.py's
// REGISTER_TILES lists the same, in the same order.
#define CONV_CE_TILES(X)                                                  \
  X(1, 1, 1) X(1, 1, 2) X(1, 1, 4) X(1, 2, 2)                             \
  X(2, 1, 1) X(2, 1, 2) X(2, 1, 4) X(2, 2, 2)                             \
  X(4, 1, 1) X(4, 1, 2)                                                   \
  X(8, 1, 1) X(8, 1, 2) X(8, 2, 1)

// Threads a block of register tile (RF, RH, RW) may have: a tile of more
// than 4 outputs a thread gets up to 128 registers (ops.max_threads), and
// the build holds no spills at that bound.
constexpr int max_threads(int rf, int rh, int rw) {
  return rf * rh * rw > 4 ? 512 : kMaxThreads;
}

struct Args {
  const void* x;   // (C, H, W)
  const void* wt;  // w transposed: (C*KH*KW, F)
  void* out;       // (F, OH, OW)
  int C, H, W, F, KH, KW, OH, OW, stride;
  int par_f, par_oh, par_ow;
  int tf, th, tw;            // thread groups along filters, rows, columns
  int cc;                    // channels a chunk stages
  int wh, ww;                // input window rows and columns
  int wq;                    // columns of one stride phase of a window row
  int row_pitch;             // floats between window rows
  int f_pitch;               // floats between staged weight rows
  int w_floats;              // floats of a stage's weights (then its window)
  int stage_floats;          // floats of one stage, a multiple of 4
  int w_copy;                // how weights are staged (kCopy* below)
};

// How a chunk's weights reach shared memory: a thread an element (bf16,
// widened as it is staged, or f32 runs off a 16-byte boundary), or a
// thread 16 bytes (cp.async).
enum { kCopyElement = 0, kCopy16 = 1 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// One element into shared memory as f32: zero when !ok, `src` unread.
__device__ __forceinline__ void stage_one(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void stage_one(float* dst,
                                          const __nv_bfloat16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}
// 16 bytes, of which the first `bytes` are read and the rest zeroed.
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// RF consecutive floats from 8-byte (RF 2) or 16-byte (RF >= 4) aligned
// shared memory.
template <int RF>
__device__ __forceinline__ void load_weights(float (&v)[RF], const float* p) {
  if constexpr (RF == 1) {
    v[0] = p[0];
  } else if constexpr (RF == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < RF; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
    }
  }
}

// Stage chunk `k` (channels k*cc ...) of the tile into `buf`.
template <typename T, int RF>
__device__ __forceinline__ void stage_chunk(const Args& a, int k, float* buf,
                                            int f0, int oh0, int ow0, int nf,
                                            int vh, int vw) {
  const int t = threadIdx.x, T_ = blockDim.x;
  const int kk = a.KH * a.KW;
  const int c0 = k * a.cc;
  const int ncc = min(a.cc, a.C - c0);
  // weights: row r = (c, kh, kw) of the chunk is a run of the transposed
  // weights, filters f0 ...
  const int rows = ncc * kk;
  const T* wt = static_cast<const T*>(a.wt) +
                static_cast<size_t>(c0) * kk * a.F + f0;
  // threads walk along the runs, a run a thread group, an element or 16
  // bytes a copy
  const bool vec = a.w_copy == kCopy16;
  const int units = vec ? (a.tf * RF + 3) / 4 : a.tf * RF;
  const int lanes = min(units, T_);
  const int groups = T_ / lanes;
  const int g = t / lanes, u0 = t - g * lanes;
  if (g < groups) {
    for (int r = g; r < rows; r += groups) {
      const T* src = wt + static_cast<size_t>(r) * a.F;
      float* dst = buf + r * a.f_pitch;
      for (int u = u0; u < units; u += lanes) {
        if (vec) {
          const int bytes = 4 * max(0, min(4, nf - 4 * u));
          stage_vec(dst + 4 * u,
                    reinterpret_cast<const float*>(bytes ? src + 4 * u : src),
                    bytes);
        } else {
          stage_one(dst + u, u < nf ? src + u : src, u < nf);
        }
      }
    }
  }
  // the input window: a thread takes one (row, col) at a time, for every
  // channel of its channel group; neighbouring threads take neighbouring
  // columns, and a window smaller than the block splits the channels too
  const T* x = static_cast<const T*>(a.x);
  const size_t hw = static_cast<size_t>(a.H) * a.W;
  float* xs = buf + a.w_floats;
  const int plane = a.wh * a.row_pitch;
  const int n_plane = a.wh * a.ww;
  const int x_lanes = min(n_plane, T_);
  const int c_groups = T_ / x_lanes;
  const int c_first = t / x_lanes, e0 = t - c_first * x_lanes;
  if (c_first < c_groups) {
    for (int e = e0; e < n_plane; e += x_lanes) {
      const int row = e / a.ww;
      const int col = e - row * a.ww;
      const bool ok = row < vh && col < vw;
      const T* src = x + static_cast<size_t>(c0) * hw +
                     static_cast<size_t>(oh0 * a.stride + row) * a.W +
                     ow0 * a.stride + col;
      float* dst = xs + row * a.row_pitch + (col % a.stride) * a.wq +
                   col / a.stride;
      for (int c = c_first; c < ncc; c += c_groups) {
        stage_one(dst + c * plane, ok ? src + c * hw : x, ok);
      }
    }
  }
}

// One (c, kh, kw) step of a thread: its RF weights and RH x RW inputs,
// then RF x RH x RW separately rounded multiply-adds.
template <int RF, int RH, int RW>
__device__ __forceinline__ void mac_step(float (&acc)[RF][RH][RW],
                                         const float* w, const float* x,
                                         const int (&x_rel)[RH][RW]) {
  float wv[RF];
  load_weights<RF>(wv, w);
  float xv[RH][RW];
#pragma unroll
  for (int j = 0; j < RH; ++j)
#pragma unroll
    for (int k = 0; k < RW; ++k) xv[j][k] = x[x_rel[j][k]];
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < RH; ++j)
#pragma unroll
      for (int k = 0; k < RW; ++k)
        acc[i][j][k] = __fadd_rn(acc[i][j][k], __fmul_rn(xv[j][k], wv[i]));
}

// K: the layer's KH = KW when it is 1 or 3, whose steps of a channel sit
// at offsets the thread keeps in registers; 0 for any kernel size, whose
// steps' offsets come from a table in shared memory.
template <typename T, int RF, int RH, int RW, int K>
__global__ void __launch_bounds__(max_threads(RF, RH, RW), 1)
    conv_ce_kernel(const Args a) {
  // steps unrolled: enough to hoist their loads above their arithmetic
  constexpr int kUnroll = RF * RH * RW <= 2 ? 8 : RF * RH * RW <= 8 ? 4 : 2;
  extern __shared__ __align__(16) float smem[];
  const int f0 = blockIdx.x * a.par_f;
  const int oh0 = blockIdx.y * a.par_oh;
  const int ow0 = blockIdx.z * a.par_ow;
  // the part of the tile that exists (ragged tails masked)
  const int nf = min(a.par_f, a.F - f0);
  const int nh = min(a.par_oh, a.OH - oh0);
  const int nw = min(a.par_ow, a.OW - ow0);
  // the window rows and columns those outputs read
  const int vh = (nh - 1) * a.stride + a.KH;
  const int vw = (nw - 1) * a.stride + a.KW;

  const int t = threadIdx.x;
  const int gw = t % a.tw;
  const int gh = (t / a.tw) % a.th;
  const int gf = t / (a.tw * a.th);
  const bool active = gf < a.tf;

  const int kk = a.KH * a.KW;
  const int n_chunks = (a.C + a.cc - 1) / a.cc;
  // each step (c, kh, kw) of a chunk: the offset of its input in a
  // staged window
  int* x_at = reinterpret_cast<int*>(smem + 2 * a.stage_floats);
  // the offset of each (kh, kw) of a channel in the staged window
  int k_off[K * K > 0 ? K * K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K * K; ++k) {
      k_off[k] = (k / K) * a.row_pitch + (k % K) % a.stride * a.wq +
                 (k % K) / a.stride;
    }
  } else {
    for (int s = t; s < a.cc * kk; s += blockDim.x) {
      const int c = s / kk, k = s - c * kk;
      const int kh = k / a.KW, kw = k - kh * a.KW;
      x_at[s] = (c * a.wh + kh) * a.row_pitch + (kw % a.stride) * a.wq +
                kw / a.stride;
    }
  }
  // the thread's outputs' inputs, from the first
  const int x_off = gh * a.stride * a.row_pitch + gw;
  int x_rel[RH][RW];
#pragma unroll
  for (int j = 0; j < RH; ++j)
#pragma unroll
    for (int k = 0; k < RW; ++k)
      x_rel[j][k] = j * a.th * a.stride * a.row_pitch + k * a.tw;

  float acc[RF][RH][RW];
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < RH; ++j)
#pragma unroll
      for (int k = 0; k < RW; ++k) acc[i][j][k] = 0.f;

  __syncthreads();
  stage_chunk<T, RF>(a, 0, smem, f0, oh0, ow0, nf, vh, vw);
  stage_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    stage_wait();
    // chunk ch has landed for every thread, and every thread is done
    // reading the other buffer (chunk ch-1)
    __syncthreads();
    if (ch + 1 < n_chunks) {
      stage_chunk<T, RF>(a, ch + 1, smem + ((ch + 1) & 1) * a.stage_floats,
                         f0, oh0, ow0, nf, vh, vw);
    }
    stage_commit();
    if (active) {
      const float* ws = smem + (ch & 1) * a.stage_floats + gf * RF;
      const float* xs = smem + (ch & 1) * a.stage_floats + a.w_floats + x_off;
      const int ncc = min(a.cc, a.C - ch * a.cc);
      if constexpr (K > 0) {
        const int plane = a.wh * a.row_pitch;
#pragma unroll (K == 1 ? kUnroll : 1)
        for (int c = 0; c < ncc; ++c) {
#pragma unroll
          for (int k = 0; k < K * K; ++k) {
            mac_step<RF, RH, RW>(acc, ws + (c * K * K + k) * a.f_pitch,
                                 xs + c * plane + k_off[k], x_rel);
          }
        }
      } else {
#pragma unroll (kUnroll)
        for (int s = 0; s < ncc * kk; ++s) {
          mac_step<RF, RH, RW>(acc, ws + s * a.f_pitch, xs + x_at[s], x_rel);
        }
      }
    }
  }
  if (!active) return;
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int df = gf * RF + i;
#pragma unroll
    for (int j = 0; j < RH; ++j) {
      const int dh = gh + j * a.th;
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        const int dw = gw + k * a.tw;
        if (df < nf && dh < nh && dw < nw) {
          store(out + (static_cast<size_t>(f0 + df) * a.OH + oh0 + dh) *
                          a.OW + ow0 + dw,
                acc[i][j][k]);
        }
      }
    }
  }
}

// w (F, R) -> wt (R, F), R = C*KH*KW, through 32 x 32 tiles.
template <typename T>
__global__ void __launch_bounds__(256)
    transpose_kernel(const T* __restrict__ w, T* __restrict__ wt, int F,
                     int R) {
  __shared__ T tile[32][33];
  const int r0 = blockIdx.x * 32, f0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int f = f0 + i, r = r0 + threadIdx.x;
    if (f < F && r < R) tile[i][threadIdx.x] = w[static_cast<size_t>(f) * R + r];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, f = f0 + threadIdx.x;
    if (f < F && r < R) wt[static_cast<size_t>(r) * F + f] = tile[threadIdx.x][i];
  }
}

using Kernel = void (*)(const Args);

// A register tile's kernels: f32 for 1x1, 3x3 and any kernel size, and
// bf16 for any.
struct Entry {
  int rf, rh, rw;
  Kernel k[4];
  int smem_set[4];   // the dynamic shared memory each is cleared for
};

#define CONV_CE_ENTRY(RF, RH, RW)                                         \
  {RF, RH, RW,                                                            \
   {conv_ce_kernel<float, RF, RH, RW, 1>,                                 \
    conv_ce_kernel<float, RF, RH, RW, 3>,                                 \
    conv_ce_kernel<float, RF, RH, RW, 0>,                                 \
    conv_ce_kernel<__nv_bfloat16, RF, RH, RW, 0>},                        \
   {-1, -1, -1, -1}},
Entry kEntries[] = {CONV_CE_TILES(CONV_CE_ENTRY)};
#undef CONV_CE_ENTRY

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int imin(int a, int b) { return a < b ? a : b; }

}  // namespace

extern "C" {

// Refusals: the plan does not fit the shapes, or the kernel has no such
// register tile.  0 is success, a positive value a CUDA error.
enum {
  kBadShape = -1,      // an extent < 1, kernel larger than input, grid limit
  kBadTile = -2,       // (rf, rh, rw) is not one of CONV_CE_TILES
  kBadThreads = -3,    // not whole warps, over the tile's limit, too few
  kBadChunk = -4,      // cc outside [1, C]
  kBadPitch = -5,      // a window row or weight row narrower than its data
  kBadSmem = -6,       // smem_bytes is not two stages and the step table,
                       // or over 227 KB
  kBadCopy = -7,       // w_copy is not kCopyElement where the weights' runs
                       // are bf16 or off a 16-byte boundary
};

// One layer on `stream`: transpose w (F, C, KH, KW) into the scratch `wt`
// (C*KH*KW, F), then launch the CE kernel on Eq. 1's grid with the plan's
// register tile (rf, rh, rw), `threads` threads, `cc` channels a chunk,
// window rows `row_pitch` floats apart, weight rows `f_pitch` floats apart
// and `smem_bytes` of dynamic shared memory, staging weights by `w_copy`
// (kCopyElement, kCopy16).  x, w, wt and out are
// contiguous device memory of one type: float32 (bf16 == 0) or bfloat16
// (bf16 == 1).  Writes the CE kernel's grid to grid_out[0..2] (zeros when
// it refuses or the launch fails).
int conv_ce(const void* x, const void* w, void* wt, void* out, int C, int H,
            int W, int F, int KH, int KW, int stride, int par_f, int par_oh,
            int par_ow, int bf16, int rf, int rh, int rw, int threads, int cc,
            int row_pitch, int f_pitch, int smem_bytes, int w_copy,
            int* grid_out, void* stream) {
  grid_out[0] = grid_out[1] = grid_out[2] = 0;
  if (C < 1 || F < 1 || KH < 1 || KW < 1 || stride < 1 || par_f < 1 ||
      par_oh < 1 || par_ow < 1 || H < KH || W < KW) {
    return kBadShape;
  }
  Args a;
  a.x = x; a.wt = wt; a.out = out;
  a.C = C; a.H = H; a.W = W; a.F = F; a.KH = KH; a.KW = KW;
  a.OH = (H - KH) / stride + 1;
  a.OW = (W - KW) / stride + 1;
  a.stride = stride;
  a.par_f = par_f; a.par_oh = par_oh; a.par_ow = par_ow;
  const dim3 grid(ceil_div(F, par_f), ceil_div(a.OH, par_oh),
                  ceil_div(a.OW, par_ow));
  if (grid.y > 65535 || grid.z > 65535) return kBadShape;
  Entry* e = nullptr;
  for (Entry& k : kEntries) {
    if (k.rf == rf && k.rh == rh && k.rw == rw) e = &k;
  }
  if (e == nullptr) return kBadTile;
  a.tf = ceil_div(imin(par_f, F), rf);
  a.th = ceil_div(imin(par_oh, a.OH), rh);
  a.tw = ceil_div(imin(par_ow, a.OW), rw);
  if (threads % 32 != 0 || threads > max_threads(rf, rh, rw) ||
      static_cast<long long>(a.tf) * a.th * a.tw > threads) {
    return kBadThreads;
  }
  if (cc < 1 || cc > C) return kBadChunk;
  a.cc = cc;
  a.wh = (a.th * rh - 1) * stride + KH;
  a.ww = (a.tw * rw - 1) * stride + KW;
  a.wq = ceil_div(a.ww, stride);
  if (row_pitch < stride * a.wq || f_pitch < ceil_div(a.tf * rf, 4) * 4 ||
      f_pitch % 4 != 0) {
    return kBadPitch;
  }
  a.row_pitch = row_pitch;
  a.f_pitch = f_pitch;
  const long long kk = static_cast<long long>(KH) * KW;
  const long long w_floats = cc * kk * f_pitch;
  const long long x_floats = static_cast<long long>(cc) * a.wh * row_pitch;
  const long long stage = (w_floats + x_floats + 3) / 4 * 4;
  if ((2 * stage + cc * kk) * 4 != smem_bytes ||
      smem_bytes > kMaxSmem) {
    return kBadSmem;
  }
  a.w_floats = static_cast<int>(w_floats);
  a.stage_floats = static_cast<int>(stage);
  const bool aligned = !bf16 && F % 4 == 0 && (par_f % 4 == 0 || grid.x == 1);
  if (w_copy < kCopyElement || w_copy > kCopy16 ||
      (w_copy != kCopyElement && !aligned)) {
    return kBadCopy;
  }
  a.w_copy = w_copy;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = C * KH * KW;
  const dim3 t_grid(ceil_div(R, 32), ceil_div(F, 32)), t_block(32, 8);
  if (bf16) {
    transpose_kernel<__nv_bfloat16><<<t_grid, t_block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(wt), F, R);
  } else {
    transpose_kernel<float><<<t_grid, t_block, 0, s>>>(
        static_cast<const float*>(w), static_cast<float*>(wt), F, R);
  }
  const int which = bf16                     ? 3
                    : KH == 1 && KW == 1     ? 0
                    : KH == 3 && KW == 3     ? 1
                                             : 2;
  const Kernel k = e->k[which];
  int& cleared = e->smem_set[which];
  if (cleared < 0) {
    cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    cleared = 0;
  }
  if (smem_bytes > cleared) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(k),
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cleared = kMaxSmem;
  }
  k<<<grid, threads, smem_bytes, s>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) {
    grid_out[0] = static_cast<int>(grid.x);
    grid_out[1] = static_cast<int>(grid.y);
    grid_out[2] = static_cast<int>(grid.z);
  }
  return err;
}

}  // extern "C"
