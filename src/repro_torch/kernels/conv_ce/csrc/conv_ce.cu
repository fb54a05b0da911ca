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
// Design.  The CE's parallelism vector <par_f, par_oh, par_ow> is the
// output tile, and one block computes one tile, so the grid is
//   (ceil(F/par_f), ceil(OH/par_oh), ceil(OW/par_ow))
// and grid size * C*KH*KW is Eq. 1's cycle count, the identity the port
// keeps (ops.grid_size, ops.predicted_cycles).  The Builder's tiles hold up
// to a CE's PE count of outputs (2520 on ZCU102), more than the 1024
// threads a block may have, so the block's threads loop over the tile's
// outputs, the output width fastest: neighbouring threads read
// neighbouring inputs and write neighbouring outputs, and threads of one
// filter read the same weight (a broadcast).  A ragged tile at the edge of
// F, OH or OW is masked here, in the kernel: the block walks only the
// outputs that exist, and nothing is padded.  Each thread keeps its sum in
// a register and adds the terms in (c, kh, kw) order with _rn intrinsics
// (no FMA; the build passes --fmad=false), the plain version's order, so
// the two agree bit for bit.  Unlike the TPU kernel, which keeps the whole
// input resident in VMEM, the input stays in global memory: at ResNet-50
// widths a layer's input does not fit in a block's 227 KB of shared
// memory, and the tile's reads of it come from L1/L2.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35
// TB/s): operations, 2 per MAC.  One ResNet-50 pass (4.09 GMAC, 8.17
// GFLOP, 53 layers) takes at least 0.12 ms; its inputs and outputs are
// about 0.2 GB, 0.06 ms.  This simple kernel issues two loads per MAC from
// L1, so the load units, not the FP32 units, set its speed; staging tiles
// of x and w in shared memory and reusing them across outputs is the work
// of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void conv_ce_kernel(const T* __restrict__ x,   // (C, H, W)
                               const T* __restrict__ w,   // (F, C, KH, KW)
                               T* __restrict__ out,       // (F, OH, OW)
                               int C, int H, int W, int F, int KH, int KW,
                               int OH, int OW, int stride, int par_f,
                               int par_oh, int par_ow) {
  const int f0 = blockIdx.x * par_f;
  const int oh0 = blockIdx.y * par_oh;
  const int ow0 = blockIdx.z * par_ow;
  // the part of the tile that exists (ragged tails masked)
  const int nf = min(par_f, F - f0);
  const int nh = min(par_oh, OH - oh0);
  const int nw = min(par_ow, OW - ow0);
  const int n = nf * nh * nw;
  const int kk = KH * KW;
  const size_t hw = static_cast<size_t>(H) * W;

  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int dw = o % nw;
    const int r = o / nw;
    const int dh = r % nh;
    const int df = r / nh;
    const int f = f0 + df, oh = oh0 + dh, ow = ow0 + dw;
    const T* xp = x + static_cast<size_t>(oh) * stride * W
                  + static_cast<size_t>(ow) * stride;
    const T* wp = w + static_cast<size_t>(f) * C * kk;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) {
      const T* xc = xp + c * hw;
      const T* wc = wp + static_cast<size_t>(c) * kk;
      for (int kh = 0; kh < KH; ++kh) {
        for (int kw = 0; kw < KW; ++kw) {
          acc = __fadd_rn(acc, __fmul_rn(to_f32(xc[kh * W + kw]),
                                         to_f32(wc[kh * KW + kw])));
        }
      }
    }
    store(out + (static_cast<size_t>(f) * OH + oh) * OW + ow, acc);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  x, w and
// out are contiguous device memory of one type: float32 (bf16 == 0) or
// bfloat16 (bf16 == 1).  The caller checks the shapes: C, H, W, F, KH, KW,
// stride and the tile all >= 1, H >= KH, W >= KW, and the grid within
// CUDA's limits (y and z at most 65535).
int conv_ce(const void* x, const void* w, void* out, int C, int H, int W,
            int F, int KH, int KW, int stride, int par_f, int par_oh,
            int par_ow, int bf16, void* stream) {
  const int OH = (H - KH) / stride + 1;
  const int OW = (W - KW) / stride + 1;
  const dim3 grid((F + par_f - 1) / par_f, (OH + par_oh - 1) / par_oh,
                  (OW + par_ow - 1) / par_ow);
  // enough whole warps for the tile, at most 256 threads
  const long long tile = static_cast<long long>(par_f) * par_oh * par_ow;
  int threads = static_cast<int>(tile < 256 ? ((tile + 31) / 32) * 32 : 256);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    conv_ce_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), C, H, W, F, KH, KW, OH, OW,
        stride, par_f, par_oh, par_ow);
  } else {
    conv_ce_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), C, H, W, F, KH, KW, OH, OW, stride, par_f,
        par_oh, par_ow);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
