// FlashAttention forward in bf16 on Hopper's tensor cores, hand-written for
// sm_90a.
//
// Replaces the Pallas kernel repro/kernels/flash_attn/kernel.py::flash_fwd
// (body _flash_fwd_kernel) for bf16 inputs; csrc/flash_fwd.cu is the f32
// route, on the FMA units.  It computes the function of the plain PyTorch
// version repro_torch/kernels/flash_attn/ref.py::flash_fwd_ref: for every
// (batch, query head, query row) the online-softmax recurrence over tiles of
// keys, with f32 scores, the -inf safe running max (m_safe = 0 where the
// max is -inf, alpha = 0 where the old max is -inf), p kept to f32
// precision for p·v into an f32 accumulator, l == 0 -> 1 (a row that no key
// may see gives 0), and the result rounded to bf16.  Masks: keys at or past
// Sk, causal (key <= q_offset + row), sliding window (key > q_offset + row
// - window).  Layout q (B, Sq, H, D), k/v (B, Sk, Hkv, D), read through
// their strides; GQA by reading KV head h / (H / Hkv) in place, never a
// repeated copy; output (B, Sq, H, D), contiguous.
//
// What held the f32-FMA kernel back in bf16: both products ran on the FMA
// units out of shared memory (67 TFLOP/s at most), and K and V were widened
// and staged synchronously, a __syncthreads() on each side.  Here both
// products run as wgmma (bf16 operands, f32 accumulators), fed by TMA
// loads into a ring that a producer warp keeps ahead of the consumers.
//
// Design.  One CTA per (batch·head, 128 query rows), 288 threads; two CTAs
// an SM for D <= 64 (their registers and shared memory fit), one above.
// * Warps 0-7 are two consumer warpgroups of 64 query rows each (16 a
//   warp); warp 8 is the producer, of which one lane issues every load.
// * The producer loads the CTA's Q once, then the K and V tiles (64 keys)
//   that some real row of the CTA may see (ref.kv_range per CTA) into a
//   ring of STAGES stages.  Each load is a TMA copy of a 4-D tensor map
//   (D, S, heads, B) built on the host from the caller's pointer and
//   strides, in boxes of 64 rows x 64 columns (128 bytes a row, swizzled
//   in TMA's 128-byte mode, the layout wgmma reads without bank
//   conflicts); a head dim past 64 takes a second box, D < 64 the first
//   box's columns past D as zeros.  Rows past Sq or Sk arrive as zeros
//   too (TMA's out-of-bounds fill): nothing is padded in device memory,
//   and a view (a fused qkv projection's) is read in place.  A stage is
//   announced on its `full` mbarrier by the transaction count of its
//   bytes and released on its `empty` mbarrier by the 8 consumer warps.
// * Per tile, a consumer warpgroup waits on `full` and, unless no real row
//   of its own may see the tile (causal, window: then its state stays as
//   it is, exactly, and it only releases the stage):
//   S = Q·Kᵀ as D/16 wgmma m64n64k16, A and B from shared memory (both
//     K-major), then S·scale·log2(e) in f32: the scores in log2 units, so
//     that m, alpha and p come from exp2f of differences of them.  exp2f
//     is correctly computed (2 ulp, subnormal results kept; no __expf,
//     ex2.approx or --use_fast_math: see _nvcc.NVCC_FLAGS); against the
//     plain version's exp of (q·scale)·k the scaled scores part by f32
//     roundings, a relative error of p of a few 1e-6;
//   masks only on a tile that some row of the warp may not see whole,
//     two compares an element against the row's visible key interval;
//   row max and row sum over the 4 lanes that hold a row in the
//     accumulator layout (two shuffles); m, l and alpha as in the Pallas
//     body;
//   O += P·V with p kept to f32 precision: p = p_hi + p_lo, p_hi =
//     bf16_rn(p), p_lo = bf16_rn(p - p_hi) (the difference is exact in
//     f32), so 16 of p's 24 bits and a relative error under 2^-16; two
//     wgmma m64nDk16 per 16 keys, A = p_hi or p_lo from registers (the S
//     accumulator's layout is the register-A layout), B = the V tile from
//     shared memory (N-major, so V needs no transpose), both into one f32
//     accumulator.  This is 1.5x the MMA work of plain bf16 attention;
//     the bound stays the algorithm's;
//   then each warp arrives on the stage's `empty`.
//   The consumers are tied only through the ring, so the softmax of one
//   overlaps the products of the others.
// * Epilogue: acc / l by IEEE division, rounded to bf16, written contiguous.
// No setmaxnreg: with a producer warp instead of a producer warpgroup the
// launch bound leaves ptxas 224 registers a thread (112 where two CTAs
// share an SM); a setmaxnreg variant was not measured.  Measured on the
// card and left out (PERF.md): 16-byte TMA boxes in wgmma's
// no-swizzle layout (half of each 32-byte L2 sector fetched twice: loads
// alone took 3-4x as long); expf (1.2x slower than exp2f); one CTA an SM at
// D 64; the next tile's S and this tile's P·V in flight during the
// softmax, FlashAttention-3's overlap inside a warpgroup (slower here:
// two CTAs an SM run out of registers for it, one CTA an SM is slower).
//
// Bound on an H100 SXM at Llama-3.2-1B's prefill shape (B 4, S 4096, 32
// query heads, 8 KV heads, D 64, causal): 4·D operations per visible
// (query, key) pair, 275 GFLOP, 0.28 ms at 989 TFLOP/s; 168 MB of q, k, v
// and output, 0.05 ms: operations bound it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int BQ = 64 * CONSUMERS;              // query rows per CTA
constexpr int BK = 64;                          // keys per K/V tile
constexpr int STAGES = 3;                       // K/V ring
constexpr int THREADS = 128 * CONSUMERS + 32;   // consumers, producer warp
// A TMA box: 64 rows x 64 columns, each row 128 bytes in shared memory,
// swizzled by TMA in 128-byte mode (the 16-byte pieces of row i sit at
// piece ^ (i % 8)); wgmma reads that layout through its descriptors.
constexpr int BOX_COLS = 64;
constexpr int BOX_ROWS = 64;
constexpr int BOX = BOX_ROWS * BOX_COLS;        // elements of one box
constexpr uint32_t ROW_BYTES = BOX_COLS * 2;    // 128
constexpr uint32_t ATOM_BYTES = 8 * ROW_BYTES;  // 8 rows: a swizzle atom
constexpr uint32_t BOX_BYTES = BOX * 2;         // 8192

static_assert(BK == BOX_ROWS, "a K/V tile is one box of rows per region");

// boxes across a row of head dim D (its 64-column regions; the columns of
// the last one past D arrive as zeros and are never read)
__host__ __device__ constexpr int regions(int D) {
  return (D + BOX_COLS - 1) / BOX_COLS;
}

// Q (CONSUMERS x regions boxes), the K ring and the V ring (STAGES x
// regions boxes each), the barriers q_full, full[STAGES], empty[STAGES];
// plus 1024 bytes to align the base for the swizzle
constexpr size_t smem_bytes(int D) {
  return size_t(BOX_BYTES) * regions(D) * (CONSUMERS + 2 * STAGES)
         + sizeof(uint64_t) * (1 + 2 * STAGES) + 1024;
}

// CTAs an SM: two where two fit in registers and shared memory (D <= 64),
// so that four consumer warps share each scheduler
__host__ __device__ constexpr int ctas_per_sm(int D) {
  return D <= 64 ? 2 : 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(smem_addr(b)) : "memory");
}
// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(b)), "r"(bytes) : "memory");
}
// until the phase of parity `parity` of *b has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile("{\n.reg .pred P1;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
               "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n"
               :: "r"(smem_addr(b)), "r"(parity) : "memory");
}

// one box of the 4-D tensor map at coordinates (column, row, head, batch)
// into shared memory at dst, completing on the transaction count of *bar
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// A shared-memory matrix descriptor for wgmma in the 128-byte swizzle
// layout (layout type 1): `sbo` bytes between 8-row swizzle atoms along
// the strided dimension, `lbo` bytes between 64-element blocks along the
// leading one (used by N-major operands wider than 64; K-major ones take
// their 16-element k-steps inside the 128-byte row, and `lbo` is unused).
__device__ __forceinline__ uint64_t matrix_desc(const void* p, uint32_t lbo,
                                                uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64 f32) += a (64 x 16 bf16) · b (16 x 64 bf16), both K-major in
// shared memory, given by matrix descriptors; scale_d == 0 starts d from
// zero
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N f32) += a (64 x 16 bf16 in registers, per warp the layout of
// mma.m16n8k16's A) · b (16 x N bf16 in shared memory, N-major, given by a
// matrix descriptor).  One specialisation per N = D.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  __device__ __forceinline__ static void rs(float (&d)[24],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  __device__ __forceinline__ static void rs(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void rs(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<112> {
  __device__ __forceinline__ static void rs(float (&d)[56],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p at two neighbouring columns of one row -> bf16 pairs hi and lo with
// hi + lo = p to 16 bits
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(p0, hf.x),
                                    __fsub_rn(p1, hf.y)));
}

template <int D>
__global__ void __launch_bounds__(THREADS, ctas_per_sm(D))
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      bf16* __restrict__ out, int Sq, int Sk, int H, int rep,
                      int causal, int has_window, int window, int q_offset,
                      float scale) {
  constexpr int NR = regions(D);        // boxes across a row
  constexpr int KD = D / 16;            // k-steps of S = Q·Kᵀ
  constexpr int NS = BK / 8;            // 8-key column blocks of S
  constexpr int NO = D / 8;             // 8-column blocks of O
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Ks = Qs + CONSUMERS * NR * BOX;
  bf16* Vs = Ks + STAGES * NR * BOX;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * NR * BOX);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / rep;
  // the heaviest causal tiles (the last rows) of every head start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  // keys any real row of this CTA may see (ref.py::kv_range)
  const int qa_lo = q0 + q_offset;
  const int qa_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, qa_hi + 1) : Sk;
  const int k_lo = has_window ? max(0, qa_lo - window + 1) : 0;
  const int k_first = k_lo / BK * BK;
  const int n_tiles = k_first < k_hi ? (k_hi - k_first + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * CONSUMERS) {
    // The producer warp; one lane issues every load.
    if (tid == 128 * CONSUMERS && n_tiles > 0) {
      // a box's full size arrives, out-of-bounds parts as zeros
      mbar_expect_tx(q_full, CONSUMERS * NR * BOX_BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        for (int r = 0; r < NR; ++r)
          tma_load(&qmap, Qs + (w * NR + r) * BOX, q_full, r * BOX_COLS,
                   q0 + w * BOX_ROWS, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        const int k0 = k_first + it * BK;
        mbar_expect_tx(&full[st], 2 * NR * BOX_BYTES);
        for (int r = 0; r < NR; ++r) {
          tma_load(&kmap, Ks + (st * NR + r) * BOX, &full[st],
                   r * BOX_COLS, k0, hk, b);
          tma_load(&vmap, Vs + (st * NR + r) * BOX, &full[st],
                   r * BOX_COLS, k0, hk, b);
        }
      }
      // stay until the consumers have released the last loads
      for (int it = max(0, n_tiles - STAGES); it < n_tiles; ++it)
        mbar_wait(&empty[it % STAGES], (it / STAGES) & 1);
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, 16 a warp
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg;        // the warpgroup's first row
  const int wrow = row0 + 16 * warp;    // the warp's first row
  // absolute positions: this lane's rows g and g + 8 of the warp, and the
  // first and last real row (< Sq) of the warpgroup and of the warp
  const int qa[2] = {wrow + g + q_offset, wrow + g + 8 + q_offset};
  const int ga_lo = row0 + q_offset;
  const int ga_hi = min(row0 + 63, Sq - 1) + q_offset;
  const int wa_lo = wrow + q_offset;
  const int wa_hi = min(wrow + 15, Sq - 1) + q_offset;

  // acc[4n + e], s[4j + e]: rows g (e = 0, 1) and g + 8 (e = 2, 3) of the
  // warp, columns 8n + 2t + (e & 1)
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // scores in log2 units: exp(x) = exp2(x·log2 e), so m, alpha and p come
  // from exp2f of differences of scaled scores
  const float scale2 = __fmul_rn(scale, 1.4426950408889634f);

  const bf16* Qw = Qs + wg * NR * BOX;   // this warpgroup's Q
  if (n_tiles > 0) mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int k0 = k_first + it * BK;
    mbar_wait(&full[st], (it / STAGES) & 1);
    // a tile that no real row of this warpgroup may see leaves its state
    // exactly as it is (p = 0, alpha = 1, or 0 on a zero state)
    const bool seen = row0 < Sq && (!causal || k0 <= ga_hi)
                      && (!has_window || k0 + BK - 1 > ga_lo - window);
    if (seen) {
      const bf16* Kt = Ks + st * NR * BOX;
      const bf16* Vt = Vs + st * NR * BOX;

      // S = Q·Kᵀ, one wgmma per 16 of D: box kd / 4, bytes 32·(kd % 4) of
      // its rows
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        wgmma_ss_n64(s,
                     matrix_desc(Qw + kd / 4 * BOX + kd % 4 * 16, 16,
                                 ATOM_BYTES),
                     matrix_desc(Kt + kd / 4 * BOX + kd % 4 * 16, 16,
                                 ATOM_BYTES),
                     kd);
      wgmma_commit();
      wgmma_wait_all();

#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = __fmul_rn(s[i], scale2);
      // masks, only on a tile that some row of the warp does not see
      // whole: the keys row r may see are [lo[r], hi[r]], and this lane's
      // element i is key k0 + 2t + 8(i / 4) + (i % 2)
      const bool whole = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= wa_lo)
                         && (!has_window || k0 > wa_hi - window);
      if (!whole) {
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int base = k0 + 2 * t;
          hi[r] = (causal ? min(Sk - 1, qa[r]) : Sk - 1) - base;
          lo[r] = has_window ? qa[r] - window + 1 - base : -BK;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int c = (i / 4) * 8 + (i % 2), r = (i / 2) % 2;
          if (c < lo[r] || c > hi[r]) s[i] = -INFINITY;
        }
      }

      // online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[r], tmax);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            // a masked score is -inf, and its p exactly 0
            const float p = exp2f(__fsub_rn(s[4 * j + e], m_safe));
            s[4 * j + e] = p;
            psum = __fadd_rn(psum, p);
          }
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 1));
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 2));
        const float alpha =
            m[r] == -INFINITY ? 0.f : exp2f(__fsub_rn(m[r], m_safe));
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha), psum);
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[4 * n + 2 * r] = __fmul_rn(acc[4 * n + 2 * r], alpha);
          acc[4 * n + 2 * r + 1] = __fmul_rn(acc[4 * n + 2 * r + 1], alpha);
        }
      }

      // O += (P_hi + P_lo)·V, 16 keys a step; the C fragment of S's
      // columns 16kk .. 16kk + 15 is the A fragment of step kk
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 8 * kk + 4 * (a / 2) + 2 * (a % 2);
          split(s[i], s[i + 1], ph[kk][a], pl[kk][a]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 keys down the V boxes; D across them, BOX_BYTES apart
        const uint64_t dv = matrix_desc(Vt + kk * 16 * BOX_COLS, BOX_BYTES,
                                        ATOM_BYTES);
        Wgmma<D>::rs(acc, ph[kk], dv);
        Wgmma<D>::rs(acc, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with st
  }

  const long long oss = static_cast<long long>(H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wrow + g + 8 * r;
    if (qi >= Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    bf16* o = out + (static_cast<long long>(b) * Sq + qi) * oss
              + static_cast<long long>(h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8 + 2 * t) =
          __floats2bfloat162_rn(__fdiv_rn(acc[4 * n + 2 * r], denom),
                                __fdiv_rn(acc[4 * n + 2 * r + 1], denom));
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime: no link
// against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (B, S, heads, D) bf16 tensor with element strides
// (ss, sh, sb) and the last dimension contiguous: boxes of BOX_COLS
// columns x BOX_ROWS rows of one head of one batch, swizzled in 128-byte
// mode.  Returns the CUresult.
int encode(CUtensorMap* map, const void* base, int B, int S, int heads,
           int D, long long ss, long long sh, long long sb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S),
                              cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * sizeof(bf16),
                                 cuuint64_t(sh) * sizeof(bf16),
                                 cuuint64_t(sb) * sizeof(bf16)};
  const cuuint32_t box[4] = {BOX_COLS, BOX_ROWS, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return static_cast<int>(fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, long long qsb, long long qss,
           long long qsh, long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh, int causal,
           int has_window, int window, int q_offset, float scale,
           cudaStream_t s) {
  CUtensorMap qmap, kmap, vmap;
  int r = encode(&qmap, q, B, Sq, H, D, qss, qsh, qsb);
  if (r != CUDA_SUCCESS) return -r;
  if (Sk > 0) {   // with no key the kernel loads nothing
    r = encode(&kmap, k, B, Sk, Hkv, D, kss, ksh, ksb);
    if (r == CUDA_SUCCESS) r = encode(&vmap, v, B, Sk, Hkv, D, vss, vsh, vsb);
    if (r != CUDA_SUCCESS) return -r;
  } else {
    kmap = vmap = qmap;
  }
  auto kern = flash_fwd_bf16_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(D)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem_bytes(D), s>>>(
      qmap, kmap, vmap, static_cast<bf16*>(out), Sq, Sk, H, H / Hkv, causal,
      has_window, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns 0 on success, the CUDA runtime error of the
// launch (> 0), or minus the CUresult of a tensor map that the driver
// refused (< 0).  q, k, v: bfloat16 device memory, element strides (batch,
// sequence, head) given, the head dimension contiguous; every base address
// 16-byte aligned and every stride of a dimension longer than 1 a multiple
// of 8 elements (TMA's rule).  out: contiguous (B, Sq, H, D) bfloat16.  The
// caller checks the shapes: B, Sq >= 1, Sk >= 0, H a multiple of Hkv,
// ceil(Sq / 128) <= 65535, D a multiple of 16 in [16, 128].
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int Hkv, int D,
                   long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, int causal,
                   int has_window, int window, int q_offset, float scale,
                   void* stream) {
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

// The CTA of a launch at head dim D: plan[0..5] = threads, query rows, keys
// a tile, stages of the K/V ring, dynamic shared-memory bytes, CTAs an SM
// (the launch bound).  Returns 0, or cudaErrorInvalidValue for a D the
// kernel does not take.
int flash_fwd_bf16_plan(int D, int* plan) {
  if (D < 16 || D > 128 || D % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = THREADS;
  plan[1] = BQ;
  plan[2] = BK;
  plan[3] = STAGES;
  plan[4] = static_cast<int>(smem_bytes(D));
  plan[5] = ctas_per_sm(D);
  return 0;
}

}  // extern "C"
