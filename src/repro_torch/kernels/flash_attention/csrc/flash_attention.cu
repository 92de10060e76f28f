// Online-softmax GQA attention (forward) for NVIDIA Hopper (sm_90a).
//
//   out[b, i, h, :] = sum_j softmax_j(cap(q_i . k_j / sqrt(hd))) v_j
//
// over the keys j visible to query row i, which sits at position
// i + q_offset: j < skv, j <= i + q_offset when causal, and
// i + q_offset - j < window with a sliding window.  cap is the tanh logit
// softcap, cap * tanh(s / cap), when one is given.  q is (b, sq, nh, hd),
// k and v are (b, skv, nkv, hd), with any strides on the first three axes
// and hd contiguous; query head h reads kv head h / (nh / nkv)
// (grouped-query attention).  The output is (b, sq, nh, hd), contiguous,
// in the input dtype.  A row with no visible key gives 0.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py  flash_attention_kernel
//                                                (body _flash_kernel)
// and the padding of its wrapper ops.py::flash_attention: columns >= skv
// are masked here, so no padded copy is made and a ragged or bidirectional
// sequence, or q_offset past the keys, gives what ref.py gives (the JAX
// wrapper's zero-padded keys are visible in those two cases).
//
// Both dtypes run on the tensor cores (wgmma, float32 sums) and keep the
// running max, sum and output in float32 registers across a loop over the
// kv tiles that the query tile can see (the TPU kernel's sequential kv
// grid axis), so a sliding-window layer costs O(s * window); both mask
// columns past the keys in place.
//
// What bounds them on an H100: operations.  A layer does 4 hd flops per
// visible (query, key) pair and head; at the serving shape (4 x 4608
// tokens, 8 heads, hd = 256) that is 348 GFLOP against 226 MB of q, k, v
// and out in bf16, some 1500 flops a byte, far above the card's balance.
//
// bfloat16 (repro_flash_attention_tc): both products with bf16 operands
// (989 TFLOP/s dense).
// - One block per (query tile of 128 rows, query head, batch row): two
//   warpgroups of 128 threads, each owning 64 query rows (wgmma's M = 64)
//   and sharing the block's k and v tiles.  Each skips a kv tile none of
//   its rows can see.  The two take turns on the tensor cores (ping-pong
//   on a named barrier): warpgroup 1 issues S after warpgroup 0, so one
//   runs its softmax while the other's wgmma run.
//   Under a causal mask the blocks are issued heaviest query tile first.
// - q (a 64 x hd tile per warpgroup) is loaded once; k and v tiles of 64
//   keys go through a two-stage ring in shared memory, filled by 16-byte
//   cp.async.cg, so the next tile's loads are in flight while the current
//   one computes.  Tiles stay bf16, in the 128-byte swizzle the wgmma
//   descriptors read (64-byte at hd = 32, whose rows are 64 bytes):
//   192 KB at hd = 256, one block an SM; 96 KB at hd = 128, where shared
//   memory would allow two blocks an SM but the registers (about 200 a
//   thread, -Xptxas -v) allow one.
// - S = Q . K^T: hd / 16 wgmma m64n64k16, A and B from shared memory; k
//   stored (keys x hd) is K-major for B.  Softcap, scale, mask and the
//   online softmax run on the accumulator's registers (each thread holds 2
//   rows x 16 keys, a row spans 4 lanes: the max is 2 shuffles, the sum is
//   reduced once at the end); the mask is evaluated only on tiles that
//   cross the causal or window edge or the end of the keys.
// - O += P . V: P goes to bf16 in registers, where S's accumulator layout
//   already is wgmma's A-fragment layout, and never touches shared memory;
//   wgmma m64n{hd}k16 with A from registers and v (keys x hd, MN-major for
//   B) transposed by the descriptor.  P is carried as two bf16 terms,
//   bf16(p) + bf16(p - bf16(p)), in 8 such wgmma a tile instead of 4:
//   one bf16 term alone adds an error about as large as the bf16
//   output's own rounding (tests/test_torch_flash_attention.py emulates
//   it: 3.6e-3 against 2.4e-3 at most a row), and the second adds half
//   again to the tensor-core work, 6 hd flops a visible (query, key) pair
//   against 4 hd: 12% of the kernel's time at gemma2-2b's shapes on an
//   H100 80GB HBM3 at 700 W (1.455 against 1.274 ms, bench_p_terms).  O
//   stays in registers: hd / 2 floats a thread.
// - Left for later, in this order: intra-warpgroup overlap (issue the
//   next tile's S before this tile's softmax: 32 more registers, which
//   hd = 256 does not have now); then TMA loads from a producer warp
//   (warp specialisation), which frees the consumers' issue slots from
//   address arithmetic and, with setmaxnreg, hands them its registers;
//   persistent blocks last, for the tail of the causal grid.
//
// float32 (repro_flash_split_f32, then repro_flash_attention_f32): the
// same tensor cores, on operands carried as two float16 terms, so that
// every product keeps about 22 of float32's 24 bits; held to the plain
// version at 2e-5 like float32 everywhere in the repo.
// - Why float16 terms with a power-of-two scale, not bfloat16 terms: two
//   bf16 terms carry 16 bits, and tests/test_torch_flash_attention.py's
//   emulation of that kernel puts its error at 0.84 of the 2e-5 gate; two
//   f16 terms carry 22 bits (0.06 of the gate there), but f16 spans only
//   2^-24 .. 65504, so every tile of 64 query rows or kBK keys is scaled by
//   an exact power of two 2^-e into [2^14, 2^15) first and e is undone in
//   float32: each tile keeps float32's range and 22 bits relative to its
//   largest element.
// - Split pass (flash_split_f32_kernel): one block of 256 threads per
//   (tensor, batch row, head, tile).  It reads the tile's float32 rows at
//   any strides (so no view is refused), takes the largest magnitude M,
//   e = ilogb(M) - 14, and writes x' = x 2^-e as hi = f16(x') and
//   lo = f16(x' - hi) into contiguous (b, heads, s, hd) scratch, and e.
//   It moves 1.5x the float32 inputs' bytes, a few percent of the main
//   kernel's time at the serving shape.
// - Main kernel (flash_attention_f32_kernel): one block per (query tile of
//   64 rows, query head, batch row).  Shared memory is the crux: each
//   operand tile is two f16 tiles, and at hd = 256 a 64-row q tile takes
//   64 KB, a 32-key k or v tile 32 KB.  Two warpgroups share the block's q
//   tile and walk alternate kv tiles (0, 2, 4, ... and 1, 3, 5, ...), each
//   with its own k and v buffers (kBK = 32 keys at hd = 256, 64 at smaller
//   heads): 64 + 2 x 64 = 192 KB at hd = 256, one block an SM.  Every head
//   size keeps this one layout: a block has two kv tiles in flight, as a
//   two-stage ring would give one warpgroup.  The two
//   never wait for each other inside the loop, so one's softmax and loads
//   hide behind the other's wgmma; at the end warpgroup 1 hands its
//   (max, sum, output) to warpgroup 0 through shared memory, which merges
//   them as the online softmax merges two tiles.  k and v are separate
//   cp.async groups: the k of this warpgroup's next tile loads during this
//   tile's softmax and P . V, the v during the next S.
// - S = Qhi Khi^T + Qhi Klo^T + Qlo Khi^T (3 hd / 16 wgmma m64n{kBK}k16
//   from shared memory; Qlo Klo^T, 2^-22 of the product, is dropped),
//   then times scale 2^(e_q + e_k).  Softcap with tanhf, which is exact to
//   an ulp where the bf16 kernel's 1 - 2 / (1 + 2^x) is not near 0.
// - P . V: p (at most 1) times 2^(14 + e_v - e_run) goes to two f16 terms
//   in registers; O += Phi Vhi + Phi Vlo + Plo Vhi.  e_run is the largest
//   v-tile exponent seen yet; when it grows, O is rescaled with the
//   softmax's correction, so O keeps the scale of its largest tile.
// - 12 hd tensor-core flops a visible pair and head: at the serving shape
//   1.06 ms of work at 989 TFLOP/s, against 5.19 ms for the 4 hd float32
//   flops at the CUDA cores' 67 TFLOP/s.  Registers (-Xptxas -v): 233 at
//   hd = 256, O taking 128; S's 32-key tile takes 16 and P's terms 16;
//   no spills.  What sets its pace is the k and v loads: each 64-row
//   block reads 64 KB of terms per 32 keys, some 3.4 TB/s from L2 at the
//   serving shape (PERF.md).  Left for later: 128 query rows a block
//   sharing each k and v tile, which at hd = 256 leaves room for one
//   stage only, so it needs a producer warp and mbarriers.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, skv, nh, nkv;
  int64_t q_sb, q_ss, q_sh;  // strides (elements) of batch, seq, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int causal;
  int window;  // <= 0: none
  float softcap;  // <= 0: none
  int q_offset;
  float scale;
};

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// The tensor-core pieces both kernels use.

// Operand tiles of ROWS rows x HD 16-bit values in shared memory, in the
// swizzled layout that wgmma's descriptors read: a row is cut into column
// blocks of kSwizzle bytes (64 elements; at HD = 32 the whole 64-byte
// row), each column block holds its ROWS rows at kSwizzle bytes a row, and
// within each group of 8 rows the 16-byte chunks of a row are permuted by
// XOR with the row's index (address bits [4, 7) ^= bits [7, 10) for the
// 128-byte swizzle, bits [4, 6) ^= bits [7, 9) for the 64-byte one).
template <int HD, int ROWS>
struct Tile {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;
  static constexpr int kChunksPerBlock = kSwizzle / 16;
  static constexpr int kBlockBytes = ROWS * kSwizzle;   // one column block
  static constexpr int kBytes = ROWS * HD * 2;
  // descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
};

__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// Byte offset, in a tile, of 16-byte chunk c (of HD / 8) of row r.
template <int HD, int ROWS>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  using T = Tile<HD, ROWS>;
  const int cb = c / T::kChunksPerBlock, cc = c % T::kChunksPerBlock;
  return cb * T::kBlockBytes +
         swizzle(r * T::kSwizzle + cc * 16, T::kChunksPerBlock - 1);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// Q or K as a K-major operand, k-step ks (head-size columns 16 ks ..
// 16 ks + 15): 8-row groups kSwizzle * 8 bytes apart; within a swizzled
// row the step is a plain 32-byte advance of the start address.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int ks) {
  using T = Tile<HD, ROWS>;
  const int byte = ks * 32;
  return make_desc(tile + (byte / T::kSwizzle) * T::kBlockBytes +
                       byte % T::kSwizzle,
                   16, 8 * T::kSwizzle, T::kLayout);
}

// V as the MN-major B of O += P . V, k-step kk (keys 16 kk .. 16 kk + 15):
// column blocks of 64 head-size columns kBlockBytes apart (LBO), 8-key
// groups kSwizzle * 8 bytes apart (SBO).
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using T = Tile<HD, ROWS>;
  return make_desc(tile + kk * 16 * T::kSwizzle, T::kBlockBytes,
                   8 * T::kSwizzle, T::kLayout);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: each thread fences its own writes before the block barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// Keeps the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + ROWS) of a (seq, HD) matrix of 16-bit values with row
// stride `stride` (elements) into a swizzled tile, 16 bytes a cp.async,
// spread over THREADS threads; rows at or past `rows` are zero-filled
// (src-size 0 reads nothing).
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t tile, const void* g,
                                          int64_t stride, int row0,
                                          int rows, int tid) {
  constexpr int kChunks = HD / 8;
  const char* base = static_cast<const char*>(g);
#pragma unroll 4
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < rows;
    const char* src = in ? base + ((row0 + r) * stride + c * 8) * 2 : base;
    cp_async16(tile + chunk_offset<HD, ROWS>(r, c), src, in ? 16 : 0);
  }
}

// wgmma with float32 sums on 16-bit operands, F16 ? float16 : bfloat16.
// The operand lists are spelled out once, the type is a string argument.
#define REPRO_D8(d, o)                                                    \
  "+f"(d[(o) + 0]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]), \
      "+f"(d[(o) + 4]), "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])
#define REPRO_D16(d, o) REPRO_D8(d, o), REPRO_D8(d, (o) + 8)
#define REPRO_D32(d, o) REPRO_D16(d, o), REPRO_D16(d, (o) + 16)
#define REPRO_D64(d, o) REPRO_D32(d, o), REPRO_D32(d, (o) + 32)

// S (64 x N, float32) += A . B^T: A and B from shared memory, both K-major
// (imm-trans-a = imm-trans-b = 0).  N = 32 or 64.
#define REPRO_WGMMA_SS_N32(TY)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15"                                                            \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                    \
      : REPRO_D16(d, 0)                                                     \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define REPRO_WGMMA_SS_N64(TY)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
      "%26, %27, %28, %29, %30, %31"                                        \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
      : REPRO_D32(d, 0)                                                     \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

template <int N, bool F16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64, "S tiles are 32 or 64 keys");
  if constexpr (N == 32) {
    if constexpr (F16) REPRO_WGMMA_SS_N32("f16");
    else REPRO_WGMMA_SS_N32("bf16");
  } else {
    if constexpr (F16) REPRO_WGMMA_SS_N64("f16");
    else REPRO_WGMMA_SS_N64("bf16");
  }
}

// O (64 x N, float32) += P . V-tile: A (P) from registers, B from shared
// memory, MN-major (imm-trans-b = 1).  N = the head size.
#define REPRO_WGMMA_RS_N32(TY)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15"                                                            \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                      \
      : REPRO_D16(d, 0)                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define REPRO_WGMMA_RS_N64(TY)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
      "%26, %27, %28, %29, %30, %31"                                        \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
      : REPRO_D32(d, 0)                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define REPRO_WGMMA_RS_N128(TY)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "        \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "        \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "        \
      "%62, %63"                                                            \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
      : REPRO_D64(d, 0)                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define REPRO_WGMMA_RS_N256(TY)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "        \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "        \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "        \
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "        \
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "        \
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "        \
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "          \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "        \
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"          \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                 \
      : REPRO_D64(d, 0), REPRO_D64(d, 64)                                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

template <int N, bool F16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256,
                "head sizes 32, 64, 128, 256");
  if constexpr (N == 32) {
    if constexpr (F16) REPRO_WGMMA_RS_N32("f16");
    else REPRO_WGMMA_RS_N32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (F16) REPRO_WGMMA_RS_N64("f16");
    else REPRO_WGMMA_RS_N64("bf16");
  } else if constexpr (N == 128) {
    if constexpr (F16) REPRO_WGMMA_RS_N128("f16");
    else REPRO_WGMMA_RS_N128("bf16");
  } else {
    if constexpr (F16) REPRO_WGMMA_RS_N256("f16");
    else REPRO_WGMMA_RS_N256("bf16");
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel.
namespace tc {

constexpr int kWarpgroups = 2;             // consumers of one kv ring
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQ = 64 * kWarpgroups;      // query rows: 64 (wgmma's M) each
constexpr int kBK = 64;                    // keys per kv tile: S's N

// P . V takes P as kPTerms bf16 terms: 2, the default, is bf16(p) +
// bf16(p - bf16(p)); 1 is bf16(p) alone, built only to time the second
// term (python -m repro_torch.kernels.flash_attention.bench_p_terms).
#ifndef REPRO_FLASH_P_TERMS
#define REPRO_FLASH_P_TERMS 2
#endif
constexpr int kPTerms = REPRO_FLASH_P_TERMS;
static_assert(kPTerms == 1 || kPTerms == 2, "P is one or two bf16 terms");

template <int HD>
struct Cfg {
  using QTile = Tile<HD, 64>;   // q, k and v tiles all have 64 rows
  static constexpr int kTileBytes = QTile::kBytes;
  // a q tile per warpgroup, then k and v in two stages; +1024 to align
  // the base to the swizzle
  static constexpr int kSmemBytes = (kWarpgroups + 4) * kTileBytes + 1024;
};

// Named barrier 1 over both warpgroups: one arrives, the other waits.
__device__ __forceinline__ void pingpong_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void pingpong_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// One kv tile for one warpgroup: S = Q . K^T, softcap, scale, mask, the
// online softmax update of (m, l, o), and O += P . V.  This thread holds
// rows qw + r_lo and qw + r_lo + 8 of every accumulator; the tile holds
// keys k0 .. k0 + 63; the warpgroup's rows sit at positions w_first ..
// w_last.
template <int HD>
__device__ __forceinline__ void attend_tile(
    const Params& p, uint32_t sQ, uint32_t sK, uint32_t sV, int k0, int qw,
    int w_first, int w_last, int r_lo, int quad, float y_mul, float u2_mul,
    bool capped, int wg, float (&o)[HD / 2], float (&m_run)[2],
    float (&l_run)[2]) {
  // S = Q . K^T on the tensor cores; warpgroup 1 issues after warpgroup 0
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  if (wg == 1) pingpong_wait();
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    wgmma_ss<kBK, false>(s, desc_kmajor<HD, 64>(sQ, ks),
                         desc_kmajor<HD, 64>(sK, ks), ks > 0);
  wgmma_commit();
  if (wg == 0) pingpong_arrive();
  wgmma_wait_all();
  fence_regs(s);

  // s[4j + 2 half + e]: row qw + r_lo + 8 half, key k0 + 8 j + 2 quad + e.
  // Only a tile that crosses the causal or window edge or the end of the
  // keys is masked.
  const bool edge = k0 + kBK > p.skv ||
                    (p.causal && k0 + kBK - 1 > w_first) ||
                    (p.window > 0 && w_last - k0 >= p.window);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float y = s[i];
    if (capped)
      y = y_mul * (1.f - __fdividef(2.f, 1.f + exp2_approx(y * u2_mul)));
    else
      y *= y_mul;
    if (edge) {
      const int row = qw + r_lo + 8 * ((i / 2) % 2) + p.q_offset;
      const int col = k0 + 8 * (i / 4) + 2 * quad + i % 2;
      bool visible = col < p.skv;
      if (p.causal) visible = visible && row >= col;
      if (p.window > 0) visible = visible && row - col < p.window;
      if (!visible) y = -INFINITY;
    }
    s[i] = y;
  }

  // online softmax: row max over the 4 lanes of a row, rescale, exp
  float corr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[half], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[half] = exp2_approx(m_run[half] - m_use);  // exp2(-inf) = 0
    m_run[half] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pr = exp2_approx(s[4 * j + 2 * half + e] - m_use);
        s[4 * j + 2 * half + e] = pr;
        sum += pr;
      }
    }
    l_run[half] = l_run[half] * corr[half] + sum;
  }
  // Once the row maxima settle, most tiles move none of a warp's 16 rows.
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o[4 * j + i] *= corr[i / 2];
    }
  }

  // P to bf16 in registers, as two terms: hi = bf16(p) and lo =
  // bf16(p - hi), so P . V carries P to 16 bits of mantissa and its
  // error stays below the bf16 output's own rounding.  S's accumulator
  // layout over keys 16 kk .. 16 kk + 15 is the A-fragment layout of
  // k-step kk; the 32 packed registers take the place of the 32 scores.
  uint32_t a[kPTerms][4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      a[0][kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      if constexpr (kPTerms == 2)
        a[1][kk][r] = pack_bf16(x0 - __low2float(hi),
                                x1 - __high2float(hi));
    }
  }

  // O += P . V on the tensor cores
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int t = 0; t < kPTerms; ++t)
      wgmma_rs<HD, false>(o, a[t][kk], desc_mnmajor<HD, 64>(sV, kk));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc_kernel(const Params p) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  // warpgroup w's q tile at sQ + w tiles; stage s: k at sQ + kWarpgroups +
  // 2 s tiles, v one tile after it
  const uint32_t sKV = sQ + kWarpgroups * C::kTileBytes;

  // Block -> (query tile, head, batch row), in launch order: under a causal
  // mask the tiles with the most keys go first, so the last wave is short.
  const int nqt = gridDim.x, nh = gridDim.y, nb = gridDim.z;
  const int lin = blockIdx.x + nqt * (blockIdx.y + nh * blockIdx.z);
  const int rank = lin / (nh * nb), hb = lin % (nh * nb);
  const int qt = p.causal ? nqt - 1 - rank : rank;
  const int h = hb % nh, bi = hb / nh;
  const int hk = h / (p.nh / p.nkv);
  const int q0 = qt * kBQ;

  const int tid = threadIdx.x;
  const int wg = tid / 128;                 // this thread's warpgroup
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int quad = lane % 4;
  const int qw = q0 + 64 * wg;              // its first query row
  // this thread's two rows of every accumulator: qw + r_lo and + 8
  const int r_lo = 16 * warp + lane / 4;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            bi * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            bi * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            bi * p.v_sb + hk * p.v_sh;

  // The keys any row of the block can see, [kv_lo, kv_hi), and those any
  // row of this warpgroup can see, [w_lo, w_hi).
  const int row_first = q0 + p.q_offset;
  const int row_last = min(q0 + kBQ, p.sq) - 1 + p.q_offset;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, row_last + 1);
  if (p.window > 0) kv_lo = max(0, row_first - p.window + 1);
  const int t0 = kv_lo / kBK;
  const int n_tiles = kv_hi > t0 * kBK ? (kv_hi - t0 * kBK + kBK - 1) / kBK
                                       : 0;
  const bool has_rows = qw < p.sq;
  const int w_first = qw + p.q_offset;
  const int w_last = min(qw + 64, p.sq) - 1 + p.q_offset;
  int w_lo = 0, w_hi = p.skv;
  if (p.causal) w_hi = min(w_hi, w_last + 1);
  if (p.window > 0) w_lo = max(0, w_first - p.window + 1);

#pragma unroll
  for (int w = 0; w < kWarpgroups; ++w)
    load_tile<HD, 64, kThreads>(sQ + w * C::kTileBytes, qg, p.q_ss,
                                q0 + 64 * w, p.sq, tid);
  if (n_tiles > 0) {
    load_tile<HD, 64, kThreads>(sKV, kg, p.k_ss, t0 * kBK, p.skv, tid);
    load_tile<HD, 64, kThreads>(sKV + C::kTileBytes, vg, p.v_ss, t0 * kBK,
                                p.skv, tid);
  }
  cp_async_commit();
  const uint32_t sQw = sQ + wg * C::kTileBytes;

  // Scores go to log2 units: y = s * scale * log2(e), or with the softcap
  // y = cap * log2(e) * tanh(s * scale / cap), tanh(u) = 1 - 2 / (e^2u + 1).
  const bool capped = p.softcap > 0.f;
  const float y_mul = capped ? p.softcap * kLog2e : p.scale * kLog2e;
  const float u2_mul = capped ? 2.f * p.scale / p.softcap * kLog2e : 0.f;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (t0 + it) * kBK;
    const uint32_t sK = sKV + 2 * (it & 1) * C::kTileBytes;
    const uint32_t sV = sK + C::kTileBytes;
    if (it + 1 < n_tiles) {  // the next tile's loads fly during this one
      const uint32_t nK = sKV + 2 * ((it + 1) & 1) * C::kTileBytes;
      load_tile<HD, 64, kThreads>(nK, kg, p.k_ss, k0 + kBK, p.skv, tid);
      load_tile<HD, 64, kThreads>(nK + C::kTileBytes, vg, p.v_ss, k0 + kBK,
                                  p.skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // A warpgroup skips a tile none of its rows can see.  The two share
    // the tensor cores in turn (ping-pong): warpgroup 1 issues its S once
    // warpgroup 0 has issued its own, so one's softmax runs while the
    // other's wgmma do.  A skipping warpgroup still takes its barrier turn.
    if (has_rows && k0 < w_hi && k0 + kBK > w_lo) {
      attend_tile<HD>(p, sQw, sK, sV, k0, qw, w_first, w_last, r_lo, quad,
                      y_mul, u2_mul, capped, wg, o, m_run, l_run);
    } else if (wg == 0) {
      pingpong_arrive();
    } else {
      pingpong_wait();
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }
  cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = qw + r_lo + 8 * half;
    if (row >= p.sq) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(bi) * p.sq + row) * p.nh + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
          pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
  }
}

template <int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Cfg<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.nh, batch);
  flash_attention_tc_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: the split pass and the split-operand tensor-core kernel.
namespace f32 {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBQ = 64;         // query rows a block (wgmma's M), shared
constexpr int kShift = 14;      // split tiles are scaled into [2^14, 2^15)
constexpr int kNoExp = -1000;   // the running v exponent before any tile

// Keys a kv tile: the split pass's k and v tiles are the same.
__host__ __device__ constexpr int kv_tile(int hd) {
  return hd >= 256 ? 32 : 64;
}

template <int HD>
struct Cfg {
  static constexpr int kBK = kv_tile(HD);
  using QTile = Tile<HD, kBQ>;
  using KTile = Tile<HD, kBK>;
  // a warpgroup's buffers: k hi, k lo, v hi, v lo
  static constexpr int kStageBytes = 4 * KTile::kBytes;
  // q hi, q lo, then one stage per warpgroup; +1024 to align the base to
  // the swizzle
  static constexpr int kSmemBytes = 2 * QTile::kBytes + 2 * kStageBytes + 1024;
  // warpgroup 1's output, row maxima, row sums and v exponent, one column
  // a thread, in the stage buffers once both loops are done
  static_assert((HD / 2 + 5) * 128 * 4 <= 2 * kStageBytes, "exchange fits");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

// 2^n as a float for n <= 127; 0 below the normal range.
__device__ __forceinline__ float pow2i(int n) {
  return n < -126 ? 0.f : __int_as_float((n + 127) << 23);
}

// Where the split pass writes and the main kernel reads: float16 hi and lo
// of q, then of k, then of v, each (b, heads, s, hd) contiguous; the
// exponents of q's tiles, then k's, then v's, each (b, heads, tiles).
struct Layout {
  int64_t n_q, n_kv;  // elements of q, and of k (= of v)
  int nqt, nkt;       // tiles a (batch row, head) of q, and of k and v
  int64_t n_halves() const { return 2 * (n_q + 2 * n_kv); }
};

Layout make_layout(int batch, int sq, int skv, int nh, int nkv, int hd) {
  Layout l;
  l.n_q = static_cast<int64_t>(batch) * sq * nh * hd;
  l.n_kv = static_cast<int64_t>(batch) * skv * nkv * hd;
  l.nqt = (sq + kBQ - 1) / kBQ;
  l.nkt = (skv + kv_tile(hd) - 1) / kv_tile(hd);
  return l;
}

struct SplitParams {
  const float* src[3];          // q, k, v
  int64_t sb[3], ss[3], sh[3];  // their (batch, seq, head) strides
  __half* hi[3];
  __half* lo[3];
  int* exps[3];
  int seq[3], heads[3], rows[3], tiles[3];
  int first[3];                 // first block of each tensor
  int hd_log2;
};

// Values of a split tile a thread holds: 64 rows x 256 / 256 threads at
// most (a q tile at hd = 256), all loaded before the first is used.
constexpr int kSplitThreads = 256;
constexpr int kSplitPer = kBQ * 256 / kSplitThreads;

__global__ void __launch_bounds__(kSplitThreads) flash_split_f32_kernel(
    const SplitParams p) {
  int blk = blockIdx.x;
  const int t = blk >= p.first[2] ? 2 : blk >= p.first[1] ? 1 : 0;
  blk -= p.first[t];                       // = (b * heads + h) * tiles + tile
  const int tile = blk % p.tiles[t], bh = blk / p.tiles[t];
  const int h = bh % p.heads[t], b = bh / p.heads[t];
  const int r0 = tile * p.rows[t];
  const int n = min(p.rows[t], p.seq[t] - r0) << p.hd_log2;
  const int64_t ss = p.ss[t];
  const int dmask = (1 << p.hd_log2) - 1;
  const float* src = p.src[t] + b * p.sb[t] + h * p.sh[t] + r0 * ss;

  float x[kSplitPer];
  float mx = 0.f;  // fmaxf drops NaNs; a NaN is carried by the split below
#pragma unroll
  for (int j = 0; j < kSplitPer; ++j) {
    const int i = threadIdx.x + j * kSplitThreads;
    x[j] = i < n ? src[(i >> p.hd_log2) * ss + (i & dmask)] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kSplitPer; ++j) mx = fmaxf(mx, fabsf(x[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  __shared__ float warp_max[kSplitThreads / 32];
  __shared__ int tile_exp;
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kSplitThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    // |x 2^-e| < 2^15 for every x of the tile; an all-zero or non-finite
    // tile keeps e = 0
    const int e = m > 0.f && m < INFINITY ? ilogbf(m) - kShift : 0;
    tile_exp = e;
    p.exps[t][blk] = e;
  }
  __syncthreads();
  const int e = tile_exp;
  const int64_t out0 = (static_cast<int64_t>(bh) * p.seq[t] + r0)
                       << p.hd_log2;
  __half* hi = p.hi[t] + out0;
  __half* lo = p.lo[t] + out0;
#pragma unroll
  for (int j = 0; j < kSplitPer; ++j) {
    const int i = threadIdx.x + j * kSplitThreads;
    if (i < n) {
      const float xs = ldexpf(x[j], -e);
      const __half xh = __float2half_rn(xs);
      hi[i] = xh;
      lo[i] = __float2half_rn(xs - __half2float(xh));
    }
  }
}

struct MainParams {
  const __half* q_hi;
  const __half* q_lo;
  const __half* k_hi;
  const __half* k_lo;
  const __half* v_hi;
  const __half* v_lo;
  const int* q_exp;
  const int* k_exp;
  const int* v_exp;
  float* out;
  int sq, skv, nh, nkv, nqt, nkt;
  int causal;
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  int q_offset;
  float scale;
};

// Named barrier 1 + wg over the 128 threads of warpgroup wg (constant ids:
// a barrier id in a register makes ptxas reserve all 16).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_f32_kernel(const MainParams p) {
  using C = Cfg<HD>;
  constexpr int kBK = C::kBK;
  constexpr int kQB = C::QTile::kBytes, kKB = C::KTile::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sQ = (raw + 1023u) & ~1023u;  // q hi; q lo one tile on
  uint8_t* smem = smem_raw + (sQ - raw);        // the same, generic

  // Block -> (query tile, head, batch row), heaviest first under a causal
  // mask, as in the bf16 kernel.
  const int nqt = gridDim.x, nh = gridDim.y, nb = gridDim.z;
  const int lin = blockIdx.x + nqt * (blockIdx.y + nh * blockIdx.z);
  const int rank = lin / (nh * nb), hb = lin % (nh * nb);
  const int qt = p.causal ? nqt - 1 - rank : rank;
  const int h = hb % nh, bi = hb / nh;
  const int hk = h / (p.nh / p.nkv);
  const int q0 = qt * kBQ;

  const int tid = threadIdx.x;
  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32, quad = lane % 4;
  // this thread's two rows of every accumulator: q0 + r_lo and + 8
  const int r_lo = 16 * warp + lane / 4;

  const int64_t q_base = static_cast<int64_t>(bi * p.nh + h) * p.sq * HD;
  const int64_t kv_base = static_cast<int64_t>(bi * p.nkv + hk) * p.skv * HD;
  const int* k_exp = p.k_exp + (bi * p.nkv + hk) * p.nkt;
  const int* v_exp = p.v_exp + (bi * p.nkv + hk) * p.nkt;
  const int eq = p.q_exp[(bi * p.nh + h) * p.nqt + qt];

  // The keys any row of the block can see, [kv_lo, kv_hi).
  const int row_first = q0 + p.q_offset;
  const int row_last = min(q0 + kBQ, p.sq) - 1 + p.q_offset;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, row_last + 1);
  if (p.window > 0) kv_lo = max(0, row_first - p.window + 1);
  const int t0 = kv_lo / kBK;
  const int n_tiles = kv_hi > t0 * kBK ? (kv_hi - t0 * kBK + kBK - 1) / kBK
                                       : 0;

  // this warpgroup's k hi, k lo, v hi, v lo
  const uint32_t sK = sQ + 2 * kQB + wg * C::kStageBytes;
  const uint32_t sV = sK + 2 * kKB;
  // Each load is its own cp.async group, committed even when empty, so
  // that wait_group 1 always means "all but the last load has landed".
  auto load_k = [&](int it) {
    if (it < n_tiles) {
      const int k0 = (t0 + it) * kBK;
      load_tile<HD, kBK, 128>(sK, p.k_hi + kv_base, HD, k0, p.skv, wtid);
      load_tile<HD, kBK, 128>(sK + kKB, p.k_lo + kv_base, HD, k0, p.skv,
                              wtid);
    }
    cp_async_commit();
  };
  auto load_v = [&](int it) {
    if (it < n_tiles) {
      const int k0 = (t0 + it) * kBK;
      load_tile<HD, kBK, 128>(sV, p.v_hi + kv_base, HD, k0, p.skv, wtid);
      load_tile<HD, kBK, 128>(sV + kKB, p.v_lo + kv_base, HD, k0, p.skv,
                              wtid);
    }
    cp_async_commit();
  };

  // q (both terms, by all threads), then this warpgroup's first k and v
  load_tile<HD, kBQ, kThreads>(sQ, p.q_hi + q_base, HD, q0, p.sq, tid);
  load_tile<HD, kBQ, kThreads>(sQ + kQB, p.q_lo + q_base, HD, q0, p.sq, tid);
  cp_async_commit();
  load_k(wg);
  load_v(wg);
  cp_async_wait<1>();  // q and k have landed; v may fly
  fence_proxy_async();
  __syncthreads();

  // Scores go to log2 units: y = s' scale 2^(eq + ek) log2(e), or with the
  // softcap y = cap log2(e) tanh(s' scale 2^(eq + ek) / cap).
  const bool capped = p.softcap > 0.f;
  const float inv_cap = capped ? 1.f / p.softcap : 0.f;
  const float cap_log2e = p.softcap * kLog2e;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  int e_run = kNoExp;           // O is in units of 2^(e_run - 14)

  for (int it = wg; it < n_tiles; it += 2) {
    const int kt = t0 + it, k0 = kt * kBK;
    if (it != wg) {  // this tile's k has landed (the first one above)
      cp_async_wait<1>();
      fence_proxy_async();
      wg_sync(wg);
    }
    const float mul = ldexpf(p.scale, eq + __ldg(k_exp + kt));
    const int ev = __ldg(v_exp + kt);

    // S = Qhi Khi^T + Qhi Klo^T + Qlo Khi^T on the tensor cores
    float s[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<kBK, true>(s, desc_kmajor<HD, kBQ>(sQ, ks),
                          desc_kmajor<HD, kBK>(sK, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<kBK, true>(s, desc_kmajor<HD, kBQ>(sQ, ks),
                          desc_kmajor<HD, kBK>(sK + kKB, ks), 1);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss<kBK, true>(s, desc_kmajor<HD, kBQ>(sQ + kQB, ks),
                          desc_kmajor<HD, kBK>(sK, ks), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    wg_sync(wg);   // every thread's S has read k: its buffer is free
    load_k(it + 2);

    // s[4j + 2 half + e]: row q0 + r_lo + 8 half, key k0 + 8 j + 2 quad + e.
    // Only a tile that crosses the causal or window edge or the end of the
    // keys is masked.
    const bool edge = k0 + kBK > p.skv ||
                      (p.causal && k0 + kBK - 1 > row_first) ||
                      (p.window > 0 && row_last - k0 >= p.window);
    const float u_mul = mul * inv_cap, y_mul = mul * kLog2e;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      float y = capped ? tanhf(s[i] * u_mul) * cap_log2e : s[i] * y_mul;
      if (edge) {
        const int row = q0 + r_lo + 8 * ((i / 2) % 2) + p.q_offset;
        const int col = k0 + 8 * (i / 4) + 2 * quad + i % 2;
        bool visible = col < p.skv;
        if (p.causal) visible = visible && row >= col;
        if (p.window > 0) visible = visible && row - col < p.window;
        if (!visible) y = -INFINITY;
      }
      s[i] = y;
    }

    // online softmax: row max over the 4 lanes of a row, rescale, exp
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      corr[half] = exp2_approx(m_run[half] - m_use);  // exp2(-inf) = 0
      m_run[half] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = exp2_approx(s[4 * j + 2 * half + e] - m_use);
          s[4 * j + 2 * half + e] = pr;
          sum += pr;
        }
      }
      l_run[half] = l_run[half] * corr[half] + sum;
    }
    // v's exponent: O follows the largest one yet; p takes this tile's
    // offset from it and the 2^14 that keeps its low term above f16's
    // subnormals.
    const int e_new = max(e_run, ev);
    const float o_shift = pow2i(e_run - e_new);
    const float p_mul = pow2i(kShift + ev - e_new);
    e_run = e_new;
    corr[0] *= o_shift;
    corr[1] *= o_shift;
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[4 * j + i] *= corr[i / 2];
      }
    }

    // P to two f16 terms in registers (S's accumulator layout over keys
    // 16 kk .. 16 kk + 15 is the A-fragment layout of k-step kk).
    uint32_t a[2][kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[8 * kk + 2 * r] * p_mul;
        const float x1 = s[8 * kk + 2 * r + 1] * p_mul;
        const __half2 hi = __floats2half2_rn(x0, x1);
        a[0][kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        a[1][kk][r] = pack_f16(x0 - __low2float(hi), x1 - __high2float(hi));
      }
    }

    cp_async_wait<1>();  // this tile's v has landed
    fence_proxy_async();
    wg_sync(wg);

    // O += Phi Vhi + Phi Vlo + Plo Vhi on the tensor cores
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_rs<HD, true>(o, a[0][kk], desc_mnmajor<HD, kBK>(sV, kk));
      wgmma_rs<HD, true>(o, a[0][kk], desc_mnmajor<HD, kBK>(sV + kKB, kk));
      wgmma_rs<HD, true>(o, a[1][kk], desc_mnmajor<HD, kBK>(sV, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    wg_sync(wg);   // every thread's P . V has read v: its buffer is free
    load_v(it + 2);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 1);
    l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 2);
  }

  // Warpgroup 1 hands its state to warpgroup 0 through the (now unused)
  // stage buffers: thread i of both holds the same rows and columns.
  __syncthreads();
  float* x = reinterpret_cast<float*>(smem + 2 * kQB);
  constexpr int kO = HD / 2;
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < kO; ++i) x[i * 128 + wtid] = o[i];
    x[(kO + 0) * 128 + wtid] = m_run[0];
    x[(kO + 1) * 128 + wtid] = m_run[1];
    x[(kO + 2) * 128 + wtid] = l_run[0];
    x[(kO + 3) * 128 + wtid] = l_run[1];
    x[(kO + 4) * 128 + wtid] = __int_as_float(e_run);
  }
  __syncthreads();
  if (wg == 1) return;

  const int e1 = __float_as_int(x[(kO + 4) * 128 + wtid]);
  const int em = max(e_run, e1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    const float m1 = x[(kO + half) * 128 + wtid];
    const float l1 = x[(kO + 2 + half) * 128 + wtid];
    const float m = fmaxf(m_run[half], m1);
    const float mu = m == -INFINITY ? 0.f : m;
    const float c0 = exp2_approx(m_run[half] - mu);
    const float c1 = exp2_approx(m1 - mu);
    const float l = l_run[half] * c0 + l1 * c1;
    // out = (O0 c0 2^(e0 - em) + O1 c1 2^(e1 - em)) 2^(em - 14) / l
    const float inv = l > 0.f ? ldexpf(1.f / l, em - kShift) : 0.f;
    const float f0 = c0 * pow2i(e_run - em) * inv;
    const float f1 = c1 * pow2i(e1 - em) * inv;
    if (row >= p.sq) continue;
    float* orow =
        p.out + ((static_cast<int64_t>(bi) * p.sq + row) * p.nh + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int i0 = 4 * j + 2 * half;
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * quad) = make_float2(
          o[i0] * f0 + x[i0 * 128 + wtid] * f1,
          o[i0 + 1] * f0 + x[(i0 + 1) * 128 + wtid] * f1);
    }
  }
}

template <int HD>
cudaError_t launch(const MainParams& p, int batch, cudaStream_t stream) {
  constexpr int smem = Cfg<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.nh, batch);
  flash_attention_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

Params make_params(const void* q, const void* k, const void* v, void* out,
                   int sq, int skv, int nh, int nkv, int hd,
                   const long long* strides, int causal, int window,
                   float softcap, int q_offset) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.sq = sq;
  p.skv = skv;
  p.nh = nh;
  p.nkv = nkv;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.q_offset = q_offset;
  p.scale = 1.0f / sqrtf(static_cast<float>(hd));
  return p;
}

bool known_head_size(int hd) {
  return hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

}  // namespace

// bfloat16 q, k, v (the tensor-core kernel).  strides: 9 int64 values, the
// (batch, seq, head) strides of q, k and v in elements; the pointers and
// the strides must be multiples of 16 bytes.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out, int batch,
                                        int sq, int skv, int nh, int nkv,
                                        int hd, const long long* strides,
                                        int causal, int window, float softcap,
                                        int q_offset, void* stream) {
  const Params p = make_params(q, k, v, out, sq, skv, nh, nkv, hd, strides,
                               causal, window, softcap, q_offset);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return tc::launch<32>(p, batch, s);
    case 64: return tc::launch<64>(p, batch, s);
    case 128: return tc::launch<128>(p, batch, s);
    case 256: return tc::launch<256>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// float32, step 1: the split pass.  q, k, v at any (batch, seq, head)
// strides (9 int64 values, elements; hd contiguous) into `halves` (float16,
// repro_flash_f32_scratch's first count) and `exps` (int32, its second).
extern "C" int repro_flash_split_f32(const void* q, const void* k,
                                     const void* v, void* halves, void* exps,
                                     int batch, int sq, int skv, int nh,
                                     int nkv, int hd,
                                     const long long* strides, void* stream) {
  if (!known_head_size(hd)) return cudaErrorInvalidValue;
  const f32::Layout l = f32::make_layout(batch, sq, skv, nh, nkv, hd);
  __half* hv = static_cast<__half*>(halves);
  int* ev = static_cast<int*>(exps);
  f32::SplitParams p;
  const void* src[3] = {q, k, v};
  const int64_t n[3] = {l.n_q, l.n_kv, l.n_kv};
  const int seq[3] = {sq, skv, skv}, heads[3] = {nh, nkv, nkv};
  const int rows[3] = {f32::kBQ, f32::kv_tile(hd), f32::kv_tile(hd)};
  const int tiles[3] = {l.nqt, l.nkt, l.nkt};
  int64_t blocks = 0;
  for (int t = 0; t < 3; ++t) {
    p.src[t] = static_cast<const float*>(src[t]);
    p.sb[t] = strides[3 * t];
    p.ss[t] = strides[3 * t + 1];
    p.sh[t] = strides[3 * t + 2];
    p.hi[t] = hv;
    p.lo[t] = hv + n[t];
    hv += 2 * n[t];
    p.exps[t] = ev;
    ev += batch * heads[t] * tiles[t];
    p.seq[t] = seq[t];
    p.heads[t] = heads[t];
    p.rows[t] = rows[t];
    p.tiles[t] = tiles[t];
    p.first[t] = static_cast<int>(blocks);
    blocks += static_cast<int64_t>(batch) * heads[t] * tiles[t];
  }
  p.hd_log2 = hd == 32 ? 5 : hd == 64 ? 6 : hd == 128 ? 7 : 8;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  f32::flash_split_f32_kernel<<<static_cast<unsigned>(blocks),
                                f32::kSplitThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// float32, step 2: the main kernel on what repro_flash_split_f32 wrote,
// into a contiguous float32 (b, sq, nh, hd) `out`.
extern "C" int repro_flash_attention_f32(const void* halves, const void* exps,
                                         void* out, int batch, int sq,
                                         int skv, int nh, int nkv, int hd,
                                         int causal, int window,
                                         float softcap, int q_offset,
                                         void* stream) {
  if (!known_head_size(hd)) return cudaErrorInvalidValue;
  const f32::Layout l = f32::make_layout(batch, sq, skv, nh, nkv, hd);
  const __half* hv = static_cast<const __half*>(halves);
  const int* ev = static_cast<const int*>(exps);
  f32::MainParams p;
  p.q_hi = hv;
  p.q_lo = hv + l.n_q;
  p.k_hi = hv + 2 * l.n_q;
  p.k_lo = p.k_hi + l.n_kv;
  p.v_hi = p.k_lo + l.n_kv;
  p.v_lo = p.v_hi + l.n_kv;
  p.q_exp = ev;
  p.k_exp = ev + batch * nh * l.nqt;
  p.v_exp = p.k_exp + batch * nkv * l.nkt;
  p.out = static_cast<float*>(out);
  p.sq = sq;
  p.skv = skv;
  p.nh = nh;
  p.nkv = nkv;
  p.nqt = l.nqt;
  p.nkt = l.nkt;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.q_offset = q_offset;
  p.scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return f32::launch<32>(p, batch, s);
    case 64: return f32::launch<64>(p, batch, s);
    case 128: return f32::launch<128>(p, batch, s);
    case 256: return f32::launch<256>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// The float32 path's scratch for these sizes: counts[0] float16 values and
// counts[1] int32 values.
extern "C" void repro_flash_f32_scratch(int batch, int sq, int skv, int nh,
                                        int nkv, int hd, long long* counts) {
  const f32::Layout l = f32::make_layout(batch, sq, skv, nh, nkv, hd);
  counts[0] = l.n_halves();
  counts[1] = static_cast<long long>(batch) * (nh * l.nqt + 2 * nkv * l.nkt);
}

// The float32 path's tiles at head size hd, which the split pass scales
// one by one: rows[0] query rows a block, rows[1] keys a kv tile.
extern "C" void repro_flash_f32_tiles(int hd, int* rows) {
  rows[0] = f32::kBQ;
  rows[1] = f32::kv_tile(hd);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
