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
// Two kernels, one per input dtype; both keep the running max, sum and
// output in float32 registers across a loop over the kv tiles that the
// query tile can see (the TPU kernel's sequential kv grid axis), so a
// sliding-window layer costs O(s * window), and both mask columns past the
// keys in place.
//
// What bounds them on an H100: operations.  A layer does 4 hd flops per
// visible (query, key) pair and head; at the serving shape (4 x 4608
// tokens, 8 heads, hd = 256) that is 348 GFLOP against 226 MB of q, k, v
// and out in bf16, some 1500 flops a byte, far above the card's balance.
//
// float32 (repro_flash_attention): products as float32 FMAs on the CUDA
// cores, exact to float32 rounding, which the port's float32 serving check
// across 26 layers needs; its ceiling is the 67 TFLOP/s float32 rate.
// - One block of 256 threads per (query tile of kBQ = 64 rows, query head,
//   batch row), a 16 x 16 thread grid.  Thread (ty, tx) owns query rows
//   ty + 16 i and, in the score tile, key columns tx + 16 j; in the output
//   tile, head-dim columns tx + 16 j.  The 16 threads of a row share one
//   half-warp, so row max and row sum are half-warp shuffles.
// - q, k and v tiles are converted to float32 once, into shared memory;
//   q and k rows are padded by one float against bank conflicts.  At
//   hd = 256, with kBK = 32 keys a tile, q + k + v + the probability tile
//   take 137 KB; smaller heads use kBK = 64.
//
// bfloat16 (repro_flash_attention_tc): both products on the tensor cores
// with wgmma, bf16 operands, float32 sums (989 TFLOP/s dense).
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: the FMA kernel.
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kBQ = 64;        // query rows per block
constexpr int kRowsPerThread = kBQ / 16;

template <int HD>
struct Tile {
  static constexpr int kBK = HD >= 256 ? 32 : 64;  // keys per kv tile
  static constexpr int kQStride = HD + 1;           // padded q/k rows
  static constexpr int kPStride = kBK + 1;
  static constexpr size_t kSmemFloats =
      static_cast<size_t>(kBQ) * kQStride      // q tile
      + static_cast<size_t>(kBK) * kQStride    // k tile
      + static_cast<size_t>(kBK) * HD          // v tile
      + static_cast<size_t>(kBQ) * kPStride;   // probabilities
  static constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
};

// Max and sum over the 16 lanes of a half-warp (xor offsets stay inside it).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  using Cfg = Tile<HD>;
  constexpr int kBK = Cfg::kBK;
  constexpr int kColsPerThread = kBK / 16;
  constexpr int kDimsPerThread = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * Cfg::kQStride;
  float* sV = sK + kBK * Cfg::kQStride;
  float* sP = sV + kBK * HD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (p.nh / p.nkv);

  const float* __restrict__ qg = static_cast<const float*>(p.q) +
                                 bi * p.q_sb + h * p.q_sh;
  const float* __restrict__ kg = static_cast<const float*>(p.k) +
                                 bi * p.k_sb + hk * p.k_sh;
  const float* __restrict__ vg = static_cast<const float*>(p.v) +
                                 bi * p.v_sb + hk * p.v_sh;

  // q tile -> shared (rows past sq are zeros and are never written out)
  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = q0 + r;
    sQ[r * Cfg::kQStride + d] =
        row < p.sq ? qg[row * p.q_ss + d] : 0.f;
  }

  // The keys any row of this tile can see: [kv_lo, kv_hi).
  const int row_first = q0 + p.q_offset;
  const int row_last = min(q0 + kBQ, p.sq) - 1 + p.q_offset;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, row_last + 1);
  if (p.window > 0) kv_lo = max(0, row_first - p.window + 1);

  float acc[kRowsPerThread][kDimsPerThread];
  float m_run[kRowsPerThread], l_run[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int col = k0 + c;
      const bool in = col < p.skv;
      sK[c * Cfg::kQStride + d] = in ? kg[col * p.k_ss + d] : 0.f;
      sV[c * HD + d] = in ? vg[col * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = sQ[(ty + 16 * i) * Cfg::kQStride + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = sK[(tx + 16 * j) * Cfg::kQStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax, rescale
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = q0 + ty + 16 * i + p.q_offset;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool visible = col < p.skv;
        if (p.causal) visible = visible && row >= col;
        if (p.window > 0) visible = visible && row - col < p.window;
        s[i][j] = visible ? x : -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      tile_max = half_warp_max(tile_max);
      const float m_new = fmaxf(m_run[i], tile_max);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float e = expf(s[i][j] - m_safe);  // exp(-inf) = 0
        sP[(ty + 16 * i) * Cfg::kPStride + tx + 16 * j] = e;
        row_sum += e;
      }
      row_sum = half_warp_sum(row_sum);
      const float corr = expf(m_run[i] - m_safe);
      l_run[i] = l_run[i] * corr + row_sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += p @ v
#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = sP[(ty + 16 * i) * Cfg::kPStride + c];
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j) {
        const float vv = sV[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  float* __restrict__ out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
    float* o = out + ((static_cast<int64_t>(bi) * p.sq + row) * p.nh + h) * HD;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j)
      o[tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.nh, batch);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_hd(const Params& p, int batch, int hd,
                      cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(p, batch, stream);
    case 64: return launch<64>(p, batch, stream);
    case 128: return launch<128>(p, batch, stream);
    case 256: return launch<256>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel.
namespace tc {

constexpr int kWarpgroups = 2;             // consumers of one kv ring
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQ = 64 * kWarpgroups;      // query rows: 64 (wgmma's M) each
constexpr int kBK = 64;                    // keys per kv tile: S's N
constexpr float kLog2e = 1.4426950408889634f;

// P . V takes P as kPTerms bf16 terms: 2, the default, is bf16(p) +
// bf16(p - bf16(p)); 1 is bf16(p) alone, built only to time the second
// term (python -m repro_torch.kernels.flash_attention.bench_p_terms).
#ifndef REPRO_FLASH_P_TERMS
#define REPRO_FLASH_P_TERMS 2
#endif
constexpr int kPTerms = REPRO_FLASH_P_TERMS;
static_assert(kPTerms == 1 || kPTerms == 2, "P is one or two bf16 terms");

// Operand tiles of 64 rows x HD bf16 in shared memory, in the swizzled
// layout that wgmma's descriptors read: a row is cut into column blocks of
// kSwizzle bytes (64 elements; at HD = 32 the whole 64-byte row), each
// column block holds its 64 rows at kSwizzle bytes a row, and within each
// group of 8 rows the 16-byte chunks of a row are permuted by XOR with the
// row's index (address bits [4, 7) ^= bits [7, 10) for the 128-byte
// swizzle, bits [4, 6) ^= bits [7, 9) for the 64-byte one).
template <int HD>
struct Cfg {
  static constexpr int kSwizzle = HD >= 64 ? 128 : 64;
  static constexpr int kChunksPerBlock = kSwizzle / 16;
  static constexpr int kBlockBytes = 64 * kSwizzle;   // one column block
  static constexpr int kTileBytes = 64 * HD * 2;
  // descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
  // a q tile per warpgroup, then k and v in two stages; +1024 to align
  // the base to the swizzle
  static constexpr int kSmemBytes = (kWarpgroups + 4) * kTileBytes + 1024;
};

__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// Byte offset, in a tile, of 16-byte chunk c (of HD / 8) of row r.
template <int HD>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  using C = Cfg<HD>;
  const int cb = c / C::kChunksPerBlock, cc = c % C::kChunksPerBlock;
  return cb * C::kBlockBytes +
         swizzle(r * C::kSwizzle + cc * 16, C::kChunksPerBlock - 1);
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
template <int HD>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int ks) {
  using C = Cfg<HD>;
  const int byte = ks * 32;
  return make_desc(tile + (byte / C::kSwizzle) * C::kBlockBytes +
                       byte % C::kSwizzle,
                   16, 8 * C::kSwizzle, C::kLayout);
}

// V as the MN-major B of O += P . V, k-step kk (keys 16 kk .. 16 kk + 15):
// column blocks of 64 head-size columns kBlockBytes apart (LBO), 8-key
// groups kSwizzle * 8 bytes apart (SBO).
template <int HD>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using C = Cfg<HD>;
  return make_desc(tile + kk * 16 * C::kSwizzle, C::kBlockBytes,
                   8 * C::kSwizzle, C::kLayout);
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

// Named barrier 1 over both warpgroups: one arrives, the other waits.
__device__ __forceinline__ void pingpong_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void pingpong_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
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

// Rows [row0, row0 + 64) of a (seq, HD) bf16 matrix with row stride
// `stride` (elements) into a swizzled tile, 16 bytes a cp.async; rows at
// or past `rows` are zero-filled (src-size 0 reads nothing).
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* g,
                                          int64_t stride, int row0,
                                          int rows, int tid) {
  constexpr int kChunks = HD / 8;
#pragma unroll 4
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < rows;
    const __nv_bfloat16* src = in ? g + (row0 + r) * stride + c * 8 : g;
    cp_async16(tile + chunk_offset<HD>(r, c), src, in ? 16 : 0);
  }
}

// S (64 x 64, float32) += Q-tile . K-tile^T: A and B from shared memory,
// both K-major (imm-trans-a = imm-trans-b = 0).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O (64 x N, float32) += P . V-tile: A (P, bf16) from registers, B from
// shared memory, MN-major (imm-trans-b = 1).  N = the head size.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
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
    wgmma_ss_n64(s, desc_kmajor<HD>(sQ, ks), desc_kmajor<HD>(sK, ks),
                 ks > 0);
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
      wgmma_rs<HD>(o, a[t][kk], desc_mnmajor<HD>(sV, kk));
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
    load_tile<HD>(sQ + w * C::kTileBytes, qg, p.q_ss, q0 + 64 * w, p.sq, tid);
  if (n_tiles > 0) {
    load_tile<HD>(sKV, kg, p.k_ss, t0 * kBK, p.skv, tid);
    load_tile<HD>(sKV + C::kTileBytes, vg, p.v_ss, t0 * kBK, p.skv, tid);
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
      load_tile<HD>(nK, kg, p.k_ss, k0 + kBK, p.skv, tid);
      load_tile<HD>(nK + C::kTileBytes, vg, p.v_ss, k0 + kBK, p.skv, tid);
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

}  // namespace

// float32 q, k, v (the FMA kernel).  strides: 9 int64 values, the
// (batch, seq, head) strides of q, k and v in elements.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int sq, int skv, int nh, int nkv, int hd,
                                     const long long* strides, int causal,
                                     int window, float softcap, int q_offset,
                                     void* stream) {
  const Params p = make_params(q, k, v, out, sq, skv, nh, nkv, hd, strides,
                               causal, window, softcap, q_offset);
  return launch_hd(p, batch, hd, static_cast<cudaStream_t>(stream));
}

// bfloat16 q, k, v (the tensor-core kernel).  The pointers and the
// (batch, seq, head) strides must be multiples of 16 bytes.
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

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
