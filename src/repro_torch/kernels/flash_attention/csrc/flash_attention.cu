// Online-softmax GQA attention (forward) for NVIDIA Hopper (sm_90a).
//
//   out[b, i, h, :] = sum_j softmax_j(cap(q_i . k_j / sqrt(hd))) v_j
//
// over the keys j visible to query row i, which sits at position
// i + q_offset: j < skv, j <= i + q_offset when causal, and
// i + q_offset - j < window with a sliding window.  cap is the tanh logit
// softcap, cap * tanh(s / cap), when one is given.  q is (b, sq, nh, hd),
// k and v are (b, skv, nkv, hd), float32 or bfloat16, with any strides on
// the first three axes and hd contiguous; query head h reads kv head
// h / (nh / nkv) (grouped-query attention).  The output is (b, sq, nh, hd),
// contiguous, in the input dtype.  A row with no visible key gives 0.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/flash_attention/kernel.py  flash_attention_kernel
//                                                (body _flash_kernel)
// and the padding of its wrapper ops.py::flash_attention: columns >= skv
// are masked here, so no padded copy is made and a ragged or bidirectional
// sequence, or q_offset past the keys, gives what ref.py gives (the JAX
// wrapper's zero-padded keys are visible in those two cases).
//
// What bounds it on an H100: operations.  A layer does 4 hd flops per
// visible (query, key) pair and head; at the serving shape (4 x 4608
// tokens, 8 heads, hd = 256) that is 348 GFLOP against 226 MB of q, k, v
// and out in bf16, some 1500 flops a byte, far above the card's balance.
// This first version does its products with float32 FMAs on the CUDA
// cores, not on the tensor cores, so its ceiling is the 67 TFLOP/s float32
// rate, not the 989 TFLOP/s of bf16 wgmma.  That keeps float32 inputs exact
// to float32 rounding (the port's float32 serving check needs it), and
// leaves wgmma/TMA for a later version.
//
// What the design does about it:
// - One block per (query tile of kBQ = 64 rows, query head, batch row).
//   The TPU kernel's sequential ("arbitrary") kv grid axis becomes a loop
//   inside the block over kv tiles of kBK keys; the running max m, sum l
//   and accumulator stay in registers across it, in float32.
// - Tiles that the causal mask or the window hides entirely are never
//   visited: the loop runs only over [first visible key, last visible key]
//   of the query tile, so a sliding-window layer costs O(s * window).
// - 256 threads as a 16 x 16 grid.  Thread (ty, tx) owns query rows
//   ty + 16 i and, in the score tile, key columns tx + 16 j; in the output
//   tile, head-dim columns tx + 16 j.  The 16 threads of a row share one
//   half-warp, so row max and row sum are half-warp shuffles, and each
//   thread rescales its own accumulators with no shared-memory round trip.
// - q, k and v tiles are converted to float32 once, into shared memory;
//   q and k rows are padded by one float so the 16 lanes that read 16
//   different key rows at one head-dim index hit 16 different banks.
// - hd = 256 is the hard case: the q tile alone is 64 x 257 floats (66 KB).
//   With kBK = 32 keys a tile, q + k + v + the probability tile take 137 KB
//   of the 227 KB a block may use, and the 64 x 256 accumulator is 64
//   registers a thread.  Smaller heads use kBK = 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kBQ = 64;        // query rows per block
constexpr int kRowsPerThread = kBQ / 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T, int HD>
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

  const T* __restrict__ qg = static_cast<const T*>(p.q) + bi * p.q_sb +
                             h * p.q_sh;
  const T* __restrict__ kg = static_cast<const T*>(p.k) + bi * p.k_sb +
                             hk * p.k_sh;
  const T* __restrict__ vg = static_cast<const T*>(p.v) + bi * p.v_sb +
                             hk * p.v_sh;

  // q tile -> shared (rows past sq are zeros and are never written out)
  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = q0 + r;
    sQ[r * Cfg::kQStride + d] =
        row < p.sq ? to_f32(qg[row * p.q_ss + d]) : 0.f;
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
      sK[c * Cfg::kQStride + d] = in ? to_f32(kg[col * p.k_ss + d]) : 0.f;
      sV[c * HD + d] = in ? to_f32(vg[col * p.v_ss + d]) : 0.f;
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

  T* __restrict__ out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float inv = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
    T* o = out + ((static_cast<int64_t>(bi) * p.sq + row) * p.nh + h) * HD;
#pragma unroll
    for (int j = 0; j < kDimsPerThread; ++j)
      o[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.nh, batch);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int batch, int hd,
                      cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with ops.py: 0 = float32, 1 = bfloat16.
// strides: 9 int64 values, (batch, seq, head) strides of q, k and v.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int batch,
                                     int sq, int skv, int nh, int nkv, int hd,
                                     const long long* strides, int causal,
                                     int window, float softcap, int q_offset,
                                     int dtype, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(p, batch, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(p, batch, hd, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
