// The WKV6 recurrence of RWKV-6 ("Finch") for NVIDIA Hopper (sm_90a).
//
// Per batch row and head, with head size N, over t = 0 .. s-1:
//
//   o_t = r_t (S + diag(u) k_t v_t^T)
//   S   = diag(w_t) S + k_t v_t^T
//
// S is (N, N) float32, k-major (S[i][j] ~ k_i v_j), and starts from the
// given state (zeros when none is given).  r, k, v, w are (b, s, h, N),
// contiguous, float32 or bfloat16; u is (h, N) float32.  The kernel writes
// out (b, s, h, N) in the input dtype and the final state (b, h, N, N)
// float32.  All arithmetic is float32.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   src/repro/kernels/rwkv6/kernel.py  wkv6_kernel  (body _wkv6_kernel)
// and the closed-form fold of an incoming state in its wrapper ops.py::wkv6:
// this kernel starts from the incoming state instead, which is the same
// function.  The TPU kernel's chunked, matmul form exists to feed the MXU;
// here the recurrence runs token by token, as the JAX oracle ref.py does.
//
// What bounds it on an H100: at the serving shape (4 x 1024 tokens, 40
// heads of 64) a call moves 107 MB in bf16 and does 5 N^2 flops a token
// and head (3.4 GFLOP in float32): 0.032 ms of memory, 0.050 ms of float32
// arithmetic.  The recurrence is sequential in t, so what bounds it in
// practice is the issue rate and latency of each token's work on the
// SMs: the shared-memory reads of r, k and w that every lane repeats, the
// bf16 conversions, the FMAs and the staging around them.  The first
// design (one block of N threads per (batch row, head), thread j summing
// o_t[j] as a chain of N dependent FMAs, r, k and w staged synchronously,
// v read from device memory inside the loop) put 2.4 warps on an SM and
// ran at 5% of the bound.
//
// What this design does about it:
// - Value columns split across blocks.  Output column j and state column j
//   depend only on S[:, j] and v[:, j], so one block per (batch row, head,
//   slice of kCols value columns) is exact: 4 slices at N = 64, 640
//   blocks at the serving shape.  The slices of one (b, h) have
//   neighbouring blockIdx.x, so their repeated reads of r, k and w hit L2.
// - Key rows of a column split over G = N / kRowsPerLane adjacent lanes.
//   A lane holds kRowsPerLane = 4 key rows of kColsPerLane = 2 adjacent
//   columns of S in registers (4 warps a block at N = 64, about 19 an
//   SM), so each r, k, w value it reads from shared memory serves two
//   columns.  o_t[j] is G independent partial sums of 4 rows each; the
//   lanes leave them in shared memory and the block sums them once a
//   chunk, so no token waits on a reduction across lanes.
// - r, k, w and the block's slice of v are staged by kChunk tokens with
//   16-byte cp.async into a two-stage ring: the next chunk's copies are in
//   flight while this chunk computes.  A lane reads its 4 rows of r, k
//   and w as one 16-byte (float) or 8-byte (bf16) shared-memory load each,
//   the G lanes of a column pair covering one contiguous row.
// - The recurrence stays token by token in float32 with the operations of
//   ref.py (kv = k v; o += r (u kv + S); S = w S + kv, as FMAs); only the
//   order of o's sum over the key rows changes.  w = 0 gives S = kv
//   exactly.
// cp.async needs 16-byte aligned sources: ops.py hands over r, k, v and w
// at 16-byte aligned addresses (a row of N >= 8 elements is a multiple of
// 16 bytes, so every token's row is then aligned too).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kChunk = 16;       // tokens staged per ring stage
constexpr int kRowsPerLane = 4;  // key rows of S a lane holds ...
constexpr int kColsPerLane = 2;  // ... of this many adjacent value columns

// A stage holds the inputs' bytes as they are: float, or the bits of a
// bfloat16 (a plain integer type, so the __shared__ ring needs no
// constructor).
template <typename T>
struct RawOf {
  using type = float;
};
template <>
struct RawOf<__nv_bfloat16> {
  using type = uint16_t;
};

// 4 and 2 adjacent staged values as floats (bfloat16 -> float is exact).
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  f[0] = q.x;
  f[1] = q.y;
  f[2] = q.z;
  f[3] = q.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&f)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(q.x << 16);
  f[1] = __uint_as_float(q.x & 0xffff0000u);
  f[2] = __uint_as_float(q.y << 16);
  f[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void load2(const float* p, float (&f)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  f[0] = q.x;
  f[1] = q.y;
}
__device__ __forceinline__ void load2(const uint16_t* p, float (&f)[2]) {
  const uint32_t q = *reinterpret_cast<const uint32_t*>(p);
  f[0] = __uint_as_float(q << 16);
  f[1] = __uint_as_float(q & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T, int N>
struct Shape {
  static constexpr int kCopyE = 16 / sizeof(T);   // elements a copy
  static constexpr int kCols = N < 16 ? N : 16;   // value columns a block
  static constexpr int kSlices = N / kCols;       // blocks a (b, h)
  static constexpr int kGroups = kCols / kColsPerLane;  // column pairs
  static constexpr int kG = N / kRowsPerLane;     // lanes a column pair
  static constexpr int kThreads = kGroups * kG;
  static constexpr int kRowCopies = N / kCopyE;   // a token's row of r
  static constexpr int kVCopies = kCols / kCopyE; // a token's slice of v
  static_assert(kRowCopies >= 1 && kVCopies >= 1, "16-byte copies");
};

template <typename T, int N>
struct alignas(16) Stage {
  using Raw = typename RawOf<T>::type;
  Raw r[kChunk][N], k[kChunk][N], w[kChunk][N];
  Raw v[kChunk][Shape<T, N>::kCols];
};

// Copy tokens [0, len) of the chunk whose first token's row starts at
// element ``at`` (r, k, w: whole rows; v: the block's columns).
template <typename T, int N>
__device__ __forceinline__ void issue_chunk(
    Stage<T, N>& st, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w, int64_t at,
    int64_t token_stride, int len, int col0) {
  using S = Shape<T, N>;
#pragma unroll
  for (int p = threadIdx.x; p < kChunk * S::kRowCopies; p += S::kThreads) {
    const int c = p / S::kRowCopies;
    const int e0 = p % S::kRowCopies * S::kCopyE;
    if (c < len) {
      const int64_t src = at + c * token_stride + e0;
      cp_async16(&st.r[c][e0], r + src);
      cp_async16(&st.k[c][e0], k + src);
      cp_async16(&st.w[c][e0], w + src);
    }
  }
#pragma unroll
  for (int p = threadIdx.x; p < kChunk * S::kVCopies; p += S::kThreads) {
    const int c = p / S::kVCopies;
    const int e0 = p % S::kVCopies * S::kCopyE;
    if (c < len) cp_async16(&st.v[c][e0], v + at + c * token_stride + col0 + e0);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(Shape<T, N>::kThreads)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u,
                const float* __restrict__ state_in, T* __restrict__ out,
                float* __restrict__ state_out, int seq, int heads) {
  using S = Shape<T, N>;
  constexpr int kR = kRowsPerLane, kC = kColsPerLane, kG = S::kG;
  constexpr int kCols = S::kCols, kGroups = S::kGroups;
  __shared__ Stage<T, N> ring[2];
  // o's partial sums: [token][column within the pair][pair][lane]
  __shared__ __align__(16) float sP[kChunk][kC][kGroups][kG];

  const int pair = threadIdx.x / kG;
  const int g = threadIdx.x % kG;    // key rows g kR .. g kR + kR - 1
  const int bh = blockIdx.x / S::kSlices;
  const int col0 = (blockIdx.x % S::kSlices) * kCols;
  const int j = col0 + pair * kC;    // first of this lane's value columns
  const int bi = bh / heads;
  const int h = bh % heads;
  const int64_t state_base = static_cast<int64_t>(bh) * N * N;
  // element (bi, t, h, 0) of a (b, s, h, N) tensor: base + t token_stride
  const int64_t token_stride = static_cast<int64_t>(heads) * N;
  const int64_t base = (static_cast<int64_t>(bi) * seq * heads + h) * N;

  float st[kC][kR], uu[kR];
#pragma unroll
  for (int e = 0; e < kR; ++e) {
    const int i = g * kR + e;
    uu[e] = u[h * N + i];
#pragma unroll
    for (int x = 0; x < kC; ++x)
      st[x][e] = state_in == nullptr ? 0.f
                                     : state_in[state_base + i * N + j + x];
  }

  const int chunks = (seq + kChunk - 1) / kChunk;
  if (chunks > 0)
    issue_chunk<T, N>(ring[0], r, k, v, w, base, token_stride,
                      min(kChunk, seq), col0);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kChunk;
    const int len = min(kChunk, seq - t0);
    if (ci + 1 < chunks)
      issue_chunk<T, N>(ring[(ci + 1) & 1], r, k, v, w,
                        base + (t0 + kChunk) * token_stride, token_stride,
                        min(kChunk, seq - t0 - kChunk), col0);
    cp_async_commit();   // possibly empty: one group an iteration
    cp_async_wait_one(); // this chunk's copies (this thread's) have landed
    __syncthreads();     // ... and every thread's; sP is free again
    const Stage<T, N>& cur = ring[ci & 1];
    for (int c = 0; c < len; ++c) {
      float rr[kR], kk[kR], ww[kR], vv[kC], o[kC];
      load4(&cur.r[c][g * kR], rr);
      load4(&cur.k[c][g * kR], kk);
      load4(&cur.w[c][g * kR], ww);
      load2(&cur.v[c][pair * kC], vv);
#pragma unroll
      for (int x = 0; x < kC; ++x) o[x] = 0.f;
#pragma unroll
      for (int e = 0; e < kR; ++e) {
#pragma unroll
        for (int x = 0; x < kC; ++x) {
          const float kv = kk[e] * vv[x];
          o[x] = fmaf(rr[e], fmaf(uu[e], kv, st[x][e]), o[x]);
          st[x][e] = fmaf(ww[e], st[x][e], kv);
        }
      }
#pragma unroll
      for (int x = 0; x < kC; ++x) sP[c][x][pair][g] = o[x];
    }
    __syncthreads();     // the stage is consumed and sP is complete
    // this chunk's outputs: each the sum of its column's kG partials
    for (int p = threadIdx.x; p < len * kCols; p += S::kThreads) {
      const int c = p / kCols;
      const int jl = p % kCols;
      const float* part = sP[c][jl % kC][jl / kC];
      float o = 0.f;
#pragma unroll
      for (int g2 = 0; g2 < kG; ++g2) o += part[g2];
      out[base + (t0 + c) * token_stride + col0 + jl] = from_f32<T>(o);
    }
  }
#pragma unroll
  for (int e = 0; e < kR; ++e) {
    const int i = g * kR + e;
#pragma unroll
    for (int x = 0; x < kC; ++x)
      state_out[state_base + i * N + j + x] = st[x][e];
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, const float* state_in,
                   void* out, float* state_out, int batch, int seq,
                   int heads, cudaStream_t stream) {
  using S = Shape<T, N>;
  for (const void* p : {r, k, v, w})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;  // cp.async needs 16 bytes
  const int64_t blocks = static_cast<int64_t>(batch) * heads * S::kSlices;
  wkv6_kernel<T, N><<<static_cast<unsigned>(blocks), S::kThreads, 0,
                      stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, state_in,
      static_cast<T*>(out), state_out, seq, heads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* r, const void* k, const void* v,
                     const void* w, const float* u, const float* state_in,
                     void* out, float* state_out, int batch, int seq,
                     int heads, int n, cudaStream_t stream) {
  switch (n) {
    case 8:
      return launch<T, 8>(r, k, v, w, u, state_in, out, state_out, batch,
                          seq, heads, stream);
    case 16:
      return launch<T, 16>(r, k, v, w, u, state_in, out, state_out, batch,
                           seq, heads, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, state_in, out, state_out, batch,
                           seq, heads, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, state_in, out, state_out, batch,
                           seq, heads, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with ops.py: 0 = float32, 1 = bfloat16.
// state_in may be null (zero initial state).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* state_in,
                          void* out, void* state_out, int batch, int seq,
                          int heads, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* si = static_cast<const float*>(state_in);
  float* so = static_cast<float*>(state_out);
  if (dtype == 0)
    return launch_n<float>(r, k, v, w, uf, si, out, so, batch, seq, heads, n,
                           s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(r, k, v, w, uf, si, out, so, batch, seq,
                                   heads, n, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
