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
// arithmetic.  The recurrence is sequential in t, so what bounds this
// version in practice is latency: one step's few hundred dependent
// shared-memory reads and FMAs, 1024 times over, on 160 blocks of 2 warps.
//
// What the design does about it:
// - One block per (batch row, head), N threads.  Thread j holds column j
//   of S in N registers for the whole sequence, so the state never leaves
//   the register file; o_t[j] needs only that column and r_t, u, k_t.
// - r, k and w of kChunk tokens are staged into shared memory together
//   (each read once from device memory, coalesced), so a block
//   synchronises twice per kChunk tokens rather than per token; all N
//   threads then read each r_t[i], k_t[i], w_t[i] at one address
//   (a broadcast).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // tokens staged per pass

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

template <typename T, int N>
__global__ void __launch_bounds__(N)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u,
                const float* __restrict__ state_in, T* __restrict__ out,
                float* __restrict__ state_out, int seq, int heads) {
  __shared__ float sR[kChunk][N], sK[kChunk][N], sW[kChunk][N], sU[N];
  const int j = threadIdx.x;
  const int bi = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int64_t state_base = static_cast<int64_t>(blockIdx.x) * N * N;

  float st[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    st[i] = state_in == nullptr ? 0.f : state_in[state_base + i * N + j];
  sU[j] = u[h * N + j];

  // element (bi, t, h, j) of a (b, s, h, N) tensor
  const int64_t row0 = static_cast<int64_t>(bi) * seq * heads + h;
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int c = 0; c < len; ++c) {
      const int64_t at = (row0 + static_cast<int64_t>(t0 + c) * heads) * N + j;
      sR[c][j] = to_f32(r[at]);
      sK[c][j] = to_f32(k[at]);
      sW[c][j] = to_f32(w[at]);
    }
    __syncthreads();
    for (int c = 0; c < len; ++c) {
      const int64_t at = (row0 + static_cast<int64_t>(t0 + c) * heads) * N + j;
      const float vj = to_f32(v[at]);
      float o = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float kv = sK[c][i] * vj;
        o = fmaf(sR[c][i], fmaf(sU[i], kv, st[i]), o);
        st[i] = fmaf(sW[c][i], st[i], kv);
      }
      out[at] = from_f32<T>(o);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) state_out[state_base + i * N + j] = st[i];
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, const float* state_in,
                   void* out, float* state_out, int batch, int seq,
                   int heads, cudaStream_t stream) {
  wkv6_kernel<T, N><<<batch * heads, N, 0, stream>>>(
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
