// Fused consensus + gradient-tracking step of INTERACT (eqs. 6 and 10),
// and the bare consensus combine, for NVIDIA Hopper (sm_90a).
//
//   consensus_step:  x_out = M @ x - alpha * u
//                    u_out = M @ u + (p - p_prev)
//   consensus_mix:   out   = M @ x
//
// M is (m, m) float32; every stream is (m, D) row-major, float32 or
// bfloat16.  Sums run in float32 with plain FMA (no tensor cores) and the
// outputs are written in the input dtype.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/consensus_step/kernel.py  consensus_step_kernel
//                                               (body _consensus_kernel)
//   src/repro/kernels/consensus_step/kernel.py  consensus_mix_kernel
//                                               (body _mix_kernel)
//
// What bounds it on an H100: memory.  For m <= 16 agents the step does
// 4 m^2 D + 4 m D flops on 6 m D values (about m/6 flop per byte in
// float32), far below the card's float32 balance of ~20 flop per byte, so
// the least time is the bytes over 3.35 TB/s.  At the Section-6 shape
// (m = 5, D = 760) one launch moves 91 KB and is bound by the launch
// itself, not by either rate.
//
// What the design does about it: every input byte is read from device
// memory once and every output byte written once.  Each block owns a tile
// of kThreads columns, one column per thread, so a warp's loads and stores
// of one row are 128 contiguous bytes.  M sits in dynamic shared memory
// (read by all threads of a warp at one address: a broadcast).  A thread
// streams down its column once per pass of kRows output rows, keeping the
// kRows partial sums of both products in registers; for m <= kRows that is
// a single pass.  The ragged D edge is masked here, so no padding copy is
// made (the TPU kernel zero-pads D to its 512-wide tile).  alpha is a
// runtime argument (the TPU kernel bakes it in at trace time).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // D columns per block, one per thread
constexpr int kRows = 16;      // output rows accumulated in registers per pass

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

__device__ __forceinline__ void stage_matrix(const float* __restrict__ M,
                                             float* sM, int m) {
  for (int k = threadIdx.x; k < m * m; k += blockDim.x) sM[k] = M[k];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    consensus_step_kernel(const float* __restrict__ M,
                          const T* __restrict__ x, const T* __restrict__ u,
                          const T* __restrict__ p, const T* __restrict__ pp,
                          T* __restrict__ xo, T* __restrict__ uo, int m,
                          int64_t D, float alpha) {
  extern __shared__ float sM[];
  stage_matrix(M, sM, m);
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  for (int i0 = 0; i0 < m; i0 += kRows) {
    float ax[kRows], au[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ax[r] = 0.f;
      au[r] = 0.f;
    }
    for (int j = 0; j < m; ++j) {
      const float xv = to_f32(x[j * D + d]);
      const float uv = to_f32(u[j * D + d]);
      const float* w = sM + i0 * m + j;  // M[i0 + r, j] is w[r * m]
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < m) {
          ax[r] = fmaf(w[r * m], xv, ax[r]);
          au[r] = fmaf(w[r * m], uv, au[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < m) {
        const int64_t k = i * D + d;
        xo[k] = from_f32<T>(ax[r] - alpha * to_f32(u[k]));
        uo[k] = from_f32<T>(au[r] + (to_f32(p[k]) - to_f32(pp[k])));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    consensus_mix_kernel(const float* __restrict__ M,
                         const T* __restrict__ x, T* __restrict__ out, int m,
                         int64_t D) {
  extern __shared__ float sM[];
  stage_matrix(M, sM, m);
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  for (int i0 = 0; i0 < m; i0 += kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int j = 0; j < m; ++j) {
      const float xv = to_f32(x[j * D + d]);
      const float* w = sM + i0 * m + j;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < m) acc[r] = fmaf(w[r * m], xv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < m) out[i * D + d] = from_f32<T>(acc[r]);
    }
  }
}

// Shared memory above 48 KB must be opted into per kernel.
template <typename Kernel>
cudaError_t reserve_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

unsigned num_blocks(int64_t D) {
  return static_cast<unsigned>((D + kThreads - 1) / kThreads);
}

template <typename T>
cudaError_t launch_step(const void* M, const void* x, const void* u,
                        const void* p, const void* pp, void* xo, void* uo,
                        int m, int64_t D, float alpha, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * m * sizeof(float);
  cudaError_t err = reserve_shared(consensus_step_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  consensus_step_kernel<T><<<num_blocks(D), kThreads, smem, stream>>>(
      static_cast<const float*>(M), static_cast<const T*>(x),
      static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<const T*>(pp), static_cast<T*>(xo), static_cast<T*>(uo), m,
      D, alpha);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mix(const void* M, const void* x, void* out, int m,
                       int64_t D, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * m * sizeof(float);
  cudaError_t err = reserve_shared(consensus_mix_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  consensus_mix_kernel<T><<<num_blocks(D), kThreads, smem, stream>>>(
      static_cast<const float*>(M), static_cast<const T*>(x),
      static_cast<T*>(out), m, D);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with ops.py: 0 = float32, 1 = bfloat16.
extern "C" int repro_consensus_step(const void* M, const void* x,
                                    const void* u, const void* p,
                                    const void* pp, void* xo, void* uo, int m,
                                    long long D, float alpha, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_step<float>(M, x, u, p, pp, xo, uo, m, D, alpha, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16>(M, x, u, p, pp, xo, uo, m, D, alpha, s);
  return cudaErrorInvalidValue;
}

extern "C" int repro_consensus_mix(const void* M, const void* x, void* out,
                                   int m, long long D, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_mix<float>(M, x, out, m, D, s);
  if (dtype == 1) return launch_mix<__nv_bfloat16>(M, x, out, m, D, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
