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
// Row-block form (one process of the multi-process ``allgather`` backend,
// which holds the agents row0 .. row0 + rows - 1): x and u are the gathered
// (m, D) tables of every agent, while p, p_prev and the outputs are the
// process's own (rows, D) rows:
//
//   x_out[r] = sum_j M[row0 + r, j] x[j] - alpha * u[row0 + r]
//   u_out[r] = sum_j M[row0 + r, j] u[j] + (p[r] - p_prev[r])
//   out[r]   = sum_j M[row0 + r, j] x[j]                        (mix)
//
// M stays whole in shared memory; only the block's output rows are
// summed, so the work is rows / m of the square launch's.  The block is
// its own instantiation (Form kBlock, entry points *_rows): the square and
// batched forms fix row0 = 0 and rows = m at compile time, since runtime
// bounds and offsets made the square step 1.5x slower at (16, 4M).  The
// block row0 = 0, rows = m does the square kernel's FMAs in the same
// order and gives its bits.
//
// Batched form (a sweep group of B experiments, one launch for all):
// every stream is (B, m, D) contiguous, experiment b at b * m * D; M is
// (B, m, m) with a batch stride of m * m (one matrix per experiment) or
// (1, m, m) with a stride of 0 (one matrix shared by the group); alpha is
// read per experiment from a float32 device array of length B.  The grid's
// y axis is the experiment: blockIdx.y = b offsets every pointer and stages
// experiment b's matrix.  An unbatched call is B = 1 with a stride of 0 and
// alpha passed by value; it runs the kSquare instantiation, which compiles
// the offsets and the alpha read away, so its code is the unbatched
// kernels' as they were.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   src/repro/kernels/consensus_step/kernel.py  consensus_step_kernel
//                                               (body _consensus_kernel)
//   src/repro/kernels/consensus_step/kernel.py  consensus_mix_kernel
//                                               (body _mix_kernel)
//
// What bounds them on an H100: memory.  For m <= 16 agents the step does
// 4 m^2 D + 4 m D flops on 6 m D values (about m/6 flop per byte in
// float32), far below the card's float32 balance of ~20 flop per byte, so
// the least time is the bytes over 3.35 TB/s.  At the Section-6 shape
// (m = 5, D = 760) one launch moves 91 KB and is bound by the launch
// itself, not by either rate.  To reach the HBM rate an SM needs about
// 16-20 KB of loads in flight (3.35 TB/s times a ~0.7 us DRAM latency,
// over 132 SMs).
//
// Common to both: every input byte is read from device memory once and
// every output byte written once.  M sits in dynamic shared memory (read
// by all threads of a warp at one address: a broadcast).  The ragged D
// edge is masked here, so no padding copy is made (the TPU kernel
// zero-pads D to its 512-wide tile).  alpha is a runtime argument (the
// TPU kernel bakes it in at trace time).
//
// consensus_step (the first design): each block owns kThreads columns, one
// column per thread, so a warp's loads and stores of one row are 128
// contiguous bytes.  A thread streams down its column once per pass of
// kRows output rows, keeping the kRows partial sums of both products in
// registers; for m <= kRows that is a single pass.  Each j issues one
// small load per stream before its FMAs, so a thread keeps about two
// loads in flight: 62% of the HBM rate at (16, 4M) float32, faster than
// the pair of addmm calls that computes the same.  The restaging below
// would apply to it as well; it is left as it is until it is the kernel
// that loses the most time.
//
// consensus_mix (redesigned): the first design's loop kept one 4-byte load a
// thread in flight (about 8 KB an SM) and reached 36% of the HBM rate.
// Now each thread owns kV adjacent columns and moves them as one 16-byte
// load or store a row (4 floats, 8 bfloat16), and for m <= kRows it loads
// all m rows into registers before the first FMA, so all of its loads are
// in flight at once (m x 16 bytes a thread: 256 bytes at m = 16), and it
// issues them before staging M, so the two memory latencies overlap (what
// sets the time at the launch-bound Section-6 shape).  The rows stay
// packed in registers (64 registers at m = 16 in either dtype); the
// output rows are then summed kOut at a time and stored as soon as they
// are done, so only kOut x kV partial sums are live.  The
// 16-byte path needs D * itemsize to be a multiple of 16 and both base
// pointers 16-byte aligned (row j then starts on a 16-byte boundary); the
// host picks it only then, and otherwise the same kernel runs with kV = 1
// (4- or 2-byte accesses, still every row's load in flight).  For m >
// kRows the output rows go in passes of kRows, with the input rows
// streamed kChunk at a time (their loads issued together).
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

// Experiment blockIdx.y's slice of a (B, m, D) stream.
template <typename P>
__device__ __forceinline__ P* experiment(P* base, int64_t stride) {
  return base + static_cast<int64_t>(blockIdx.y) * stride;
}

// The three forms of each kernel, one instantiation each: one (m, D)
// problem, B of them (kBatch), or a row block of one (kBlock).
enum Form { kSquare, kBatch, kBlock };

__device__ __forceinline__ void stage_matrix(const float* __restrict__ M,
                                             float* sM, int m) {
  for (int k = threadIdx.x; k < m * m; k += blockDim.x) sM[k] = M[k];
  __syncthreads();
}

template <typename T, Form F>
__global__ void __launch_bounds__(kThreads)
    consensus_step_kernel(const float* __restrict__ M,
                          const T* __restrict__ x, const T* __restrict__ u,
                          const T* __restrict__ p, const T* __restrict__ pp,
                          T* __restrict__ xo, T* __restrict__ uo, int m,
                          int64_t D, int row0, int rows, float alpha,
                          int64_t m_stride, const float* __restrict__ alphas) {
  extern __shared__ float sM[];
  if constexpr (F != kBlock) {  // all m rows, known to the compiler
    row0 = 0;
    rows = m;
  }
  if constexpr (F == kBatch) {
    const int64_t stride = static_cast<int64_t>(m) * D;
    x = experiment(x, stride);
    u = experiment(u, stride);
    p = experiment(p, stride);
    pp = experiment(pp, stride);
    xo = experiment(xo, stride);
    uo = experiment(uo, stride);
    alpha = alphas[blockIdx.y];
    M = experiment(M, m_stride);
  }
  stage_matrix(M, sM, m);
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  for (int i0 = 0; i0 < rows; i0 += kRows) {
    float ax[kRows], au[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ax[r] = 0.f;
      au[r] = 0.f;
    }
    for (int j = 0; j < m; ++j) {
      const float xv = to_f32(x[j * D + d]);
      const float uv = to_f32(u[j * D + d]);
      // M[row0 + i0 + r, j] is w[r * m]
      const float* w = sM + (row0 + i0) * m + j;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i0 + r < rows) {
          ax[r] = fmaf(w[r * m], xv, ax[r]);
          au[r] = fmaf(w[r * m], uv, au[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;  // output row; the table's row is row0 + i
      if (i < rows) {
        const int64_t k = i * D + d;
        const int64_t kt = (row0 + i) * D + d;
        xo[k] = from_f32<T>(ax[r] - alpha * to_f32(u[kt]));
        uo[k] = from_f32<T>(au[r] + (to_f32(p[k]) - to_f32(pp[k])));
      }
    }
  }
}

// 16 bytes of a row as kV floats (kV = 16 / sizeof(T)), and back.
__device__ __forceinline__ void unpack(uint4 raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
// bfloat16 -> float is exact: a shift and a mask.  The asm is volatile so
// that the conversion stays where it is used: hoisted out of the loop over
// output rows, 16 rows of 8 floats would take 128 registers.
__device__ __forceinline__ void unpack(uint4 raw, float (&f)[8]) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t lo, hi;
    asm volatile("shl.b32 %0, %1, 16;" : "=r"(lo) : "r"(words[q]));
    asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(hi) : "r"(words[q]));
    f[2 * q] = __uint_as_float(lo);
    f[2 * q + 1] = __uint_as_float(hi);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t words[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    words[q] = static_cast<uint32_t>(__bfloat16_as_ushort(
                   __float2bfloat16(f[2 * q]))) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(
                    __float2bfloat16(f[2 * q + 1])))
                << 16);
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// kV adjacent elements of a row as they lie in memory: one 16-byte word
// (kV > 1) or one element.  They stay packed in registers until used, so
// 16 rows of bfloat16 take 64 registers, not 128.
template <typename T, int kV>
struct Cols {
  using type = uint4;
};
template <typename T>
struct Cols<T, 1> {
  using type = T;
};

template <typename T, int kV>
__device__ __forceinline__ typename Cols<T, kV>::type load_cols(const T* p) {
  if constexpr (kV == 1) {
    return *p;
  } else {
    static_assert(kV * sizeof(T) == 16, "16-byte accesses only");
    return *reinterpret_cast<const uint4*>(p);
  }
}
template <typename T, int kV>
__device__ __forceinline__ void unpack_cols(typename Cols<T, kV>::type raw,
                                            float (&f)[kV]) {
  if constexpr (kV == 1) {
    f[0] = to_f32(raw);
  } else {
    unpack(raw, f);
  }
}
template <typename T, int kV>
__device__ __forceinline__ void store_cols(T* p, const float (&f)[kV]) {
  if constexpr (kV == 1) {
    *p = from_f32<T>(f[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = pack(f);
  }
}

constexpr int kOut = 4;    // output rows summed together (one pass)
constexpr int kChunk = 4;  // input rows loaded together when m > kRows

// out = M @ x with kV columns a thread.  kOnePass (m <= kRows): every
// row's load is issued first, before M is staged, so the two memory
// latencies overlap; then the output rows, kOut at a time, from the
// packed rows in registers.  Otherwise passes of kRows output rows over
// input rows kChunk at a time.
template <typename T, int kV, bool kOnePass, Form F>
__global__ void __launch_bounds__(kThreads)
    consensus_mix_kernel(const float* __restrict__ M,
                         const T* __restrict__ x, T* __restrict__ out, int m,
                         int64_t D, int row0, int rows, int64_t m_stride) {
  extern __shared__ float sM[];
  if constexpr (F != kBlock) {  // all m rows, known to the compiler
    row0 = 0;
    rows = m;
  }
  if constexpr (F == kBatch) {
    x = experiment(x, static_cast<int64_t>(m) * D);
    out = experiment(out, static_cast<int64_t>(m) * D);
    M = experiment(M, m_stride);
  }
  const int64_t d =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kV;
  const bool live = d < D;
  if constexpr (kOnePass) {
    typename Cols<T, kV>::type xr[kRows];
    if (live) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (j < m) xr[j] = load_cols<T, kV>(x + j * D + d);
    }
    stage_matrix(M, sM, m);
    if (!live) return;
    for (int i0 = 0; i0 < rows; i0 += kOut) {
      float acc[kOut][kV];
#pragma unroll
      for (int r = 0; r < kOut; ++r)
#pragma unroll
        for (int c = 0; c < kV; ++c) acc[r][c] = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < m) {
          float xf[kV];
          unpack_cols<T, kV>(xr[j], xf);
#pragma unroll
          for (int r = 0; r < kOut; ++r) {
            if (i0 + r < rows) {
              const float wr = sM[(row0 + i0 + r) * m + j];
#pragma unroll
              for (int c = 0; c < kV; ++c)
                acc[r][c] = fmaf(wr, xf[c], acc[r][c]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kOut; ++r)
        if (i0 + r < rows) store_cols<T, kV>(out + (i0 + r) * D + d, acc[r]);
    }
  } else {
    stage_matrix(M, sM, m);
    if (!live) return;
    for (int i0 = 0; i0 < rows; i0 += kRows) {
      float acc[kRows][kV];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kV; ++c) acc[r][c] = 0.f;
      for (int j0 = 0; j0 < m; j0 += kChunk) {
        float xr[kChunk][kV];
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          if (j0 + q < m)
            unpack_cols<T, kV>(load_cols<T, kV>(x + (j0 + q) * D + d),
                               xr[q]);
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          if (j0 + q < m) {
            // M[row0 + i0 + r, j0 + q]
            const float* w = sM + (row0 + i0) * m + j0 + q;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (i0 + r < rows) {
                const float wr = w[r * m];
#pragma unroll
                for (int c = 0; c < kV; ++c)
                  acc[r][c] = fmaf(wr, xr[q][c], acc[r][c]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (i0 + r < rows) store_cols<T, kV>(out + (i0 + r) * D + d, acc[r]);
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

// Blocks along D (x) and experiments (y); 65535 experiments at most.
dim3 grid(int64_t D, int B) {
  return dim3(static_cast<unsigned>((D + kThreads - 1) / kThreads),
              static_cast<unsigned>(B));
}

// Every launch of a batch: B in 1..65535, M's batch stride 0 or m * m.
bool bad_batch(int B, int m, long long m_stride) {
  return B < 1 || B > 65535 ||
         (m_stride != 0 && m_stride != static_cast<long long>(m) * m);
}

// A row block: rows >= 1 output rows starting at row0, inside M's m rows.
bool bad_block(int m, int row0, int rows) {
  return row0 < 0 || rows < 1 || row0 > m - rows;
}

// One launch of form F; B = 1 unless F is kBatch, alphas only for kBatch.
template <typename T, Form F>
cudaError_t launch_step(const void* M, const void* x, const void* u,
                        const void* p, const void* pp, void* xo, void* uo,
                        int m, int64_t D, int row0, int rows, float alpha,
                        int B, int64_t m_stride, const float* alphas,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * m * sizeof(float);
  auto kernel = consensus_step_kernel<T, F>;
  cudaError_t err = reserve_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid(D, B), kThreads, smem, stream>>>(
      static_cast<const float*>(M), static_cast<const T*>(x),
      static_cast<const T*>(u), static_cast<const T*>(p),
      static_cast<const T*>(pp), static_cast<T*>(xo), static_cast<T*>(uo), m,
      D, row0, rows, alpha, m_stride, alphas);
  return cudaGetLastError();
}

template <typename T, int kV, bool kOnePass, Form F>
cudaError_t launch_mix_kernel(const void* M, const void* x, void* out, int m,
                              int64_t D, int row0, int rows, int B,
                              int64_t m_stride, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * m * sizeof(float);
  auto kernel = consensus_mix_kernel<T, kV, kOnePass, F>;
  cudaError_t err = reserve_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t units = (D + kV - 1) / kV;  // column groups, one a thread
  kernel<<<grid(units, B), kThreads, smem, stream>>>(
      static_cast<const float*>(M), static_cast<const T*>(x),
      static_cast<T*>(out), m, D, row0, rows, m_stride);
  return cudaGetLastError();
}

// vec != 0 asks for 16-byte accesses; refused unless every row of x and
// out starts on a 16-byte boundary, so no access is ever misaligned (the
// experiments of a batch lie m * D elements apart, so the rows of every
// experiment start on one when experiment 0's do).
template <typename T, Form F>
cudaError_t launch_mix(const void* M, const void* x, void* out, int m,
                       int64_t D, int row0, int rows, int B,
                       int64_t m_stride, int vec, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (vec) {
    const bool aligned = (D * sizeof(T)) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!aligned) return cudaErrorMisalignedAddress;
    return m <= kRows
               ? launch_mix_kernel<T, kV, true, F>(M, x, out, m, D, row0,
                                                   rows, B, m_stride, stream)
               : launch_mix_kernel<T, kV, false, F>(M, x, out, m, D, row0,
                                                    rows, B, m_stride, stream);
  }
  return m <= kRows
             ? launch_mix_kernel<T, 1, true, F>(M, x, out, m, D, row0, rows,
                                                B, m_stride, stream)
             : launch_mix_kernel<T, 1, false, F>(M, x, out, m, D, row0, rows,
                                                 B, m_stride, stream);
}

}  // namespace

// dtype codes shared with ops.py: 0 = float32, 1 = bfloat16.  Every
// operand is (m, D).
extern "C" int repro_consensus_step(const void* M, const void* x,
                                    const void* u, const void* p,
                                    const void* pp, void* xo, void* uo, int m,
                                    long long D, float alpha, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_step<float, kSquare>(M, x, u, p, pp, xo, uo, m, D, 0, m,
                                       alpha, 1, 0, nullptr, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16, kSquare>(M, x, u, p, pp, xo, uo, m, D,
                                               0, m, alpha, 1, 0, nullptr, s);
  return cudaErrorInvalidValue;
}

// The row block from row row0: x and u are (m, D); p, pp, xo and uo are
// the block's (rows, D) rows.
extern "C" int repro_consensus_step_rows(const void* M, const void* x,
                                         const void* u, const void* p,
                                         const void* pp, void* xo, void* uo,
                                         int m, long long D, int row0,
                                         int rows, float alpha, int dtype,
                                         void* stream) {
  if (bad_block(m, row0, rows)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_step<float, kBlock>(M, x, u, p, pp, xo, uo, m, D, row0,
                                      rows, alpha, 1, 0, nullptr, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16, kBlock>(M, x, u, p, pp, xo, uo, m, D,
                                              row0, rows, alpha, 1, 0,
                                              nullptr, s);
  return cudaErrorInvalidValue;
}

// B experiments in one launch: streams (B, m, D), M (B, m, m) with
// m_stride = m * m or (1, m, m) with m_stride = 0, alphas (B,) float32 on
// the device.
extern "C" int repro_consensus_step_batched(
    const void* M, const void* x, const void* u, const void* p,
    const void* pp, void* xo, void* uo, int m, long long D, int B,
    long long m_stride, const void* alphas, int dtype, void* stream) {
  if (bad_batch(B, m, m_stride) || alphas == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alphas);
  if (dtype == 0)
    return launch_step<float, kBatch>(M, x, u, p, pp, xo, uo, m, D, 0, m, 0.f,
                                      B, m_stride, a, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16, kBatch>(M, x, u, p, pp, xo, uo, m, D, 0,
                                              m, 0.f, B, m_stride, a, s);
  return cudaErrorInvalidValue;
}

// vec: 1 for 16-byte accesses (ops.py checks the alignment first), 0 for
// element accesses.
extern "C" int repro_consensus_mix(const void* M, const void* x, void* out,
                                   int m, long long D, int dtype, int vec,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mix<float, kSquare>(M, x, out, m, D, 0, m, 1, 0, vec, s);
  if (dtype == 1)
    return launch_mix<__nv_bfloat16, kSquare>(M, x, out, m, D, 0, m, 1, 0,
                                              vec, s);
  return cudaErrorInvalidValue;
}

// The row block from row row0: x is (m, D), out the block's (rows, D) rows.
extern "C" int repro_consensus_mix_rows(const void* M, const void* x,
                                        void* out, int m, long long D,
                                        int row0, int rows, int dtype,
                                        int vec, void* stream) {
  if (bad_block(m, row0, rows)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mix<float, kBlock>(M, x, out, m, D, row0, rows, 1, 0, vec,
                                     s);
  if (dtype == 1)
    return launch_mix<__nv_bfloat16, kBlock>(M, x, out, m, D, row0, rows, 1,
                                             0, vec, s);
  return cudaErrorInvalidValue;
}

// B experiments in one launch: x and out (B, m, D), M as for
// repro_consensus_step_batched.
extern "C" int repro_consensus_mix_batched(const void* M, const void* x,
                                           void* out, int m, long long D,
                                           int B, long long m_stride,
                                           int dtype, int vec, void* stream) {
  if (bad_batch(B, m, m_stride)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mix<float, kBatch>(M, x, out, m, D, 0, m, B, m_stride, vec,
                                     s);
  if (dtype == 1)
    return launch_mix<__nv_bfloat16, kBatch>(M, x, out, m, D, 0, m, B,
                                             m_stride, vec, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
