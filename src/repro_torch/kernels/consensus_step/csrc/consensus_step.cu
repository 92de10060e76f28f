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
// consensus_step (redesigned): the first design gave a thread one column
// and walked j = 0 .. m-1 with one 4-byte load of x and one of u before
// each j's FMAs (about two loads in flight a thread), staged M before the
// first of them, and loaded u's own row, p and p_prev only after the j
// loop: 62% of the HBM rate at (16, 4M) float32, 38% for a block of 4 of
// its 16 rows, and a chain of about m + 2 memory latencies at 5x760.  Now
// it moves kV adjacent columns a thread in 16-byte accesses as the mix
// does, issues the loads of a stream's rows together and before M is
// staged, and takes u's own rows for alpha * u from the registers that
// hold u's rows.  How the two streams share the registers depends on m
// (``Staging``; kV = 4 floats or 8 bfloat16 a row, 4 registers packed):
//   kBothStreams, m <= kBothRows (8: the path's 4, 5 and 8 agents): every
//     row of x and u and the block's rows of p and p_prev load at once
//     (one memory round, up to 32 x 16 bytes in flight a thread), then the
//     output rows are summed kGroup at a time, both products together.
//   kEachStream, m <= kRows (16): both streams' rows would take 128
//     registers, so one stream at a time, all its rows in flight: u's rows
//     with the first group's rows of p and p_prev, then x's rows.  Each
//     group's epilogue operands for the next group are issued as soon as
//     its outputs are stored.  x's first group takes its own rows of u
//     from the registers that held u (a row block of up to kGroup rows
//     reloads none); later groups load theirs again, an L2 hit.
//   kPasses, m > kRows: passes of kPass output rows over each stream's
//     rows, streamed kChunk at a time.
// Every output is one fmaf chain over j ascending from 0, and the epilogue
// is acc - alpha * u and acc + (p - p_prev), as in the first design: every
// form, path and staging gives the first design's bits.
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

constexpr int kThreads = 256;      // column groups a block, one a thread
// the same for consensus_step: its kEachStream instantiations take over
// 128 registers, so an SM holds 3 blocks of 128 threads but 1 of 256
constexpr int kStepThreads = 128;
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

// a[k] for a k known only at run time, by selects: indexing a register
// array at run time would move it to local memory.
template <typename C, int kN>
__device__ __forceinline__ C pick(const C (&a)[kN], int k) {
  C v = a[0];
#pragma unroll
  for (int j = 1; j < kN; ++j)
    if (j == k) v = a[j];
  return v;
}

// acc[r] = sum_j w[r * m + j] * rows[j] for r < nout, one fmaf chain over
// j ascending from 0 (w: the group's first row of M).
template <typename T, int kV, int kN, int kG>
__device__ __forceinline__ void sum_rows(
    float (&acc)[kG][kV], const typename Cols<T, kV>::type (&rows)[kN],
    const float* w, int m, int nout) {
#pragma unroll
  for (int r = 0; r < kG; ++r)
#pragma unroll
    for (int c = 0; c < kV; ++c) acc[r][c] = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (j < m) {
      float f[kV];
      unpack_cols<T, kV>(rows[j], f);
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        if (r < nout) {
          const float wr = w[r * m + j];
#pragma unroll
          for (int c = 0; c < kV; ++c) acc[r][c] = fmaf(wr, f[c], acc[r][c]);
        }
      }
    }
  }
}

// sum_rows over both streams at once, each weight read once for both.
template <typename T, int kV, int kN, int kG>
__device__ __forceinline__ void sum_both(
    float (&ax)[kG][kV], float (&au)[kG][kV],
    const typename Cols<T, kV>::type (&xr)[kN],
    const typename Cols<T, kV>::type (&ur)[kN], const float* w, int m,
    int nout) {
#pragma unroll
  for (int r = 0; r < kG; ++r)
#pragma unroll
    for (int c = 0; c < kV; ++c) ax[r][c] = au[r][c] = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (j < m) {
      float xf[kV], uf[kV];
      unpack_cols<T, kV>(xr[j], xf);
      unpack_cols<T, kV>(ur[j], uf);
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        if (r < nout) {
          const float wr = w[r * m + j];
#pragma unroll
          for (int c = 0; c < kV; ++c) {
            ax[r][c] = fmaf(wr, xf[c], ax[r][c]);
            au[r][c] = fmaf(wr, uf[c], au[r][c]);
          }
        }
      }
    }
  }
}

// sum_rows with the rows read from src, kChunk at a time (m > kRows).
template <typename T, int kV, int kP>
__device__ __forceinline__ void sum_streamed(float (&acc)[kP][kV],
                                             const T* __restrict__ src,
                                             int64_t D, int64_t d,
                                             const float* w, int m,
                                             int nout) {
#pragma unroll
  for (int r = 0; r < kP; ++r)
#pragma unroll
    for (int c = 0; c < kV; ++c) acc[r][c] = 0.f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    typename Cols<T, kV>::type rows[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (j0 + q < m) rows[q] = load_cols<T, kV>(src + (j0 + q) * D + d);
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (j0 + q < m) {
        float f[kV];
        unpack_cols<T, kV>(rows[q], f);
#pragma unroll
        for (int r = 0; r < kP; ++r) {
          if (r < nout) {
            const float wr = w[r * m + j0 + q];
#pragma unroll
            for (int c = 0; c < kV; ++c)
              acc[r][c] = fmaf(wr, f[c], acc[r][c]);
          }
        }
      }
    }
  }
}

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
      sum_rows<T, kV, kRows, kOut>(acc, xr, sM + (row0 + i0) * m, m,
                                   rows - i0);
#pragma unroll
      for (int r = 0; r < kOut; ++r)
        if (i0 + r < rows) store_cols<T, kV>(out + (i0 + r) * D + d, acc[r]);
    }
  } else {
    stage_matrix(M, sM, m);
    if (!live) return;
    for (int i0 = 0; i0 < rows; i0 += kRows) {
      float acc[kRows][kV];
      sum_streamed<T, kV, kRows>(acc, x, D, d, sM + (row0 + i0) * m, m,
                                 rows - i0);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (i0 + r < rows) store_cols<T, kV>(out + (i0 + r) * D + d, acc[r]);
    }
  }
}

// How consensus_step holds its two streams (see the header).
enum Staging { kBothStreams, kEachStream, kPasses };
constexpr int kBothRows = 8;  // m <= kBothRows: kBothStreams
constexpr int kPass = 8;      // output rows a pass for m > kRows

// Output rows summed together: 16 partial sums a stream in either dtype.
template <int kV>
constexpr int kGroup = kV > 4 ? 2 : 4;

// The two epilogues, element by element as the first design wrote them.
template <typename T, int kV>
__device__ __forceinline__ void store_x(T* out, const float (&acc)[kV],
                                        typename Cols<T, kV>::type u_own,
                                        float alpha) {
  float uf[kV], o[kV];
  unpack_cols<T, kV>(u_own, uf);
#pragma unroll
  for (int c = 0; c < kV; ++c) o[c] = acc[c] - alpha * uf[c];
  store_cols<T, kV>(out, o);
}
template <typename T, int kV>
__device__ __forceinline__ void store_u(T* out, const float (&acc)[kV],
                                        typename Cols<T, kV>::type p,
                                        typename Cols<T, kV>::type pp) {
  float pf[kV], ppf[kV], o[kV];
  unpack_cols<T, kV>(p, pf);
  unpack_cols<T, kV>(pp, ppf);
#pragma unroll
  for (int c = 0; c < kV; ++c) o[c] = acc[c] + (pf[c] - ppf[c]);
  store_cols<T, kV>(out, o);
}

// x_out = M @ x - alpha * u and u_out = M @ u + (p - p_prev) with kV
// columns a thread, staged as S says (see the header).  Output row i is
// the table's row row0 + i.  The 1 in the launch bounds keeps ptxas from
// trading registers for occupancy: without it, it capped some kEachStream
// and kPasses instantiations at an occupancy step and spilled.
template <typename T, int kV, Staging S, Form F>
__global__ void __launch_bounds__(kStepThreads, 1)
    consensus_step_kernel(const float* __restrict__ M,
                          const T* __restrict__ x, const T* __restrict__ u,
                          const T* __restrict__ p, const T* __restrict__ pp,
                          T* __restrict__ xo, T* __restrict__ uo, int m,
                          int64_t D, int row0, int rows, float alpha,
                          int64_t m_stride, const float* __restrict__ alphas) {
  using C = typename Cols<T, kV>::type;
  constexpr int kG = kGroup<kV>;
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
  const int64_t d =
      (static_cast<int64_t>(blockIdx.x) * kStepThreads + threadIdx.x) * kV;
  const bool live = d < D;
  if constexpr (S == kBothStreams) {
    C xr[kBothRows], ur[kBothRows], pr[kBothRows], ppr[kBothRows];
    if (live) {
#pragma unroll
      for (int j = 0; j < kBothRows; ++j) {
        if (j < m) {
          xr[j] = load_cols<T, kV>(x + j * D + d);
          ur[j] = load_cols<T, kV>(u + j * D + d);
        }
      }
#pragma unroll
      for (int i = 0; i < kBothRows; ++i) {
        if (i < rows) {
          pr[i] = load_cols<T, kV>(p + i * D + d);
          ppr[i] = load_cols<T, kV>(pp + i * D + d);
        }
      }
    }
    stage_matrix(M, sM, m);
    if (!live) return;
#pragma unroll
    for (int i0 = 0; i0 < kBothRows; i0 += kG) {
      if (i0 < rows) {
        float ax[kG][kV], au[kG][kV];
        sum_both<T, kV, kBothRows, kG>(ax, au, xr, ur, sM + (row0 + i0) * m,
                                       m, rows - i0);
#pragma unroll
        for (int r = 0; r < kG; ++r) {
          const int i = i0 + r;
          if (i < rows) {
            store_x<T, kV>(xo + i * D + d, ax[r], pick(ur, row0 + i), alpha);
            store_u<T, kV>(uo + i * D + d, au[r], pr[i], ppr[i]);
          }
        }
      }
    }
  } else if constexpr (S == kEachStream) {
    C sr[kRows];        // one stream's rows: u's, then x's
    C ea[kG], eb[kG];   // a group's epilogue operands: p and p_prev, or u
    if (live) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (j < m) sr[j] = load_cols<T, kV>(u + j * D + d);
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        if (r < rows) {
          ea[r] = load_cols<T, kV>(p + r * D + d);
          eb[r] = load_cols<T, kV>(pp + r * D + d);
        }
      }
    }
    stage_matrix(M, sM, m);
    if (!live) return;
    for (int i0 = 0; i0 < rows; i0 += kG) {
      float acc[kG][kV];
      sum_rows<T, kV, kRows, kG>(acc, sr, sM + (row0 + i0) * m, m, rows - i0);
#pragma unroll
      for (int r = 0; r < kG; ++r)
        if (i0 + r < rows)
          store_u<T, kV>(uo + (i0 + r) * D + d, acc[r], ea[r], eb[r]);
      const int n0 = i0 + kG;  // the next group's rows of p and p_prev
#pragma unroll
      for (int r = 0; r < kG; ++r) {
        if (n0 + r < rows) {
          ea[r] = load_cols<T, kV>(p + (n0 + r) * D + d);
          eb[r] = load_cols<T, kV>(pp + (n0 + r) * D + d);
        }
      }
    }
    // the first group's own rows of u, from the registers, then x's rows
#pragma unroll
    for (int r = 0; r < kG; ++r)
      if (r < rows) ea[r] = pick(sr, row0 + r);
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < m) sr[j] = load_cols<T, kV>(x + j * D + d);
    for (int i0 = 0; i0 < rows; i0 += kG) {
      float acc[kG][kV];
      sum_rows<T, kV, kRows, kG>(acc, sr, sM + (row0 + i0) * m, m, rows - i0);
#pragma unroll
      for (int r = 0; r < kG; ++r)
        if (i0 + r < rows)
          store_x<T, kV>(xo + (i0 + r) * D + d, acc[r], ea[r], alpha);
      const int n0 = i0 + kG;  // the next group's own rows of u
#pragma unroll
      for (int r = 0; r < kG; ++r)
        if (n0 + r < rows)
          ea[r] = load_cols<T, kV>(u + (row0 + n0 + r) * D + d);
    }
  } else {
    stage_matrix(M, sM, m);
    if (!live) return;
    for (int i0 = 0; i0 < rows; i0 += kPass) {
      float acc[kPass][kV];
      sum_streamed<T, kV, kPass>(acc, u, D, d, sM + (row0 + i0) * m, m,
                                 rows - i0);
#pragma unroll
      for (int r = 0; r < kPass; ++r) {
        const int i = i0 + r;
        if (i < rows)
          store_u<T, kV>(uo + i * D + d, acc[r],
                         load_cols<T, kV>(p + i * D + d),
                         load_cols<T, kV>(pp + i * D + d));
      }
    }
    for (int i0 = 0; i0 < rows; i0 += kPass) {
      float acc[kPass][kV];
      sum_streamed<T, kV, kPass>(acc, x, D, d, sM + (row0 + i0) * m, m,
                                 rows - i0);
#pragma unroll
      for (int r = 0; r < kPass; ++r) {
        const int i = i0 + r;
        if (i < rows)
          store_x<T, kV>(xo + i * D + d, acc[r],
                         load_cols<T, kV>(u + (row0 + i) * D + d), alpha);
      }
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

// Blocks of ``threads`` column groups along the units (x) and experiments
// (y); 65535 experiments at most.
dim3 grid(int64_t units, int B, int threads) {
  return dim3(static_cast<unsigned>((units + threads - 1) / threads),
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

// The operands of one consensus_step launch: B = 1 unless the form is
// kBatch, alphas only for kBatch, row0 = 0 and rows = m unless kBlock.
struct StepArgs {
  const void *M, *x, *u, *p, *pp;
  void *xo, *uo;
  int m;
  int64_t D;
  int row0, rows;
  float alpha;
  int B;
  int64_t m_stride;
  const float* alphas;
};

template <typename T, int kV, Staging S, Form F>
cudaError_t launch_step_kernel(const StepArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.m) * a.m * sizeof(float);
  auto kernel = consensus_step_kernel<T, kV, S, F>;
  cudaError_t err = reserve_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t units = (a.D + kV - 1) / kV;  // column groups, one a thread
  kernel<<<grid(units, a.B, kStepThreads), kStepThreads, smem, stream>>>(
      static_cast<const float*>(a.M), static_cast<const T*>(a.x),
      static_cast<const T*>(a.u), static_cast<const T*>(a.p),
      static_cast<const T*>(a.pp), static_cast<T*>(a.xo),
      static_cast<T*>(a.uo), a.m, a.D, a.row0, a.rows, a.alpha, a.m_stride,
      a.alphas);
  return cudaGetLastError();
}

template <typename T, int kV, Form F>
cudaError_t launch_step_staged(const StepArgs& a, cudaStream_t stream) {
  if (a.m <= kBothRows)
    return launch_step_kernel<T, kV, kBothStreams, F>(a, stream);
  if (a.m <= kRows) return launch_step_kernel<T, kV, kEachStream, F>(a, stream);
  return launch_step_kernel<T, kV, kPasses, F>(a, stream);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// vec != 0 asks for 16-byte accesses; refused unless every row of the six
// streams starts on a 16-byte boundary, as for launch_mix.
template <typename T, Form F>
cudaError_t launch_step(const StepArgs& a, int vec, cudaStream_t stream) {
  if (!vec) return launch_step_staged<T, 1, F>(a, stream);
  const bool aligned = (a.D * sizeof(T)) % 16 == 0 && aligned16(a.x) &&
                       aligned16(a.u) && aligned16(a.p) && aligned16(a.pp) &&
                       aligned16(a.xo) && aligned16(a.uo);
  if (!aligned) return cudaErrorMisalignedAddress;
  return launch_step_staged<T, 16 / sizeof(T), F>(a, stream);
}

template <Form F>
int launch_step_dtype(const StepArgs& a, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_step<float, F>(a, vec, s);
  if (dtype == 1) return launch_step<__nv_bfloat16, F>(a, vec, s);
  return cudaErrorInvalidValue;
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
  kernel<<<grid(units, B, kThreads), kThreads, smem, stream>>>(
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
    const bool aligned =
        (D * sizeof(T)) % 16 == 0 && aligned16(x) && aligned16(out);
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

// dtype codes shared with ops.py: 0 = float32, 1 = bfloat16.  vec: 1 for
// 16-byte accesses (ops.py checks the alignment first), 0 for element
// accesses.  Every operand is (m, D).
extern "C" int repro_consensus_step(const void* M, const void* x,
                                    const void* u, const void* p,
                                    const void* pp, void* xo, void* uo, int m,
                                    long long D, float alpha, int dtype,
                                    int vec, void* stream) {
  return launch_step_dtype<kSquare>(
      {M, x, u, p, pp, xo, uo, m, D, 0, m, alpha, 1, 0, nullptr}, dtype, vec,
      stream);
}

// The row block from row row0: x and u are (m, D); p, pp, xo and uo are
// the block's (rows, D) rows.
extern "C" int repro_consensus_step_rows(const void* M, const void* x,
                                         const void* u, const void* p,
                                         const void* pp, void* xo, void* uo,
                                         int m, long long D, int row0,
                                         int rows, float alpha, int dtype,
                                         int vec, void* stream) {
  if (bad_block(m, row0, rows)) return cudaErrorInvalidValue;
  return launch_step_dtype<kBlock>(
      {M, x, u, p, pp, xo, uo, m, D, row0, rows, alpha, 1, 0, nullptr}, dtype,
      vec, stream);
}

// B experiments in one launch: streams (B, m, D), M (B, m, m) with
// m_stride = m * m or (1, m, m) with m_stride = 0, alphas (B,) float32 on
// the device.
extern "C" int repro_consensus_step_batched(
    const void* M, const void* x, const void* u, const void* p,
    const void* pp, void* xo, void* uo, int m, long long D, int B,
    long long m_stride, const void* alphas, int dtype, int vec,
    void* stream) {
  if (bad_batch(B, m, m_stride) || alphas == nullptr)
    return cudaErrorInvalidValue;
  return launch_step_dtype<kBatch>(
      {M, x, u, p, pp, xo, uo, m, D, 0, m, 0.f, B, m_stride,
       static_cast<const float*>(alphas)},
      dtype, vec, stream);
}

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
