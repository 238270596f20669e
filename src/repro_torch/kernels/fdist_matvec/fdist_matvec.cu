// Fused f-distance matvec for Hopper (sm_90a), built by kernel.py with nvcc
// into a shared library that exposes one plain C entry point.
//
//   out[n, i, :] = sum_j f(x[n, i] + y[n, j]) * V[n, j, :]
//
// for every job n of one cross size bucket of an FTFI plan, with f one of
//   poly      sum_t c[t] s^t            (Horner, ascending coefficients)
//   exp       c[1] * exp(c[0] s)
//   expq      exp(c[0] s^2 + c[1] s + c[2])
//   rational  1 / (1 + c[0] s^2)
// The (a, b) matrix M = [f(x_i + y_j)] is never written to device memory.
//
// Replaces the TPU kernel `fdist_matvec_batched_pallas` in
// src/repro/kernels/fdist_matvec/kernel.py (and `fdist_matvec_pallas`, its
// single-job form, as the B = 1 launch).
//
// Bound on an H100. Per job the kernel reads a + b distances and b*d field
// values and writes a*d outputs: O(a + b + b d) bytes. It does a*b
// evaluations of f plus 2*a*b*d flops of multiply-add. At the d = 4 of the
// FTFI runtime benchmark that is ~11 flops per pair against ~16 bytes per
// *row*, so for any bucket wider than a few dozen groups the work is far
// above the card's ridge point (67 TFLOP/s fp32 over 3.35 TB/s = 20 flops
// per byte): the kernel is bound by operations, and at small d by the a*b
// evaluations of f (an expf is a short FMA sequence plus one special-
// function instruction, which issues at an eighth of the FMA rate), not by
// the bytes.
//
// What the design does about it:
//   * td = 4 and 16 (d <= 16): one thread owns one output row i and all TD
//     columns of its d tile in registers, so f(x_i + y_j) is evaluated once
//     per pair and reused for all columns; y and V are staged TB rows at a
//     time in shared memory, and every thread of the block reads the same V
//     row (a broadcast) as float4;
//   * td = 64 (d > 16; redesigned after the one-row-a-thread form reached
//     16% of its bound at d = 64, slower than bmm on a precomputed M): the
//     work there is the 2*a*b*d FMAs, so a block owns a register-blocked
//     tile of BI = 64 rows x 64 columns, 8 x 4 outputs a thread. Per stage
//     it stages TB sources of V and builds the TB x BI tile of M = f(x + y)
//     in shared memory (each pair evaluated once per block), then runs TB
//     rank-1 steps: three float4 shared loads (8 values of M, 4 of V) feed
//     32 FMAs. 32 KiB of shared memory and 128 threads a block let several
//     blocks share an SM, which hides the synchronous stage loads (rows of
//     a ragged d or of bf16 V are not 16-byte aligned, so no cp.async);
//   * a bucket of few long jobs (the root of the IT has 2 jobs of ~n/2
//     groups) would fill only a fraction of the 132 SMs, so the source axis j
//     is split across blockIdx.z; each split writes an fp32 partial and a
//     second small kernel sums the partials in a fixed order (deterministic,
//     no atomics);
//   * accumulation is fp32 (fmaf), summed per stage of TB sources and then
//     across stages, so the rounding error grows with TB + b/TB rather than
//     with b; v may be fp32 or bf16 and the output has v's type. Ragged
//     tails are masked in the kernel: rows i >= a and columns past d are
//     not stored, sources j >= b are never visited.
// No tensor cores: f(x + y) is built per element, and fp32 accuracy (3e-6
// relative to the plain version) rules out TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 64;  // source rows staged in shared memory per step
constexpr int BI = 64;  // rows of a td = 64 tile (kernel.TILE_ROWS)
constexpr int TR = 8;   // rows a thread owns in it, 4 columns each
constexpr int TILE_THREADS = BI * 64 / (TR * 4);  // (kernel.TILE_THREADS)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// MODE: 0 poly, 1 exp, 2 expq, 3 rational (kernel.MODE_IDS)
template <int MODE>
__device__ __forceinline__ float f_eval(float s, const float* cs, int k) {
  if constexpr (MODE == 0) {
    float acc = 0.0f;
    for (int t = k - 1; t >= 0; --t) acc = acc * s + cs[t];
    return acc;
  } else if constexpr (MODE == 1) {
    return cs[1] * expf(cs[0] * s);
  } else if constexpr (MODE == 2) {
    return expf(cs[0] * s * s + cs[1] * s + cs[2]);
  } else {
    return 1.0f / (1.0f + cs[0] * s * s);
  }
}

// grid: x = job * row_tiles + row tile, y = d tile, z = source split.
// block: one thread per output row of the tile.
template <int MODE, int TD, typename T>
__global__ void __launch_bounds__(128)
fdist_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const T* __restrict__ v, const float* __restrict__ coeffs, int k,
             T* __restrict__ out, float* __restrict__ partial, int B, int a,
             int b, int d, int row_tiles, int j_per_split) {
  extern __shared__ float cs[];  // the k coefficients of f
  __shared__ float ys[TB];
  __shared__ __align__(16) float vs[TB][TD];

  const int job = blockIdx.x / row_tiles;
  const int i = (blockIdx.x % row_tiles) * blockDim.x + threadIdx.x;
  const int c0 = blockIdx.y * TD;
  const int j_begin = blockIdx.z * j_per_split;
  const int j_end = min(b, j_begin + j_per_split);

  for (int t = threadIdx.x; t < k; t += blockDim.x) cs[t] = coeffs[t];
  const float xi = i < a ? x[(size_t)job * a + i] : 0.0f;
  const float* yj = y + (size_t)job * b;
  const T* vj = v + (size_t)job * b * d;

  float acc[TD];
#pragma unroll
  for (int c = 0; c < TD; ++c) acc[c] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += TB) {
    const int jn = min(TB, j_end - j0);
    __syncthreads();  // the previous stage is consumed; cs is loaded
    for (int t = threadIdx.x; t < TB * TD; t += blockDim.x) {
      const int jj = t / TD, c = t % TD;
      vs[jj][c] = (jj < jn && c0 + c < d)
                      ? to_float(vj[(size_t)(j0 + jj) * d + c0 + c])
                      : 0.0f;
    }
    for (int t = threadIdx.x; t < TB; t += blockDim.x)
      ys[t] = t < jn ? yj[j0 + t] : 0.0f;
    __syncthreads();
    // this stage's sum: two-level summation keeps the rounding error of
    // long rows near that of short ones
    float part[TD];
#pragma unroll
    for (int c = 0; c < TD; ++c) part[c] = 0.0f;
    for (int jj = 0; jj < jn; ++jj) {
      const float m = f_eval<MODE>(xi + ys[jj], cs, k);
      const float4* row = reinterpret_cast<const float4*>(vs[jj]);
#pragma unroll
      for (int q = 0; q < TD / 4; ++q) {
        const float4 w = row[q];
        part[4 * q + 0] = fmaf(m, w.x, part[4 * q + 0]);
        part[4 * q + 1] = fmaf(m, w.y, part[4 * q + 1]);
        part[4 * q + 2] = fmaf(m, w.z, part[4 * q + 2]);
        part[4 * q + 3] = fmaf(m, w.w, part[4 * q + 3]);
      }
    }
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[c] += part[c];
  }

  if (i >= a) return;
  if (partial != nullptr) {  // split source axis: fp32 partial per split
    float* p = partial + (((size_t)blockIdx.z * B + job) * a + i) * d;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      if (c0 + c < d) p[c0 + c] = acc[c];
  } else {
    T* o = out + ((size_t)job * a + i) * d;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      if (c0 + c < d) o[c0 + c] = from_float<T>(acc[c]);
  }
}

// td = 64: a block owns a tile of BI rows x 64 columns; thread (tx, ty) =
// (tid % 16, tid / 16) owns rows TR ty .. TR ty + TR - 1 and columns 4 tx ..
// 4 tx + 3 of it in registers. Per stage of TB sources the block stages the
// TB x 64 values of V and builds the TB x BI tile of M = f(x_i + y_j) in
// shared memory, each pair evaluated once; then TB rank-1 steps, each
// reading TR values of M and 4 of V as TR / 4 + 1 float4 loads for 4 TR
// FMAs.
template <int MODE, typename T>
__global__ void __launch_bounds__(TILE_THREADS)
fdist_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const T* __restrict__ v, const float* __restrict__ coeffs,
                  int k, T* __restrict__ out, float* __restrict__ partial,
                  int B, int a, int b, int d, int row_tiles,
                  int j_per_split) {
  extern __shared__ float cs[];  // the k coefficients of f
  __shared__ __align__(16) float ms[TB][BI];  // M of the stage, [source][row]
  __shared__ __align__(16) float vs[TB][64];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int job = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * BI;
  const int c0 = blockIdx.y * 64;
  const int j_begin = blockIdx.z * j_per_split;
  const int j_end = min(b, j_begin + j_per_split);

  for (int t = tid; t < k; t += TILE_THREADS) cs[t] = coeffs[t];
  // this thread builds row mi of M for sources tid / BI + a multiple of
  // TILE_THREADS / BI
  const int mi = tid % BI;
  const float xi = i0 + mi < a ? x[(size_t)job * a + i0 + mi] : 0.0f;
  const float* yj = y + (size_t)job * b;
  const T* vj = v + (size_t)job * b * d;

  float acc[TR][4];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int j0 = j_begin; j0 < j_end; j0 += TB) {
    const int jn = min(TB, j_end - j0);
    __syncthreads();  // the previous stage is consumed; cs is loaded
    for (int jj = tid / BI; jj < TB; jj += TILE_THREADS / BI)
      ms[jj][mi] = jj < jn ? f_eval<MODE>(xi + yj[j0 + jj], cs, k) : 0.0f;
    for (int t = tid; t < TB * 64; t += TILE_THREADS) {
      const int jj = t / 64, c = t % 64;
      vs[jj][c] = (jj < jn && c0 + c < d)
                      ? to_float(vj[(size_t)(j0 + jj) * d + c0 + c])
                      : 0.0f;
    }
    __syncthreads();
    // this stage's sum, then the running one (the two-level summation)
    float part[TR][4];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[r][c] = 0.0f;
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      const float4 w = *reinterpret_cast<const float4*>(&vs[jj][4 * tx]);
      float m[TR];
#pragma unroll
      for (int q = 0; q < TR / 4; ++q) {
        const float4 mq =
            *reinterpret_cast<const float4*>(&ms[jj][TR * ty + 4 * q]);
        m[4 * q] = mq.x;
        m[4 * q + 1] = mq.y;
        m[4 * q + 2] = mq.z;
        m[4 * q + 3] = mq.w;
      }
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        part[r][0] = fmaf(m[r], w.x, part[r][0]);
        part[r][1] = fmaf(m[r], w.y, part[r][1]);
        part[r][2] = fmaf(m[r], w.z, part[r][2]);
        part[r][3] = fmaf(m[r], w.w, part[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += part[r][c];
  }

#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int i = i0 + TR * ty + r;
    if (i >= a) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + 4 * tx + c;
      if (col >= d) continue;
      if (partial != nullptr)  // split source axis: fp32 partial per split
        partial[(((size_t)blockIdx.z * B + job) * a + i) * d + col] =
            acc[r][c];
      else
        out[((size_t)job * a + i) * d + col] = from_float<T>(acc[r][c]);
    }
  }
}

// out[e] = sum over splits s (in order) of partial[s, e]
template <typename T>
__global__ void reduce_splits(const float* __restrict__ partial,
                              T* __restrict__ out, size_t total, int splits) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < splits; ++q) s += partial[(size_t)q * total + e];
    out[e] = from_float<T>(s);
  }
}

template <int MODE, int TD, typename T>
int launch(const void* x, const void* y, const void* v, const void* coeffs,
           int k, void* out, void* partial, int B, int a, int b, int d,
           int threads, int row_tiles, int d_tiles, int splits,
           int j_per_split, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * row_tiles), (unsigned)d_tiles,
                  (unsigned)splits);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const size_t cs_bytes = k * sizeof(float);
  if constexpr (TD == 64) {
    // 32 KiB of static tiles plus the coefficients: past 48 KiB only when
    // allowed
    const cudaError_t err = cudaFuncSetAttribute(
        fdist_tile_kernel<MODE, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cs_bytes);
    if (err != cudaSuccess) return (int)err;
    fdist_tile_kernel<MODE, T><<<grid, TILE_THREADS, cs_bytes, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const T*>(v), static_cast<const float*>(coeffs), k,
        static_cast<T*>(out), part, B, a, b, d, row_tiles, j_per_split);
  } else {
    fdist_kernel<MODE, TD, T><<<grid, threads, cs_bytes, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const T*>(v), static_cast<const float*>(coeffs), k,
        static_cast<T*>(out), part, B, a, b, d, row_tiles, j_per_split);
  }
  if (splits > 1) {
    const size_t total = (size_t)B * a * d;
    const unsigned blocks =
        (unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    reduce_splits<T><<<blocks, 256, 0, stream>>>(part, static_cast<T*>(out),
                                                 total, splits);
  }
  return 0;
}

template <int MODE, typename T>
int dispatch_td(int td, const void* x, const void* y, const void* v,
                const void* coeffs, int k, void* out, void* partial, int B,
                int a, int b, int d, int threads, int row_tiles, int d_tiles,
                int splits, int j_per_split, cudaStream_t stream) {
  switch (td) {
    case 4:
      return launch<MODE, 4, T>(x, y, v, coeffs, k, out, partial, B, a, b,
                                d, threads, row_tiles, d_tiles, splits,
                                j_per_split, stream);
    case 16:
      return launch<MODE, 16, T>(x, y, v, coeffs, k, out, partial, B, a, b,
                                 d, threads, row_tiles, d_tiles, splits,
                                 j_per_split, stream);
    case 64:
      return launch<MODE, 64, T>(x, y, v, coeffs, k, out, partial, B, a, b,
                                 d, threads, row_tiles, d_tiles, splits,
                                 j_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_mode(int mode, int td, const void* x, const void* y,
                  const void* v, const void* coeffs, int k, void* out,
                  void* partial, int B, int a, int b, int d, int threads,
                  int row_tiles, int d_tiles, int splits, int j_per_split,
                  cudaStream_t stream) {
  switch (mode) {
    case 0:
      return dispatch_td<0, T>(td, x, y, v, coeffs, k, out, partial, B, a, b,
                               d, threads, row_tiles, d_tiles, splits,
                               j_per_split, stream);
    case 1:
      return dispatch_td<1, T>(td, x, y, v, coeffs, k, out, partial, B, a, b,
                               d, threads, row_tiles, d_tiles, splits,
                               j_per_split, stream);
    case 2:
      return dispatch_td<2, T>(td, x, y, v, coeffs, k, out, partial, B, a, b,
                               d, threads, row_tiles, d_tiles, splits,
                               j_per_split, stream);
    case 3:
      return dispatch_td<3, T>(td, x, y, v, coeffs, k, out, partial, B, a, b,
                               d, threads, row_tiles, d_tiles, splits,
                               j_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the kernel (and, for splits > 1, the reduction) on `stream` and
// returns cudaGetLastError(): 0 when both launches were accepted.
extern "C" int fdist_matvec_launch(int mode, int v_is_bf16, int td,
                                   const void* x, const void* y,
                                   const void* v, const void* coeffs, int k,
                                   void* out, void* partial, int B, int a,
                                   int b, int d, int threads, int row_tiles,
                                   int d_tiles, int splits, int j_per_split,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad =
      v_is_bf16
          ? dispatch_mode<__nv_bfloat16>(mode, td, x, y, v, coeffs, k, out,
                                         partial, B, a, b, d, threads,
                                         row_tiles, d_tiles, splits,
                                         j_per_split, s)
          : dispatch_mode<float>(mode, td, x, y, v, coeffs, k, out, partial,
                                 B, a, b, d, threads, row_tiles, d_tiles,
                                 splits, j_per_split, s);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
