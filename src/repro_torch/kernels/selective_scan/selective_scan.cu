// Mamba-1 selective scan for Hopper (sm_90a), built by kernel.py with nvcc
// into a shared library that exposes one plain C entry point.
//
// For each batch row b and channel d, in fp32, from h_0 = h0 (zeros when
// absent):
//   h_t[n] = exp(dt_t A[d, n]) h_{t-1}[n] + (dt_t u_t) B_t[n],
//   y_t    = sum_n C_t[n] h_t[n] + D[d] u_t,
// and the state after the last step, h_final. u and dt are (Bt, L, din),
// B and C (Bt, L, N), one dtype (fp32 or bf16, upcast in registers, which
// is exact); A (din, N), D (din), h0 and h_final (Bt, din, N) and y
// (Bt, L, din) are fp32. u, dt, B and C take any strides with a unit last
// stride, so the model's B and C are read in place as column slices of
// its x_proj output (row stride dt_rank + 2N).
//
// Replaces the TPU kernel `selective_scan_pallas` in
// src/repro/kernels/selective_scan/kernel.py (body `_scan_kernel`), and
// computes the function of src/repro/models/ssm.py `selective_scan` that
// the model calls: the final state and h0 besides y, any L and any din
// (the Pallas kernel asserts L % chunk == 0, din % blk_d == 0 and starts
// from zeros).
//
// Bound on an H100, reckoned from the code (not measured) for the served
// Falcon-Mamba-7B prefill Bt = 4, L = 4096, din = 8192, N = 16: 2.15e9
// state updates. Bytes: u, dt and y over L, about 1.61 GB with fp32 u/dt
// (0.48 ms at 3.35 TB/s), 1.07 GB with bf16 (0.32 ms). FP32 operations,
// about 5 an update, 1.1e10 (0.16 ms at 67 TFLOP/s). One exp an update on
// the special function units, which issue 16 a clock per SM: 2.15e9 / (16 x
// 132 x the SM clock), about 0.51 ms at 1.98 GHz. So the bound is the SFU's
// exps, not the bytes.
//
// Design. The TPU grid (Bt, din / blk_d, L / chunk) walks L in order with
// the (blk_d, N) state in VMEM. Here one thread owns one (b, d) with its
// h[N] and A[d, :] log2(e) in registers (N a template parameter: 4, 8 or
// 16), a block 128 channels of one batch row, and a loop over L inside the
// block takes the place of the sequential grid axis. The block walks L in
// chunks of TL = 16 steps: u and dt are read coalesced (neighbouring
// threads read neighbouring d) into registers one chunk ahead, and B_t,
// C_t (TL x N) are staged in a double-buffered shared-memory tile, read as
// float4 broadcasts; the next chunk's loads are in flight while this chunk
// computes. A tail past L reads u = dt = B = C = 0: exp(0) = 1 and the
// state passes through it unchanged, as the model's dt = 0 padding does.
// Threads past din compute on a clamped channel and store nothing.
//
// The arithmetic of one step, per state: dA = 2^(dt a2 + 1) / 2 with
// a2 = A log2(e) (one FFMA, one MUFU.EX2, one FMUL), h = fma(du, B, dA h),
// and y = C . h summed over n in order, plus D u. chip_scan_variants.py
// measures the alternatives at the served shape (an H100 80GB HBM3 at
// 700 W, bf16 inputs): expf, about eight instructions around the same
// MUFU.EX2, sets the launch's time with one thread a channel (1.52-1.54 ms
// against 1.06 ms for this exp); MUFU.EX2 of dt a2 unshifted is biased
// low where its result lies in [0.5, 1), where every decay lies, and the
// recurrence integrates that to 2.2e-5 from the sequential oracle at the
// card tests' shapes (bound 2e-5; 4.8e-6 for this exp, whose result lies in
// [1, 2), and 5.7e-6 for expf). N split over 4 lanes a channel (4x the
// warps an SM, y summed by shuffles) was slower at every exp.
//
// The served float32 gate of chip_smoke.py phase 4d (64 layers, cache
// <= 1e-5 against the plain chunked scan) reads within 10% of its limit
// with any accurate arithmetic: the kernel and the plain scan each sit
// about 1e-6 (h, relative to its max) from a float64 scan of the model's
// own inputs, and depth amplifies their difference. With this exp, the
// fma order fma(du, B, dA h) reads 9.61e-6 there and fma(dA, h, du B)
// 1.05e-5, the two equally close to float64; the kernel takes the first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // channels of one batch row a block owns
constexpr int TL = 16;        // time steps staged at once
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// 2^x by one MUFU.EX2 (ex2.approx.ftz.f32)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(dt A) from a2 = A log2(e): 2^(dt a2 + 1) / 2, the shift by one in
// the same FFMA as the product. MUFU.EX2 returns values slightly low where
// its result lies in [0.5, 1), which is where every decay of the scan lies;
// shifted by one it works in [1, 2).
__device__ __forceinline__ float decay(float dt, float a2) {
  return 0.5f * ex2(fmaf(dt, a2, 1.0f));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// element strides (batch, step) of u, dt, B and C; the last dimension of
// each is contiguous
struct Strides {
  long long ub, ul, db, dl, bb, bl, cb, cl;
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ D,
            const float* __restrict__ h0, float* __restrict__ y,
            float* __restrict__ h_final, Strides st, int L, int din) {
  constexpr int PER = (TL * N + THREADS - 1) / THREADS;  // B/C loads a thread
  __shared__ __align__(16) float bs[2][TL][N];
  __shared__ __align__(16) float cs[2][TL][N];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * THREADS + tid;
  const int b = blockIdx.y;
  const bool live = d < din;
  const int dd = live ? d : din - 1;  // a valid channel for the loads

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = A[(long long)dd * N + n] * LOG2E;
    h[n] = h0 != nullptr ? h0[((long long)b * din + dd) * N + n] : 0.f;
  }
  const float Dd = D[dd];
  const T* ug = u + b * st.ub + dd;
  const T* dg = dt + b * st.db + dd;
  const T* bg = Bm + b * st.bb;
  const T* cg = Cm + b * st.cb;
  float* yg = y + (long long)b * L * din + d;

  // chunk 0: u, dt into registers, B, C into buffer 0. Prefetched
  // values stay in their own type until they are used, so that no upcast
  // waits on a load that is still in flight.
  T ur[TL], dr[TL];
#pragma unroll
  for (int j = 0; j < TL; ++j) {
    const bool ok = j < L;
    ur[j] = ok ? ug[j * st.ul] : zero<T>();
    dr[j] = ok ? dg[j * st.dl] : zero<T>();
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * THREADS;
    if (e < TL * N) {
      const int j = e / N, n = e % N;
      const bool ok = j < L;
      bs[0][j][n] = ok ? to_float(bg[j * st.bl + n]) : 0.f;
      cs[0][j][n] = ok ? to_float(cg[j * st.cl + n]) : 0.f;
    }
  }
  __syncthreads();

  for (int t0 = 0, buf = 0; t0 < L; t0 += TL, buf ^= 1) {
    // the next chunk's loads, in flight while this chunk computes
    const int t1 = t0 + TL;
    T un[TL], dn[TL], bn[PER], cn[PER];
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      const bool ok = t1 + j < L;
      un[j] = ok ? ug[(long long)(t1 + j) * st.ul] : zero<T>();
      dn[j] = ok ? dg[(long long)(t1 + j) * st.dl] : zero<T>();
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * THREADS;
      const int j = e / N, n = e % N;
      const bool ok = e < TL * N && t1 + j < L;
      bn[k] = ok ? bg[(long long)(t1 + j) * st.bl + n] : zero<T>();
      cn[k] = ok ? cg[(long long)(t1 + j) * st.cl + n] : zero<T>();
    }

#pragma unroll
    for (int j = 0; j < TL; ++j) {
      const float dtv = to_float(dr[j]), uv = to_float(ur[j]);
      const float du = dtv * uv;
      float acc = 0.f;
#pragma unroll
      for (int n4 = 0; n4 < N; n4 += 4) {  // B_t, C_t: float4 broadcasts
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[buf][j][n4]);
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[buf][j][n4]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n4 + i;
          const float dA = decay(dtv, a[n]);
          h[n] = fmaf(du, bv[i], dA * h[n]);  // the order phase 4d holds
          acc += h[n] * cv[i];
        }
      }
      if (live && t0 + j < L) yg[(long long)(t0 + j) * din] = acc + uv * Dd;
    }

#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * THREADS;
      if (e < TL * N) {
        bs[buf ^ 1][e / N][e % N] = to_float(bn[k]);
        cs[buf ^ 1][e / N][e % N] = to_float(cn[k]);
      }
    }
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      ur[j] = un[j];
      dr[j] = dn[j];
    }
    __syncthreads();  // the next buffer is written; this one is free
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      h_final[((long long)b * din + d) * N + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* u, const void* dt, const float* A, const void* B,
           const void* C, const float* D, const float* h0, float* y,
           float* h_final, const Strides& st, int Bt, int L, int din,
           cudaStream_t stream) {
  dim3 grid((din + THREADS - 1) / THREADS, Bt);
  scan_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D, h0, y, h_final,
      st, L, din);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int N, const void* u, const void* dt, const float* A,
             const void* B, const void* C, const float* D, const float* h0,
             float* y, float* h_final, const Strides& st, int Bt, int L,
             int din, cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<T, 4>(u, dt, A, B, C, D, h0, y, h_final, st, Bt, L, din,
                          stream);
    case 8:
      return launch<T, 8>(u, dt, A, B, C, D, h0, y, h_final, st, Bt, L, din,
                          stream);
    case 16:
      return launch<T, 16>(u, dt, A, B, C, D, h0, y, h_final, st, Bt, L,
                           din, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success; an N other than 4,
// 8 or 16 gives cudaErrorInvalidValue). `in_bf16` selects __nv_bfloat16
// u, dt, B and C (else float); `strides` points to 8 element strides:
// (batch, step) of u, dt, B and C; h0 may be null (zeros). Checks nothing
// the Python wrapper checks (shapes, types, the device, Bt, din >= 1).
extern "C" int selective_scan_launch(int in_bf16, int N, const void* u,
                                     const void* dt, const float* A,
                                     const void* B, const void* C,
                                     const float* D, const float* h0,
                                     float* y, float* h_final,
                                     const long long* strides, int Bt, int L,
                                     int din, void* stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_n<__nv_bfloat16>(N, u, dt, A, B, C, D, h0, y,
                                           h_final, st, Bt, L, din, s)
                 : launch_n<float>(N, u, dt, A, B, C, D, h0, y, h_final, st,
                                   Bt, L, din, s);
}
