// Flash attention forward for Hopper (sm_90a), built by kernel.py with nvcc
// into a shared library that exposes one plain C entry point.
//
// out[b, h, i] = sum_j softmax_j(q_i . k_j / sqrt(hd)) v_j over the keys j
// of query i (j <= i when causal), with the online-softmax statistics of
// the reference: running max m, running sum l and accumulator acc, all fp32;
// masked logits are -1e30 (not -inf), and l == 0 -> 1 before the division.
// q is (B, H, L, hd); k and v are (B, KV, L, hd), read at head h / (H / KV)
// (GQA without a copy of the cache); any strides with a unit last stride,
// so the model's (B, L, H, hd) tensors are read in place. bf16 or fp32
// inputs, the output in q's type.
//
// Replaces the TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention/kernel.py (body `_flash_kernel`).
//
// Bound on an H100, reckoned from the code (not measured) for the served
// prefill shape B = 4, H = 32, L = 4096, hd = 64, causal: q k^T and P v over
// the causal half are 4 * hd * L^2 / 2 * B * H = 2.7e11 operations, 4.1 ms
// at 67 TFLOP/s of fp32 outside the tensor cores (0.28 ms at the 989
// TFLOP/s of bf16 tensor cores, which this kernel does not use). The bytes
// (q, k, v, out: 4 * B * H * L * hd in bf16, less for GQA's k and v) take
// about 0.03 ms at 3.35 TB/s: bound by operations.
//
// Design. The Pallas grid is (B * H, q blocks), each step streaming the
// whole K/V of its head through VMEM. Here one block of 256 threads owns one
// (b, h, tile of 64 query rows), in the grid (q tiles, H, B) with the
// heaviest causal tiles scheduled first, and streams 64-key tiles of K and V
// through shared memory; under `causal` the loop stops at the diagonal tile.
// The 64 x 64 logit tile is a 16 x 16 thread grid, 4 x 4 logits a thread
// (rows ty + 16 i, columns tx + 16 j, so the 16-byte row loads of q and k
// hit distinct banks); the row max and row sum are shuffles over the 16
// lanes that share a row; P goes through shared memory for P v, where a
// thread owns 4 rows x hd/16 columns of acc in registers. Every product is
// an fp32 FMA (no TF32), as in the reference kernel. A ragged last tile is
// masked: keys at or past L get weight 0, rows past L are not written. One
// block uses 3 * 64 * (hd + 4) + 64 * 68 floats of shared memory (68 KiB at
// hd = 64), so three blocks share an SM. No tensor cores, TMA or wgmma yet:
// that is a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows of a block
constexpr int BK = 64;   // keys of a K/V tile
constexpr int THREADS = 256;
constexpr int PLD = BK + 4;  // padded row of P in shared memory
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// element strides of the four operands: (batch, head, row); the last
// dimension is contiguous
struct Strides {
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Strides st, int G,
             int L, float scale, int causal) {
  constexpr int LD = HD + 4;    // padded row of the q/k/v tiles
  constexpr int CPT = HD / 16;  // columns of acc a thread owns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x LD, q * scale
  float* ks = qs + BQ * LD;                      // BK x LD
  float* vs = ks + BK * LD;                      // BK x LD
  float* ps = vs + BK * LD;                      // BQ x PLD

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (L + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q0 = qt * BQ;
  const T* qg = q + b * st.qb + h * st.qh;
  const T* kg = k + b * st.kb + kvh * st.kh;
  const T* vg = v + b * st.vb + kvh * st.vh;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, row = q0 + r;
    qs[r * LD + d] = row < L ? to_float(qg[row * st.ql + d]) * scale : 0.f;
  }
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  const int nk_all = (L + BK - 1) / BK;
  // BQ == BK: the causal loop ends at the diagonal tile qt
  const int nk = causal ? min(qt + 1, nk_all) : nk_all;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P v is done with vs and ps
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD, row = k0 + r;
      const bool ok = row < L;
      ks[r * LD + d] = ok ? to_float(kg[row * st.kl + d]) : 0.f;
      vs[r * LD + d] = ok ? to_float(vg[row * st.vl + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // online softmax over this tile (the reference's body, row by row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (causal && kp > qp) s[i][j] = NEG_INF;
        if (kp < L) rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mnew = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - mnew);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        s[i][j] = kp < L ? expf(s[i][j] - mnew) : 0.f;
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * PLD + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PLD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * LD + tx * CPT;
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = vrow[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                        : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= L) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + b * st.ob + h * st.oh + row * st.ol + tx * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store_as(orow + c, acc[i][c] / li);
  }
}

template <typename T, int HD>
int launch(const T* q, const T* k, const T* v, T* out, const Strides& st,
           int B, int H, int G, int L, float scale, int causal,
           cudaStream_t stream) {
  const int smem = (3 * BQ * (HD + 4) + BQ * PLD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(q, k, v, out, st, G,
                                                       L, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             const Strides& st, int B, int H, int G, int L, float scale,
             int causal, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 16: return launch<T, 16>(qt, kt, vt, ot, st, B, H, G, L, scale, causal, s);
    case 32: return launch<T, 32>(qt, kt, vt, ot, st, B, H, G, L, scale, causal, s);
    case 64: return launch<T, 64>(qt, kt, vt, ot, st, B, H, G, L, scale, causal, s);
    case 128: return launch<T, 128>(qt, kt, vt, ot, st, B, H, G, L, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `bf16` selects
// __nv_bfloat16 operands (else float); `strides` points to 12 element
// strides: (batch, head, row) of q, k, v and out. Checks nothing the Python
// wrapper checks (shapes, types, the device, hd, G = H / KV).
extern "C" int flash_attention_launch(int bf16, int hd, const void* q,
                                      const void* k, const void* v, void* out,
                                      const long long* strides, int B, int H,
                                      int G, int L, float scale, int causal,
                                      void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, out, st, B, H, G, L,
                                        scale, causal, s)
              : dispatch<float>(hd, q, k, v, out, st, B, H, G, L, scale,
                                causal, s);
}
