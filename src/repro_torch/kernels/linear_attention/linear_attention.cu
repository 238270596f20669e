// Causal (gamma-decayed) linear attention for Hopper (sm_90a), built by
// kernel.py with nvcc into a shared library that exposes one plain C entry
// point.
//
// For each (batch, head) with decay gamma = exp(lg), lg <= 0 (lg = 0 is the
// plain Performer):
//   num[i] = sum_{j <= i} (q_i . k_j) gamma^(i-j) v_j,
//   den[i] = sum_{j <= i} (q_i . k_j) gamma^(i-j),
// unnormalized, in fp32, by the chunked schedule of the reference: within a
// chunk of C positions the masked C x C quadratic (q k^T * gamma^(i-j)) v
// and its row sums; across chunks the state S (m x hd) and z (m), read
// through q * gamma^pos and written through k * gamma^(C-pos), decayed by
// gamma^C per chunk (kernel.py:36-55 of the reference). q and k are
// (B, H, L, m) fp32, v (B, H, L, hd) fp32 or bf16, num (B, H, L, hd) and
// den (B, H, L) fp32; any strides with a unit last stride, so the model's
// (B, L, H, .) tensors are read and written in place.
//
// Replaces the TPU kernel `linear_attention_pallas` in
// src/repro/kernels/linear_attention/kernel.py (body `_lin_attn_kernel`).
//
// Bound on an H100, reckoned from the code (not measured) for the served
// Performer prefill B = 4, H = 32, L = 4096, m = hd = 64. The function does
// not depend on the chunk, so its least work is that of C = 1: per row the
// read of the state (q S, q z) and its update (k^T v, z + k), 4 m (hd + 1)
// operations, and the diagonal pair, 2 m + 2 hd + 2; 8.9e9 in all, 0.132 ms
// at 67 TFLOP/s of fp32 outside the tensor cores. The bytes, q, k, num and
// den in fp32 and v in bf16, 0.47 GB, take 0.141 ms at 3.35 TB/s: bound by
// bytes, at 0.141 ms. This kernel's C = 64 adds the causal half of the
// C x C quadratic, about C (m + hd) operations a row.
//
// Design. The Pallas grid is (B * H, chunks) with the chunk axis sequential
// and S, z in VMEM scratch. Here one block of 256 threads owns one
// (b, h, tile of TD = 64 columns of hd) and loops over chunks of C = 64
// itself, with S (m x TD) and z (m) in fp32 shared memory (16.25 KiB at
// m = 64). Several blocks share an SM (the whole block takes 86 KiB at
// m = 64; m up to 247 fits), unlike the topo sweep kernel's one. Columns
// past hd are zero, and a wider hd takes more tiles over blockIdx.x; P and
// den do not depend on hd, so each hd tile recomputes them and the first
// tile writes den. Per chunk:
//   1. stage q, k (C x m) and the v tile (C x TD) in shared memory, zeros
//      past L (a ragged tail adds nothing to any sum);
//   2. P = (q k^T) * gamma^(i-j) (j <= i, else 0) on a 16 x 16 thread grid,
//      4 x 4 entries a thread (rows ty + 16 a, columns tx + 16 b); den's
//      within-chunk part by shuffles over the 16 lanes of a row;
//   3. scale q by gamma^pos and k by gamma^(C-pos) in place;
//   4. num = P v + (q gamma^pos) S, den += (q gamma^pos) z: a thread owns
//      4 rows x TD/16 columns; emit;
//   5. S = gamma^C S + (k gamma^(C-pos))^T v, z likewise.
// Every product is an fp32 FMA (no TF32), as in the reference kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 64;  // chunk length
constexpr int TD = 64;  // columns of hd a block owns
constexpr int THREADS = 256;
constexpr int PLD = C + 4;  // padded row of P

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// element strides (batch, head, row) of q, k, v, num and den; the last
// dimension of q, k, v and num is contiguous
struct Strides {
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, nb, nh, nl, db, dh, dl;
};

template <typename TV>
__global__ void __launch_bounds__(THREADS)
lin_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const TV* __restrict__ v, const float* __restrict__ log_gamma,
                float* __restrict__ num, float* __restrict__ den, Strides st,
                int L, int m, int hd) {
  constexpr int VLD = TD + 4;   // padded row of the v tile and of S
  constexpr int CPT = TD / 16;  // columns a thread owns
  const int MLD = m + 4;        // padded row of q and k
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // C x MLD
  float* ks = qs + C * MLD;                      // C x MLD
  float* ps = ks + C * MLD;                      // C x PLD
  float* vs = ps + C * PLD;                      // C x VLD
  float* ss = vs + C * VLD;                      // m x VLD: the state S
  float* zs = ss + m * VLD;                      // m: the state z
  float* decq = zs + m;                          // C: gamma^pos
  float* deck = decq + C;                        // C: gamma^(C - pos)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * TD, h = blockIdx.y, b = blockIdx.z;
  const float lg = log_gamma[h];
  const float gC = expf(lg * (float)C);
  const float* qg = q + b * st.qb + h * st.qh;
  const float* kg = k + b * st.kb + h * st.kh;
  const TV* vg = v + b * st.vb + h * st.vh;
  float* ng = num + b * st.nb + h * st.nh;
  float* dg = den + b * st.db + h * st.dh;

  for (int e = tid; e < m * VLD; e += THREADS) ss[e] = 0.f;
  for (int e = tid; e < m; e += THREADS) zs[e] = 0.f;
  if (tid < C) {
    decq[tid] = expf(lg * (float)tid);
    deck[tid] = expf(lg * (float)(C - tid));
  }

  for (int l0 = 0; l0 < L; l0 += C) {
    __syncthreads();  // the previous chunk's update is done with ks, vs
    for (int e = tid; e < C * m; e += THREADS) {
      const int r = e / m, d = e % m, row = l0 + r;
      const bool ok = row < L;
      qs[r * MLD + d] = ok ? qg[row * st.ql + d] : 0.f;
      ks[r * MLD + d] = ok ? kg[row * st.kl + d] : 0.f;
    }
    for (int e = tid; e < C * TD; e += THREADS) {
      const int r = e / TD, c = e % TD, row = l0 + r;
      vs[r * VLD + c] =
          row < L && c0 + c < hd ? to_float(vg[row * st.vl + c0 + c]) : 0.f;
    }
    __syncthreads();

    // 2. P = (q k^T) * gamma^(i-j), and the within-chunk den
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[a][j] = 0.f;
    for (int d = 0; d < m; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * MLD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * MLD + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[a][j] = fmaf(qa[a].x, ka[j].x, p[a][j]);
          p[a][j] = fmaf(qa[a].y, ka[j].y, p[a][j]);
          p[a][j] = fmaf(qa[a].z, ka[j].z, p[a][j]);
          p[a][j] = fmaf(qa[a].w, ka[j].w, p[a][j]);
        }
    }
    float din[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      din[a] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = tx + 16 * j;
        const float dm = i >= jj ? expf(lg * (float)(i - jj)) : 0.f;
        p[a][j] *= dm;
        din[a] += p[a][j];
        ps[i * PLD + jj] = p[a][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        din[a] += __shfl_xor_sync(0xffffffffu, din[a], off);
    }
    __syncthreads();  // P is stored; q and k are free to rescale

    // 3. q * gamma^pos, k * gamma^(C - pos)
    for (int e = tid; e < C * m; e += THREADS) {
      const int r = e / m, d = e % m;
      qs[r * MLD + d] *= decq[r];
      ks[r * MLD + d] *= deck[r];
    }
    __syncthreads();

    // 4. num = P v + (q gamma^pos) S; den = rowsum(P) + (q gamma^pos) z
    float a1[4][CPT], a2[4][CPT], dx[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      dx[a] = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) a1[a][c] = a2[a][c] = 0.f;
    }
#pragma unroll 2
    for (int j = 0; j < C; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(ps + (ty + 16 * a) * PLD + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (j + u) * VLD + tx * CPT;
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = vrow[c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pv = u == 0 ? pa[a].x : u == 1 ? pa[a].y
                         : u == 2 ? pa[a].z : pa[a].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) a1[a][c] = fmaf(pv, vv[c], a1[a][c]);
        }
      }
    }
    for (int d = 0; d < m; d += 4) {
      float4 qa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * MLD + d);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* srow = ss + (d + u) * VLD + tx * CPT;
        float sv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) sv[c] = srow[c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float qv = u == 0 ? qa[a].x : u == 1 ? qa[a].y
                         : u == 2 ? qa[a].z : qa[a].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) a2[a][c] = fmaf(qv, sv[c], a2[a][c]);
        }
      }
    }
    for (int d = tx; d < m; d += 16) {
      const float zv = zs[d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        dx[a] = fmaf(qs[(ty + 16 * a) * MLD + d], zv, dx[a]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        dx[a] += __shfl_xor_sync(0xffffffffu, dx[a], off);
      const int row = l0 + ty + 16 * a;
      if (row >= L) continue;
      float* nrow = ng + row * st.nl + c0 + tx * CPT;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (c0 + tx * CPT + c < hd) nrow[c] = a1[a][c] + a2[a][c];
      if (blockIdx.x == 0 && tx == 0) dg[row * st.dl] = din[a] + dx[a];
    }
    __syncthreads();  // every read of the old S and z is done

    // 5. S = gamma^C S + (k gamma^(C-pos))^T v; z likewise
    for (int r0 = 0; r0 < m; r0 += 16) {  // row r0 + ty of S
      const int d = r0 + ty;
      if (d >= m) continue;
      float acc[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        const float kv = ks[j * MLD + d];
        const float* vrow = vs + j * VLD + tx * CPT;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] = fmaf(kv, vrow[c], acc[c]);
      }
      float* srow = ss + d * VLD + tx * CPT;
#pragma unroll
      for (int c = 0; c < CPT; ++c) srow[c] = gC * srow[c] + acc[c];
    }
    for (int d = tid; d < m; d += THREADS) {
      float zacc = 0.f;
      for (int j = 0; j < C; ++j) zacc += ks[j * MLD + d];
      zs[d] = gC * zs[d] + zacc;
    }
  }
}

size_t smem_bytes(int m) {
  return sizeof(float) * ((size_t)2 * C * (m + 4) + (size_t)C * PLD
                          + (size_t)C * (TD + 4) + (size_t)m * (TD + 4) + m
                          + 2 * C);
}

template <typename TV>
int launch(const float* q, const float* k, const void* v, const float* lg,
           float* num, float* den, const Strides& st, int B, int H, int L,
           int m, int hd, cudaStream_t stream) {
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      lin_attn_kernel<TV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)err;
  }
  dim3 grid((hd + TD - 1) / TD, H, B);
  lin_attn_kernel<TV><<<grid, THREADS, smem, stream>>>(
      q, k, static_cast<const TV*>(v), lg, num, den, st, L, m, hd);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success; an m whose block
// does not fit in shared memory is refused by cudaFuncSetAttribute).
// `v_bf16` selects a __nv_bfloat16 v (else float); `strides` points to 15
// element strides: (batch, head, row) of q, k, v, num and den. Checks
// nothing the Python wrapper checks (shapes, types, the device,
// m % 4 == 0).
extern "C" int linear_attention_launch(int v_bf16, const float* q,
                                       const float* k, const void* v,
                                       const float* log_gamma, float* num,
                                       float* den, const long long* strides,
                                       int B, int H, int L, int m, int hd,
                                       void* stream) {
  const Strides st{strides[0],  strides[1],  strides[2],  strides[3],
                   strides[4],  strides[5],  strides[6],  strides[7],
                   strides[8],  strides[9],  strides[10], strides[11],
                   strides[12], strides[13], strides[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? launch<__nv_bfloat16>(q, k, v, log_gamma, num, den, st, B,
                                        H, L, m, hd, s)
                : launch<float>(q, k, v, log_gamma, num, den, st, B, H, L, m,
                                hd, s);
}
