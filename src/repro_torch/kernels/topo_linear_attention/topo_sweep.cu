// Fused topological masked linear-attention sweep for Hopper (sm_90a),
// built by kernel.py with nvcc into a shared library that exposes one plain
// C entry point.
//
// One causal sweep over chunks of C positions of each (batch, head):
//   within a chunk    P = (q k^T) * dmat          (dmat: the exact C x C mask
//                     num = P v, den = rowsum(P)   tile, causal or strict)
//   across chunks     num += read(state), den += read(z)
//                     state += write(k, v)         after the chunk is emitted
// with the state in one of two forms:
//   decay  S (m x hd), z (m): read through q * exp(lg * pos), written through
//          k * exp(lg * (C - pos)), decayed by exp(lg * C) per chunk;
//   rank   R stacked moments S (R*m x hd), z (R*m): read through the alpha
//          table (L x R), written through the beta table.
// Then out = (num + res_num) / where(|den + res_den| < eps, eps, ...), or
// the unnormalized (num, den) pair (the first sweep of a bidirectional
// pair). Everything is fp32, as the reference kernel is.
//
// Replaces the TPU kernel `topo_attention_sweep_pallas` in
// src/repro/kernels/topo_linear_attention/kernel.py (bodies _decay_kernel,
// _rank_kernel, _emit).
//
// Bound on an H100, reckoned from the code (not measured) for the served
// shape B = 4, H = 32, L = 4096, m = hd = 64, C = 128, one causal launch:
// per (b, h, chunk) q k^T and P v over the full C x C tile are
// 2*C*C*m + 2*C*C*hd = 4.2 M fp32 operations; decay mode adds 2*C*m*hd for
// the read and again for the write (6.3 M in all, 25.8 GFLOP, 0.39 ms at
// 67 TFLOP/s outside the tensor cores), rank mode with R = 16 adds
// 2*C*R*m*hd twice (38 M, 155 GFLOP, 2.3 ms). The bytes (q, k, v, out,
// 537 MB) take 0.16 ms at 3.35 TB/s, so both modes are bound by operations.
// The causal mask needs only the lower half of the tile; chip_smoke.py's
// bound counts that half (0.26 ms decay, 2.2 ms rank), this kernel computes
// the whole tile.
//
// Design. The Pallas grid is (B, H, chunks) with the chunk axis sequential
// and the state in VMEM. Here one block owns one (b, h, tile of TD columns
// of hd) and loops over the chunks itself, with the state in shared memory.
// The state's columns and num split cleanly over hd tiles; P and den do not
// depend on hd, so each tile block recomputes them (one block writes den).
// Rank mode's full state at R = 16, m = hd = 64 is 256 KiB, above the 227 KB
// a block may have, so TD = 16 there (64 KiB of state, 226 KB in all); decay
// mode takes TD = 64 and one tile. Per chunk:
//   1. stage q and k transposed (m x C, rows padded to C + 1 floats), the v
//      tile and the alpha/beta rows in shared memory;
//   2. P: a 16 x 16 thread grid, 8 x 8 outputs a thread, stored transposed;
//   3. num/den from P, then the read of the state as it stood before this
//      chunk (the order of the reference, kernel.py:91-97 and :123-128); in
//      rank mode the read is split over 4 groups of R/4 moments, 8 x 4
//      outputs a thread, and the groups' partials summed through the room
//      of P;
//   4. emit;
//   5. update the state: each thread owns up to 8 rows x 8 columns of it
//      (in the served rank mode one mm and 8 consecutive moments).
// The state and v rows are read as 16-byte loads, which the whole warp
// shares. The block runs 8 warps on an SM (its shared memory allows one
// block), so the phases are bound by shared-memory loads and latency, not
// by the FMA rate. No tensor cores: TF32 would miss the 1e-4 bound against
// the plain version; wgmma and TMA are left for a later PR.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// 8 consecutive floats from shared memory, 32-byte aligned, as two 16-byte
// loads (a broadcast when the whole warp reads the same row)
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&o)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

struct SweepArgs {
  const float* q;        // (B, H, L, m)
  const float* k;        // (B, H, L, m)
  const float* v;        // (B, H, L, hd)
  const float* dmat;     // (H, C, C)
  const float* lg;       // (H,) decay mode, else null
  const float* alpha;    // (H, L, R) rank mode, else null
  const float* beta;     // (H, L, R) rank mode, else null
  const float* res_num;  // (B, H, L, hd) or null
  const float* res_den;  // (B, H, L) or null
  float* out;            // (B, H, L, hd): out, or num when !normalize
  float* den_out;        // (B, H, L) when !normalize, else null
  int H, L, m, hd, C, R;
  float eps;
  int normalize;
};

// TD: columns of hd per block, 16, 32 or 64. Output tile (C x TD): thread
// (rg, cg) owns rows rg + NRG * x (x < TD / 16) and columns cg*8 .. cg*8+7.
template <int TD>
__global__ void __launch_bounds__(THREADS, 1)
topo_sweep_kernel(const SweepArgs a) {
  constexpr int NCG = TD / 8;          // column groups of 8
  constexpr int NRG = THREADS / NCG;   // row groups
  constexpr int RPT = TD / 16;         // output rows per thread (128 / NRG)
  constexpr int UPT = 8;               // state rows per thread (at most)
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = a.C, m = a.m, hd = a.hd, R = a.R, L = a.L;
  const bool decay = a.lg != nullptr;
  const int LDQ = C + 1;   // odd row length: conflict-free column walks
  const int RM = R * m;

  // the state and v tiles first: their rows (TD floats) stay 32-byte
  // aligned for load8/store8
  float* ss = smem;              // RM x TD   state tile
  float* vs = ss + RM * TD;      // C x TD    v tile
  float* zs = vs + C * TD;       // RM        normalizer state
  float* as = zs + RM;           // C x R     alpha rows of this chunk
  float* bs = as + C * R;        // C x R     beta rows of this chunk
  float* ds = bs + C * R;        // C         clamped den of this chunk
  float* qs = ds + C;            // m x LDQ   q transposed
  float* ks = qs + m * LDQ;      // m x LDQ   k transposed
  float* pt = ks + m * LDQ;      // C x LDQ   P transposed: pt[j][i]

  const long bh = (long)b * a.H + h;
  const float* qg = a.q + bh * L * m;
  const float* kg = a.k + bh * L * m;
  const float* vg = a.v + bh * L * hd;
  const float* dm = a.dmat + (long)h * C * C;
  const int t0 = tile * TD;
  const float lg = decay ? a.lg[h] : 0.0f;
  const float gC = decay ? expf(lg * (float)C) : 1.0f;

  for (int e = tid; e < RM * TD; e += THREADS) ss[e] = 0.0f;
  for (int e = tid; e < RM; e += THREADS) zs[e] = 0.0f;
  if (decay) {  // R == 1: the decays by local position, the same each chunk
    for (int i = tid; i < C; i += THREADS) {
      as[i] = expf(lg * (float)i);
      bs[i] = expf(lg * (float)(C - i));
    }
  }

  const int tx = tid % 16, ty = tid / 16;   // P micro-tile grid
  const int rg = tid % NRG, cg = tid / NRG; // output / state tiles

  // The state rows this thread updates (r = ur, mm = um, row urm; ur < 0
  // for none). Where the rows fill the threads exactly (m divides NRG and
  // R*m = UPT*NRG, the served rank mode) a thread takes one mm and UPT
  // consecutive r, so a step of the update reads one k and UPT betas as two
  // 16-byte loads; otherwise it takes rows rg + NRG * u.
  const bool consec = NRG % m == 0 && R % UPT == 0 && RM == UPT * NRG;
  int ur[UPT], um[UPT], urm[UPT];
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int rm = consec ? ((rg / m) * UPT + u) * m + rg % m : rg + NRG * u;
    ur[u] = rm < RM ? rm / m : -1;
    um[u] = rm < RM ? rm - (rm / m) * m : 0;
    urm[u] = rm;
  }
  // rank mode at TD = 16 splits the read of the state over 4 groups of
  // R / 4 moments (64 threads each, 8 rows x 4 columns a thread) and sums
  // the groups' partials through shared memory
  const bool split = TD == 16 && R % 4 == 0;

  const int nC = L / C;
  for (int c = 0; c < nC; ++c) {
    const long p0 = (long)c * C;
    __syncthreads();  // the previous chunk is done with the staged tiles
    // 1. stage
    for (int e = tid; e < C * m; e += THREADS) {
      const int i = e / m, mm = e - i * m;
      qs[mm * LDQ + i] = qg[p0 * m + e];
      ks[mm * LDQ + i] = kg[p0 * m + e];
    }
    for (int e = tid; e < C * TD; e += THREADS) {
      const int j = e / TD, t = e - j * TD;
      vs[e] = (t0 + t < hd) ? vg[(p0 + j) * hd + t0 + t] : 0.0f;
    }
    if (!decay) {
      const float* ag = a.alpha + ((long)h * L + p0) * R;
      const float* bg = a.beta + ((long)h * L + p0) * R;
      for (int e = tid; e < C * R; e += THREADS) {
        as[e] = ag[e];
        bs[e] = bg[e];
      }
    }
    __syncthreads();

    // 2. P[i][j] = (q_i . k_j) * dmat[i][j], i = ty + 16x, j = tx + 16y
    {
      float acc[8][8];
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = 0.0f;
#pragma unroll 4
      for (int mm = 0; mm < m; ++mm) {
        float qv[8], kv[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int i = ty + 16 * x;
          qv[x] = i < C ? qs[mm * LDQ + i] : 0.0f;
          const int j = tx + 16 * x;
          kv[x] = j < C ? ks[mm * LDQ + j] : 0.0f;
        }
#pragma unroll
        for (int x = 0; x < 8; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(qv[x], kv[y], acc[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = ty + 16 * x;
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          const int j = tx + 16 * y;
          if (i < C && j < C) pt[j * LDQ + i] = acc[x][y] * dm[i * C + j];
        }
      }
    }
    __syncthreads();

    // 3a. within the chunk: num = P v, den = rowsum(P)
    float num[RPT][8], den[RPT];
#pragma unroll
    for (int x = 0; x < RPT; ++x) {
      den[x] = 0.0f;
#pragma unroll
      for (int y = 0; y < 8; ++y) num[x][y] = 0.0f;
    }
#pragma unroll 4
    for (int j = 0; j < C; ++j) {
      float vv[8];
      load8(vs + j * TD + cg * 8, vv);
#pragma unroll
      for (int x = 0; x < RPT; ++x) {
        const int i = rg + NRG * x;
        const float p = i < C ? pt[j * LDQ + i] : 0.0f;
        den[x] += p;
#pragma unroll
        for (int y = 0; y < 8; ++y) num[x][y] = fmaf(p, vv[y], num[x][y]);
      }
    }
    // 3b. across chunks: read the state as it stood before this chunk
    if (split) {
      const int kq = tid / 64, tc = tid % 4, tr = (tid % 64) / 4;
      const int rq = R / 4;
      float np[8][4], dp[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        dp[x] = 0.0f;
#pragma unroll
        for (int y = 0; y < 4; ++y) np[x][y] = 0.0f;
      }
      for (int r = kq * rq; r < (kq + 1) * rq; ++r) {
        float acc[8][4], dacc[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          dacc[x] = 0.0f;
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
        }
#pragma unroll 2
        for (int mm = 0; mm < m; ++mm) {
          const float4 s4 = *reinterpret_cast<const float4*>(
              ss + (r * m + mm) * TD + tc * 4);
          const float z = zs[r * m + mm];
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int i = tr + 16 * x;
            const float qv = i < C ? qs[mm * LDQ + i] : 0.0f;
            dacc[x] = fmaf(qv, z, dacc[x]);
            acc[x][0] = fmaf(qv, s4.x, acc[x][0]);
            acc[x][1] = fmaf(qv, s4.y, acc[x][1]);
            acc[x][2] = fmaf(qv, s4.z, acc[x][2]);
            acc[x][3] = fmaf(qv, s4.w, acc[x][3]);
          }
        }
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int i = tr + 16 * x;
          const float al = i < C ? as[i * R + r] : 0.0f;
          dp[x] = fmaf(al, dacc[x], dp[x]);
#pragma unroll
          for (int y = 0; y < 4; ++y) np[x][y] = fmaf(al, acc[x][y], np[x][y]);
        }
      }
      // the partials go where P was: (4, C, TD) sums, then (4, C) dens
      float* red = pt + ((4 - ((pt - smem) & 3)) & 3);  // 16-byte aligned
      __syncthreads();  // every thread is done reading P
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = tr + 16 * x;
        if (i < C) {
          *reinterpret_cast<float4*>(red + (kq * C + i) * TD + tc * 4) =
              make_float4(np[x][0], np[x][1], np[x][2], np[x][3]);
          if (tc == 0) red[4 * C * TD + kq * C + i] = dp[x];
        }
      }
      __syncthreads();
#pragma unroll
      for (int x = 0; x < RPT; ++x) {
        const int i = rg + NRG * x;
        if (i < C) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float part[8];
            load8(red + (k * C + i) * TD + cg * 8, part);
#pragma unroll
            for (int y = 0; y < 8; ++y) num[x][y] += part[y];
            den[x] += red[4 * C * TD + k * C + i];
          }
        }
      }
    } else {  // the den is needed by the warps of column group 0 alone
      for (int r = 0; r < R; ++r) {
        float acc[RPT][8], dacc[RPT];
#pragma unroll
        for (int x = 0; x < RPT; ++x) {
          dacc[x] = 0.0f;
#pragma unroll
          for (int y = 0; y < 8; ++y) acc[x][y] = 0.0f;
        }
#pragma unroll 4
        for (int mm = 0; mm < m; ++mm) {
          float sv[8];
          load8(ss + (r * m + mm) * TD + cg * 8, sv);
          const float z = cg == 0 ? zs[r * m + mm] : 0.0f;
#pragma unroll
          for (int x = 0; x < RPT; ++x) {
            const int i = rg + NRG * x;
            const float qv = i < C ? qs[mm * LDQ + i] : 0.0f;
            dacc[x] = fmaf(qv, z, dacc[x]);
#pragma unroll
            for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(qv, sv[y], acc[x][y]);
          }
        }
#pragma unroll
        for (int x = 0; x < RPT; ++x) {
          const int i = rg + NRG * x;
          const float al = i < C ? as[i * R + r] : 0.0f;
          den[x] = fmaf(al, dacc[x], den[x]);
#pragma unroll
          for (int y = 0; y < 8; ++y)
            num[x][y] = fmaf(al, acc[x][y], num[x][y]);
        }
      }
    }

    // 4. emit
    if (cg == 0) {
#pragma unroll
      for (int x = 0; x < RPT; ++x) {
        const int i = rg + NRG * x;
        if (i < C) {
          float d = den[x];
          if (a.res_den) d += a.res_den[bh * L + p0 + i];
          if (a.normalize) {
            d = fabsf(d) < a.eps ? a.eps : d;
          } else if (tile == 0) {
            a.den_out[bh * L + p0 + i] = d;
          }
          ds[i] = d;
        }
      }
    }
    __syncthreads();  // ds is ready; every read of ss/zs above is done
#pragma unroll
    for (int x = 0; x < RPT; ++x) {
      const int i = rg + NRG * x;
      if (i >= C) continue;
      const long row = (bh * L + p0 + i) * hd;
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        const int col = t0 + cg * 8 + y;
        if (col < hd) {
          float n = num[x][y];
          if (a.res_num) n += a.res_num[row + col];
          a.out[row + col] = a.normalize ? n / ds[i] : n;
        }
      }
    }

    // 5. update the state with this chunk: S (+)= (beta * k)^T v
    {
      float acc[UPT][8], zacc[UPT];
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
        zacc[u] = 0.0f;
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[u][y] = 0.0f;
      }
      if (consec) {
#pragma unroll 2
        for (int j = 0; j < C; ++j) {
          float vv[8], bb[UPT];
          load8(vs + j * TD + cg * 8, vv);
          load8(bs + j * R + ur[0], bb);
          const float kk = ks[um[0] * LDQ + j];
#pragma unroll
          for (int u = 0; u < UPT; ++u) {
            const float kb = bb[u] * kk;
            zacc[u] += kb;
#pragma unroll
            for (int y = 0; y < 8; ++y) acc[u][y] = fmaf(kb, vv[y], acc[u][y]);
          }
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < C; ++j) {
          float vv[8];
          load8(vs + j * TD + cg * 8, vv);
#pragma unroll
          for (int u = 0; u < UPT; ++u) {
            if (ur[u] >= 0) {
              const float kb = bs[j * R + ur[u]] * ks[um[u] * LDQ + j];
              zacc[u] += kb;
#pragma unroll
              for (int y = 0; y < 8; ++y)
                acc[u][y] = fmaf(kb, vv[y], acc[u][y]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
        if (ur[u] >= 0) {
          const int rm = urm[u];
          float* srow = ss + rm * TD + cg * 8;
          float sv[8];
          load8(srow, sv);
#pragma unroll
          for (int y = 0; y < 8; ++y)
            sv[y] = decay ? gC * sv[y] + acc[u][y] : sv[y] + acc[u][y];
          store8(srow, sv);
          if (cg == 0)
            zs[rm] = decay ? gC * zs[rm] + zacc[u] : zs[rm] + zacc[u];
        }
      }
    }
  }
}

template <int TD>
int launch(const SweepArgs& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topo_sweep_kernel<TD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.hd + TD - 1) / TD, a.H, B);
  topo_sweep_kernel<TD><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). Checks nothing the
// Python wrapper checks (shapes, types, contiguity, the device, td and the
// shared-memory size, which it computes with the layout above).
extern "C" int topo_sweep_launch(
    int td, const float* q, const float* k, const float* v, const float* dmat,
    const float* lg, const float* alpha, const float* beta,
    const float* res_num, const float* res_den, float* out, float* den_out,
    int B, int H, int L, int m, int hd, int C, int R, float eps, int normalize,
    long long smem, void* stream) {
  SweepArgs a{q, k, v, dmat, lg, alpha, beta, res_num, res_den, out, den_out,
              H, L, m, hd, C, R, eps, normalize};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (td) {
    case 16: return launch<16>(a, B, (size_t)smem, s);
    case 32: return launch<32>(a, B, (size_t)smem, s);
    case 64: return launch<64>(a, B, (size_t)smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
