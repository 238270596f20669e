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
// pair). Inputs and outputs are fp32, as the reference kernel's are.
//
// Replaces the TPU kernel `topo_attention_sweep_pallas` in
// src/repro/kernels/topo_linear_attention/kernel.py (bodies _decay_kernel,
// _rank_kernel, _emit).
//
// Bound on an H100, reckoned from the code (not measured) for the served
// shape B = 4, H = 32, L = 4096, m = hd = 64, C = 128, one causal launch,
// counting the causal half of q k^T and P v (chip_smoke.py's topo_work):
// decay mode 17.5 GFLOP, rank mode (R = 16) 148 GFLOP; 0.54-0.56 GB of
// q, k, v, the tables and the output (0.161 / 0.166 ms at 3.35 TB/s). At
// 67 TFLOP/s of fp32 outside the tensor cores that is 0.261 / 2.215 ms,
// bound by operations. This kernel runs the products on the tensor cores
// as 3xTF32 (three TF32 products per fp32 product, 495 TFLOP/s): 0.161 ms
// in decay mode, bound by bytes, and 0.899 ms in rank mode, bound by
// operations.
//
// One kernel, topo_sweep_tc_kernel, takes every shape with C <= 128,
// m <= 64 and (rank mode) R <= 16, which includes every served one; kernel.py
// refuses the rest, and rows that are not 16-byte aligned, with a ValueError.
// A C that is not a multiple of 8 and an m or hd that is not a multiple of 4
// are zero-filled in shared memory: the staged k, v and beta rows past C and
// columns past m or the hd tile stay 0, so the mma tiles that cover them add
// nothing.
// Route: mma.sync m16n8k8 with tf32 inputs and fp32 sums, not wgmma. The
// accumulator of q k^T becomes the A operand of P v in registers (the keys
// 2t, 2t + 1 of a lane are its k-indices t, t + 4, and v's rows are read in
// that order), and every operand is split into tf32 hi + lo in registers as
// it is loaded; with wgmma (whose tf32 operands must both be K-major in
// shared memory) P, v and the state would be staged twice more, hi and lo,
// in a block whose shared memory rank mode already fills.
//   * 3xTF32. Each fp32 operand x is split into x_hi = rna_tf32(x) (the
//     rounding done on the bits) and x_lo = x - x_hi (exact; the tensor
//     cores read its top 19 bits, so it is truncated to tf32 there), and
//     each product is a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32, about
//     2^-20 relative: one TF32 pass misses the 1e-4 bound against the plain
//     version (tests/test_torch_topo_attention.py emulates both).
//   * One block owns one (b, h, tile of TD columns of hd) and loops over
//     the chunks; warp w owns rows 16w .. 16w + 15 of a chunk. Per chunk:
//     1. q k^T by 8-key tiles up to the diagonal only (the tiles above it
//        are not computed: dmat vanishes there), times dmat; its row sums;
//        P v. P never leaves the warp's registers.
//     2. The write: dS = (beta * k)^T v and dz = k^T beta into fresh
//        accumulators (warp w: one n-tile of the hd tile, the moments
//        w / (TD / 8) + (8 / (TD / 8)) i, every m-tile). z is kept as an
//        (m x R) matrix k^T beta, so the den comes from products too (q z
//        per moment, then alpha).
//     3. The read of the state as it stood before the chunk, from its
//        split copy (hi and lo) in shared memory: num += sum_r alpha_r
//        (q S_r), den += sum_r alpha_r (q z_r).
//     4. Emit; 5. S <- gC S + dS, z <- gC z + dz in fp32, from and into the
//        state's split copy, kept in the order of the B fragments of step 3
//        (one 16-byte load a fragment, hi and lo; hi + lo is S exactly).
//        The tensor cores round each mma's fp32 sum toward zero, so no sum
//        stays in their accumulators longer than one chunk: a state
//        accumulated there over the whole sequence read 1.32e-5 in the
//        cache of chip_smoke.py's float32 gate at degree 1 (limit 1e-5; an
//        H100 80GB HBM3 at 700 W), and the CPU emulation shows the drift
//        growing with L.
//   * Copies overlap compute: the k, v, alpha and beta rows are staged with
//     cp.async, a whole chunk ahead into a second buffer where shared memory
//     allows (decay mode), else into the single buffer as soon as step 2
//     is done with it, in flight during steps 3-5 (rank mode); each warp
//     loads its q rows of the next chunk into registers (fp32, split at each
//     use) after step 3, in flight during steps 4-5.
//   * Decay mode keeps the sequential loop over chunks: TD = 64, one block
//     per (b, h), 128 blocks of 8 warps on the 132 SMs, each with 8 to 32
//     independent accumulators a warp in flight, so every SM but four has a
//     tensor pipe fed by 8 warps; a chunk-parallel form would add a second
//     pass and 64 MB of scratch for what the idle four SMs leave.
//   * Rank mode: the state (R*m x hd = 1024 x 64 at the served shape) is
//     too large for one block's registers and shared memory, so TD = 16,
//     four blocks per (b, h), 64 fp32 state registers a thread and 128 KiB
//     of its split copy; each of the four recomputes q k^T (432 of its 5,072
//     m16n8k8 steps a chunk, 8.5%).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

constexpr int THREADS = 256;  // 8 warps; warp w owns rows 16w .. 16w + 15

// the A fragment of one m16n8k8 step, each value split into tf32 hi + lo
struct Frag {
  uint32_t hi[4], lo[4];
};
// the B fragment, split: (b0, b1) hi and lo
struct BFrag {
  uint32_t h0, h1, l0, l1;
};

// x rounded to tf32 (10 explicit mantissa bits), to nearest with ties away
// from zero: cvt.rna.tf32.f32, done on the bits
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32(x), lo = x - hi exactly (fp32). lo is handed to
// the tensor cores as it is, and they read a tf32 operand's top 19 bits:
// lo truncated, x = hi + lo_tf32 + O(2^-21 |x|)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ BFrag bsplit(float x0, float x1) {
  BFrag f;
  split(x0, f.h0, f.l0);
  split(x1, f.h1, f.l1);
  return f;
}

__device__ __forceinline__ Frag fsplit(float a0, float a1, float a2,
                                       float a3) {
  Frag f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// d += a b on the tensor cores: one m16n8k8 product of tf32 values, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first.
// Pass p of it; the loops below run pass 0 over every accumulator of a step,
// then pass 1, then pass 2, so that dependent products lie far apart
__device__ __forceinline__ void mma_pass(int p, float (&d)[4], const Frag& a,
                                         const BFrag& b) {
  if (p == 0) mma(d, a.lo, b.h0, b.h1);
  else if (p == 1) mma(d, a.hi, b.l0, b.l1);
  else mma(d, a.hi, b.h0, b.h1);
}
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a,
                                     const BFrag& b) {
#pragma unroll
  for (int p = 0; p < 3; ++p) mma_pass(p, d, a, b);
}

// The split state is kept in the order of the B fragments that read it: an
// 8 x 8 block (k-step, n-tile) of a matrix is 32 float4s, lane (g, t)'s
// (hi(b0), hi(b1), lo(b0), lo(b1)) with b0 at (row t, column g) and b1 at
// (row t + 4, column g), so that each read is one conflict-free 16-byte
// load. The B fragment of block `blk` for this lane:
__device__ __forceinline__ BFrag frag_load(const float* f, int blk, int lane) {
  const float4 v = *reinterpret_cast<const float4*>(f + (blk * 32 + lane) * 4);
  return BFrag{__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z),
               __float_as_uint(v.w)};
}

// The element at (row r8, column c8) of block `blk`: its hi at e, its lo at
// e + 2. lo = x - hi is stored in full (the tensor cores truncate it as they
// read it), so hi + lo is x exactly.
__device__ __forceinline__ int frag_at(int blk, int r8, int c8) {
  return (blk * 32 + 4 * c8 + (r8 & 3)) * 4 + (r8 >> 2);
}

// x <- g x + d at that element, in fp32 (one rounding), and split again
__device__ __forceinline__ void frag_update(float* f, int blk, int r8, int c8,
                                            float g, float d) {
  const int e = frag_at(blk, r8, c8);
  uint32_t hi, lo;
  split(fmaf(g, f[e] + f[e + 2], d), hi, lo);
  f[e] = __uint_as_float(hi);
  f[e + 2] = __uint_as_float(lo);
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// TD: columns of hd per block, 16 (rank mode, R <= 16) or 64 (decay mode).
// nbuf: 1 or 2 staging buffers for the k, v and beta rows (kernel.py picks
// 2 where they fit in shared memory). Requires C <= 128, m <= 64, R <= 16,
// 16-byte aligned q, k, v and res_num, and a dmat that vanishes above its
// diagonal (only its lower tiles are read).
template <int TD>
__global__ void __launch_bounds__(THREADS, 1)
topo_sweep_tc_kernel(const SweepArgs a, const int nbuf) {
  constexpr int NT = TD / 8;              // n-tiles of the hd tile
  constexpr int NG = 8 / NT;              // moment groups of the write
  constexpr int NRW = TD == 16 ? 4 : 1;   // moments one warp writes, at most
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = a.C, m = a.m, hd = a.hd, L = a.L;
  const bool decay = a.lg != nullptr;
  const int R = decay ? 1 : a.R;
  const int KQ = (m + 7) / 8;       // k-steps over m
  const int M16 = (m + 15) & ~15;   // state rows of one moment
  const int MT = M16 / 16;          // their m-tiles
  const int R8 = (R + 7) & ~7;      // columns of the z state
  const int NZ = R8 / 8;
  const int PQ = M16 + 4, PV = TD + 4, PB = R + 1;  // padded row lengths
  const int RS = R * M16;
  const int KM = M16 / 8;           // 8-row blocks of one moment
  const int CS = (C + 7) & ~7;       // staged rows of a chunk (past C: 0)
  const int NC8 = CS / 8;
  const int t0 = tile * TD;
  const int wv = min(TD, hd - t0);  // live columns of this tile

  float* sf = smem;                     // 2 RS TD   the state S, split, by
                                        //           8 x 8 block (r, k, n-tile)
  float* zf = sf + 2 * RS * TD;         // 2 M16 R8  the state z, split, by
                                        //           block (k, n-tile)
  float* kbuf = zf + 2 * M16 * R8;      // nbuf x CS x PQ  k rows
  float* vbuf = kbuf + nbuf * CS * PQ;  // nbuf x CS x PV  v rows of the tile
  float* bbuf = vbuf + nbuf * CS * PV;  // nbuf x CS x PB  beta rows
  float* abuf = bbuf + nbuf * CS * PB;  // 2 x CS x PB     alpha rows

  const long long bh = (long long)b * a.H + h;
  const float* qg = a.q + bh * L * m;
  const float* kg = a.k + bh * L * m;
  const float* vg = a.v + bh * L * hd + t0;
  const float* dm = a.dmat + (long long)h * C * C;
  const float lg = decay ? a.lg[h] : 0.0f;
  const float gC = decay ? expf(lg * (float)C) : 1.0f;

  // the state starts at 0, and the pad rows and columns of the staged
  // chunks stay 0
  const int total = 2 * RS * TD + 2 * M16 * R8 + nbuf * CS * (PQ + PV + PB)
                    + 2 * CS * PB;
  for (int e = tid; e < total; e += THREADS) smem[e] = 0.0f;
  __syncthreads();
  if (decay) {  // R == 1: the decays by local position, the same each chunk
    for (int i = tid; i < C; i += THREADS) {
      abuf[i * PB] = expf(lg * (float)i);
      bbuf[i * PB] = expf(lg * (float)(C - i));
    }
  }

  // chunk c's k, v (and alpha, beta) rows into its buffers, one group
  auto issue = [&](int c) {
    const long long p0 = (long long)c * C;
    const int kb = c % nbuf;
    float* kd = kbuf + kb * CS * PQ;
    float* vd = vbuf + kb * CS * PV;
    if (m % 4 == 0) {  // 16-byte rows; else one float at a time
      const int m4 = m / 4;
      for (int e = tid; e < C * m4; e += THREADS) {
        const int j = e / m4, q = e - j * m4;
        cp16(kd + j * PQ + 4 * q, kg + (p0 + j) * m + 4 * q);
      }
    } else {
      for (int e = tid; e < C * m; e += THREADS) {
        const int j = e / m, q = e - j * m;
        cp4(kd + j * PQ + q, kg + (p0 + j) * m + q);
      }
    }
    if (hd % 4 == 0) {
      const int v4 = wv / 4;
      for (int e = tid; e < C * v4; e += THREADS) {
        const int j = e / v4, q = e - j * v4;
        cp16(vd + j * PV + 4 * q, vg + (p0 + j) * hd + 4 * q);
      }
    } else {
      for (int e = tid; e < C * wv; e += THREADS) {
        const int j = e / wv, q = e - j * wv;
        cp4(vd + j * PV + q, vg + (p0 + j) * hd + q);
      }
    }
    if (!decay) {
      float* bd = bbuf + kb * CS * PB;
      float* ad = abuf + (c & 1) * CS * PB;
      const float* bs = a.beta + ((long long)h * L + p0) * R;
      const float* as = a.alpha + ((long long)h * L + p0) * R;
      for (int e = tid; e < C * R; e += THREADS) {
        const int j = e / R, r = e - j * R;
        cp4(bd + j * PB + r, bs + e);
        cp4(ad + j * PB + r, as + e);
      }
    }
    cp_commit();
  };

  // chunk c's q rows of this warp, in the A-fragment order, into registers
  // (fp32; each use splits them)
  const int i0 = 16 * warp;
  const bool rows = i0 < C;
  float qn[32];
  auto load_q = [&](int c) {
    const float* qr = qg + ((long long)c * C + i0 + g) * m;
    const bool r0 = rows && i0 + g < C, r1 = rows && i0 + g + 8 < C;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c0 = 8 * k + t, c1 = c0 + 4;
      qn[4 * k + 0] = r0 && c0 < m ? __ldg(qr + c0) : 0.0f;
      qn[4 * k + 1] = r1 && c0 < m ? __ldg(qr + 8 * m + c0) : 0.0f;
      qn[4 * k + 2] = r0 && c1 < m ? __ldg(qr + c1) : 0.0f;
      qn[4 * k + 3] = r1 && c1 < m ? __ldg(qr + 8 * m + c1) : 0.0f;
    }
  };

  // the write: warp w owns n-tile wn of the hd tile and the moments
  // wg + NG i (all m-tiles); each chunk's dS goes into fresh accumulators
  // (48 products long), and S itself is updated in fp32 from its split copy,
  // so that the tensor cores' rounding toward zero of each mma's sum never
  // builds up along the sequence
  const int wn = warp % NT, wg = warp / NT;
  float sacc[NRW][4][4];
  // ... and z = sum_j beta_j k_j^T as an (M16 x R8) matrix: one tile a warp
  const bool zw = warp < MT * NZ;
  const int zmt = zw ? warp / NZ : 0, znt = zw ? warp % NZ : 0;
  float zacc[4];

  issue(0);
  load_q(0);
  const int nC = L / C;
  for (int c = 0; c < nC; ++c) {
    const long long p0 = (long long)c * C;
    const int kb = c % nbuf;
    const float* ks = kbuf + kb * CS * PQ;
    const float* vs = vbuf + kb * CS * PV;
    const float* bs = bbuf + (decay ? 0 : kb) * CS * PB;
    const float* as = abuf + (decay ? 0 : (c & 1)) * CS * PB;
    cp_wait_all();
    __syncthreads();  // chunk c is staged; the split state of chunk c-1 too
    if (nbuf == 2 && c + 1 < nC) issue(c + 1);  // a whole chunk ahead

    // 1. within the chunk: P = (q k^T) * dmat by 8-key tiles up to the
    //    diagonal, four at a time; its row sums; num = P v
    float num[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) num[nt][e] = 0.0f;
    float dsum0 = 0.0f, dsum1 = 0.0f;  // rows g, g + 8 (this lane's part)
    if (rows) {
      const int nkt = min(2 * warp + 2, NC8);
      for (int kt0 = 0; kt0 < nkt; kt0 += 4) {
        float s[4][4];
        float2 d0[4], d1[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kt = kt0 + u;
#pragma unroll
          for (int e = 0; e < 4; ++e) s[u][e] = 0.0f;
          // dmat at rows i0 + g (+ 8), keys j, j + 1: 0 past C
          const int j = 8 * kt + 2 * t;
          const bool ok = kt < nkt && j < C, ok1 = kt < nkt && j + 1 < C;
          const float* dr = dm + (i0 + g) * C + j;
          const bool ra = i0 + g < C, rb = i0 + g + 8 < C;
          d0[u] = make_float2(ra && ok ? dr[0] : 0.0f,
                              ra && ok1 ? dr[1] : 0.0f);
          d1[u] = make_float2(rb && ok ? dr[8 * C] : 0.0f,
                              rb && ok1 ? dr[8 * C + 1] : 0.0f);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k < KQ) {
            const Frag qf = fsplit(qn[4 * k], qn[4 * k + 1], qn[4 * k + 2],
                                   qn[4 * k + 3]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (kt0 + u < nkt) {
                const float* kr = ks + (8 * (kt0 + u) + g) * PQ + 8 * k + t;
                mma3(s[u], qf, bsplit(kr[0], kr[4]));
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kt = kt0 + u;
          if (kt < nkt) {
            const float p0v = s[u][0] * d0[u].x, p1v = s[u][1] * d0[u].y;
            const float p2v = s[u][2] * d1[u].x, p3v = s[u][3] * d1[u].y;
            dsum0 += p0v + p1v;
            dsum1 += p2v + p3v;
            // the accumulator is the A fragment of P v with the keys of
            // this lane, 2t and 2t + 1, as its k-indices t and t + 4
            const Frag pf = fsplit(p0v, p2v, p1v, p3v);
            const float* vr = vs + (8 * kt + 2 * t) * PV + g;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma3(num[nt], pf, bsplit(vr[8 * nt], vr[PV + 8 * nt]));
          }
        }
      }
    }

    // 2. the write: dS = (beta * k)^T v, dz = k^T beta (step 5 adds them)
#pragma unroll
    for (int i = 0; i < NRW; ++i)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[i][mt][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) zacc[e] = 0.0f;
    for (int k8 = 0; k8 < NC8; ++k8) {
      const int j = 8 * k8 + 2 * t;  // this lane's keys j, j + 1
      const float* kr = ks + j * PQ + g;
      Frag af[4];  // k^T by m-tile: rows mm, k-indices t, t + 4 = keys j, j + 1
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        if (mt < MT)
          af[mt] = fsplit(kr[16 * mt], kr[16 * mt + 8], kr[PQ + 16 * mt],
                          kr[PQ + 16 * mt + 8]);
      const float v0 = vs[j * PV + 8 * wn + g];
      const float v1 = vs[(j + 1) * PV + 8 * wn + g];
#pragma unroll
      for (int i = 0; i < NRW; ++i) {
        const int r = wg + NG * i;
        if (r < R) {  // B: beta_r * v
          const BFrag bf =
              bsplit(bs[j * PB + r] * v0, bs[(j + 1) * PB + r] * v1);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
              if (mt < MT) mma_pass(p, sacc[i][mt], af[mt], bf);
        }
      }
      if (zw) {
        const int r = 8 * znt + g;
        const BFrag zb = bsplit(r < R ? bs[j * PB + r] : 0.0f,
                                r < R ? bs[(j + 1) * PB + r] : 0.0f);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          if (mt == zmt) mma3(zacc, af[mt], zb);
      }
    }
    __syncthreads();  // every warp is done with this chunk's k, v, beta rows
    if (nbuf == 1 && c + 1 < nC) issue(c + 1);  // in flight from here on

    // 3. the read of the state as it stood before this chunk:
    //    num += sum_r alpha_r (q S_r), den += sum_r alpha_r (q z_r)
    if (rows) {
      const bool ra = i0 + g < C, rb = i0 + g + 8 < C;
      const float* ar0 = as + (i0 + g) * PB;
      const float* ar1 = ar0 + 8 * PB;
      for (int r0 = 0; r0 < R; r0 += NG) {
        float acc[NG][NT][4];
#pragma unroll
        for (int u = 0; u < NG; ++u)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k < KQ) {
            const Frag qf = fsplit(qn[4 * k], qn[4 * k + 1], qn[4 * k + 2],
                                   qn[4 * k + 3]);
#pragma unroll
            for (int u = 0; u < NG; ++u) {
              if (r0 + u < R) {
                BFrag bf[NT];
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
                  bf[nt] = frag_load(sf, ((r0 + u) * KM + k) * NT + nt, lane);
#pragma unroll
                for (int p = 0; p < 3; ++p)
#pragma unroll
                  for (int nt = 0; nt < NT; ++nt)
                    mma_pass(p, acc[u][nt], qf, bf[nt]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < NG; ++u) {
          if (r0 + u < R) {
            const float al0 = ra ? ar0[r0 + u] : 0.0f;
            const float al1 = rb ? ar1[r0 + u] : 0.0f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              num[nt][0] = fmaf(al0, acc[u][nt][0], num[nt][0]);
              num[nt][1] = fmaf(al0, acc[u][nt][1], num[nt][1]);
              num[nt][2] = fmaf(al1, acc[u][nt][2], num[nt][2]);
              num[nt][3] = fmaf(al1, acc[u][nt][3], num[nt][3]);
            }
          }
        }
      }
      float qz[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < KQ) {
          const Frag qf = fsplit(qn[4 * k], qn[4 * k + 1], qn[4 * k + 2],
                                 qn[4 * k + 3]);
#pragma unroll
          for (int nz = 0; nz < 2; ++nz) {
            if (nz < NZ) mma3(qz[nz], qf, frag_load(zf, k * NZ + nz, lane));
          }
        }
      }
#pragma unroll
      for (int nz = 0; nz < 2; ++nz) {
        if (nz < NZ) {
          const int c0 = 8 * nz + 2 * t, c1 = c0 + 1;
          if (ra && c0 < R) dsum0 = fmaf(ar0[c0], qz[nz][0], dsum0);
          if (ra && c1 < R) dsum0 = fmaf(ar0[c1], qz[nz][1], dsum0);
          if (rb && c0 < R) dsum1 = fmaf(ar1[c0], qz[nz][2], dsum1);
          if (rb && c1 < R) dsum1 = fmaf(ar1[c1], qz[nz][3], dsum1);
        }
      }
    }
    // the next chunk's q rows: in flight during the emit and the store
    if (c + 1 < nC) load_q(c + 1);

    // 4. emit: each row's den summed over the four lanes that hold it
    if (rows) {
      dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 1);
      dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 2);
      dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 1);
      dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 2);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = i0 + g + 8 * x;
        if (i < C) {
          const long long row = bh * L + p0 + i;
          float d = x ? dsum1 : dsum0;
          if (a.res_den) d += a.res_den[row];
          if (a.normalize) {
            d = fabsf(d) < a.eps ? a.eps : d;
          } else if (tile == 0 && t == 0) {
            a.den_out[row] = d;
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = 8 * nt + 2 * t;
            if (col < wv) {
              float n0 = num[nt][2 * x], n1 = num[nt][2 * x + 1];
              const long long e = row * hd + t0 + col;
              if (hd % 2 == 0) {  // the pair (col, col + 1) is 8-byte aligned
                if (a.res_num) {
                  const float2 rn =
                      *reinterpret_cast<const float2*>(a.res_num + e);
                  n0 += rn.x;
                  n1 += rn.y;
                }
                *reinterpret_cast<float2*>(a.out + e) =
                    a.normalize ? make_float2(n0 / d, n1 / d)
                                : make_float2(n0, n1);
              } else {  // an odd hd: one float at a time, col + 1 may be past
                const bool two = col + 1 < wv;
                if (a.res_num) {
                  n0 += a.res_num[e];
                  if (two) n1 += a.res_num[e + 1];
                }
                a.out[e] = a.normalize ? n0 / d : n0;
                if (two) a.out[e + 1] = a.normalize ? n1 / d : n1;
              }
            }
          }
        }
      }
    }

    // 5. the new state, S <- gC S + dS and z <- gC z + dz, in fp32 from the
    //    exact split copy, split again for the next chunk's read
    __syncthreads();  // every warp is done reading the split state
#pragma unroll
    for (int i = 0; i < NRW; ++i) {
      const int r = wg + NG * i;
      if (r < R) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt < MT) {
            // rows 16 mt + g (+ 8) are blocks 2 mt (+ 1), row g there
            const int blk = (r * KM + 2 * mt) * NT + wn;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              frag_update(sf, blk + (e >> 1) * NT, g, 2 * t + (e & 1), gC,
                          sacc[i][mt][e]);
          }
        }
      }
    }
    if (zw) {
      const int blk = 2 * zmt * NZ + znt;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        frag_update(zf, blk + (e >> 1) * NZ, g, 2 * t + (e & 1), gC,
                    zacc[e]);
    }
  }
}

template <int TD>
int launch(const SweepArgs& a, int B, int nbuf, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      topo_sweep_tc_kernel<TD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.hd + TD - 1) / TD, a.H, B);
  topo_sweep_tc_kernel<TD><<<grid, THREADS, smem, stream>>>(a, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success): td 16 or 64, nbuf 1
// or 2. Checks nothing the Python wrapper checks (shapes, types,
// contiguity, alignment, the device, the limits on C, m and R, and the
// shared-memory size, which it computes with the layout above).
extern "C" int topo_sweep_launch(
    int td, int nbuf, const float* q, const float* k, const float* v,
    const float* dmat, const float* lg, const float* alpha,
    const float* beta, const float* res_num, const float* res_den,
    float* out, float* den_out, int B, int H, int L, int m, int hd, int C,
    int R, float eps, int normalize, long long smem, void* stream) {
  SweepArgs a{q, k, v, dmat, lg, alpha, beta, res_num, res_den, out, den_out,
              H, L, m, hd, C, R, eps, normalize};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbuf != 1 && nbuf != 2) return (int)cudaErrorInvalidValue;
  switch (td) {
    case 16: return launch<16>(a, B, nbuf, (size_t)smem, s);
    case 64: return launch<64>(a, B, nbuf, (size_t)smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
