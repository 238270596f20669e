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
// Performer prefill B = 4, H = 32, L = 4096, m = hd = 64, bf16 v. The
// bytes, q, k, num and den in fp32 and v in bf16, 0.47 GB, take 0.141 ms at
// 3.35 TB/s. The function does not depend on the chunk, so its least work is
// that of C = 1: per row the read of the state (q S, q z) and its update
// (k^T v, z + k), 4 m (hd + 1) operations, and the diagonal pair,
// 2 m + 2 hd + 2; 8.9e9 in all: 0.054 ms as 3xTF32 products on the tensor
// cores (495 / 3 TFLOP/s), 0.132 ms as fp32 FMAs outside them (67 TFLOP/s).
// Bound by bytes, at 0.141 ms. This kernel's C = 64 adds the causal half of
// the C x C quadratic, about C (m + hd) operations a row, on the tensor
// cores.
//
// Design. One kernel, lin_attn_tc_kernel, for f32 and bf16 v; m <= 64
// (kernel.py and ops.py refuse a larger m with a ValueError).
//   * One block of 16 warps owns one (b, h, tile of TD = 64 columns of
//     hd) and walks the chunks of C = 64 in order, with the state in shared
//     memory: 128 blocks at the served shape, one for each of 128 of the
//     132 SMs (so the block brings its own latency hiding: 4 warps on each
//     SM sub-partition). Columns past hd are zero, and a wider hd takes
//     more tiles over blockIdx.x; P and den do not depend on hd, so each hd
//     tile recomputes them and the first tile writes den.
//   * The four products (q k^T, P v, q S and the write dS = (k gamma^(C -
//     pos))^T v) run on the tensor cores: mma.sync m16n8k8 with tf32
//     inputs and fp32 sums, as 3xTF32. Each fp32 operand x is split into
//     x_hi = rna_tf32(x) (the rounding done on the bits) and x_lo = x -
//     x_hi, and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi. A bf16
//     v is exact in tf32 (its lo is 0), so P v and dS take two passes
//     there; q k^T and q S always take three.
//   * Warp w owns row tile rt = w / 4 (16 rows) of the chunk and quarter
//     nq = w % 4 (16 columns, two n-tiles) of the hd tile, so each SM
//     sub-partition (the warps w % 4) holds one warp of every row tile.
//     q k^T is computed for the key tiles at or below the diagonal
//     (2 rt + 2 of the 8), times gamma^(i-j): the four warps of a row tile
//     take every fourth key tile and exchange P through shared memory (a
//     128-thread named barrier), so no product is computed twice. P is
//     then read back as the A operand of P v (the keys 2t, 2t + 1 of a lane
//     are its k-indices t, t + 4, and v's rows are read in that order).
//     The write's m x TD tile is cut into 32 units of 16 rows x 8 columns,
//     handed out 4, 3, 1, 0 per warp of row tile 0, 1, 2, 3, so the causal
//     work and the write even out (128 to 144 m16n8k8 steps a warp a
//     chunk with a bf16 v).
//   * The state. Each chunk's dS comes from fresh accumulators (8 k-steps
//     long), and S <- gamma^C S + dS is one fp32 FFMA on the exact split
//     copy of S kept in shared memory in the order of q S's B fragments
//     (one 16-byte load a fragment, hi and lo). The tensor cores round each
//     mma's sum toward zero, so no sum stays in their accumulators longer
//     than one chunk. z (m) is kept in fp32: dz (by two warps of row tile
//     3, which have no unit of the write) and q . z are fp32 FMAs, and
//     den = rowsum(P) + gamma^pos (q . z).
//     S and z have two copies, before and after the chunk, so a warp
//     writes its units of the new state as soon as its dS is done.
//   * The decays gamma^d, d = 0..C, are one table computed once per block;
//     gamma^pos, gamma^(C-pos), gamma^(i-j) and gamma^C all read it, and
//     lg = 0 gives exactly 1.
//   * Copies. q, k and the v tile of the next chunk are staged with
//     cp.async into a second buffer while the block computes this one
//     (16 bytes a copy; rows past L are zero-filled by the copy). Data
//     that is not 16-byte aligned is staged by plain loads instead. q and k
//     rows are staged 64 wide whatever m is: columns past m, like those
//     past the hd tile, are never written and stay 0, so the mma tiles
//     over them add nothing, and every loop over m has a fixed length. Each
//     warp's share of a chunk is compiled for its row tile (chunk_work<RT>),
//     so its loops are unrolled and no mma is predicated.
//   * One block barrier a chunk: the staged chunk and the new state are
//     ready, and every read of the buffers the next chunk writes is done.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 64;         // chunk length
constexpr int TD = 64;        // columns of hd a block owns
constexpr int NT = TD / 8;    // n-tiles of the hd tile
constexpr int MAX_M = 64;     // q fragments: 8 k-steps; dS: 4 m-tiles
constexpr int THREADS = 512;  // 16 warps
constexpr int PQ = MAX_M + 4; // floats a staged q or k row takes
constexpr int PV = TD + 4;    // floats a staged v row takes
constexpr int PP = C + 8;     // floats a row of P takes
constexpr int SF = 2 * MAX_M * TD;  // floats of one split copy of S
// the block's shared memory, in floats: two copies of S (before and after
// a chunk), two buffers each of q, k and v rows, P, two copies of z, and
// the decay table
constexpr int SM_S = 0;
constexpr int SM_Q = SM_S + 2 * SF;
constexpr int SM_K = SM_Q + 2 * C * PQ;
constexpr int SM_V = SM_K + 2 * C * PQ;
constexpr int SM_P = SM_V + 2 * C * PV;
constexpr int SM_Z = SM_P + C * PP;
constexpr int SM_E = SM_Z + 2 * MAX_M;
constexpr int SM_FLOATS = SM_E + C + 4;

// element strides (batch, head, row) of q, k, v, num and den; the last
// dimension of q, k, v and num is contiguous
struct Strides {
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, nb, nh, nl, db, dh, dl;
};

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
// then pass 1, then pass 2, so that dependent products lie apart. Pass 1
// vanishes where b is exact in tf32 (a bf16 v), and is skipped there
__device__ __forceinline__ void mma_pass(int p, float (&d)[4], const Frag& a,
                                         const BFrag& b) {
  if (p == 0) mma(d, a.lo, b.h0, b.h1);
  else if (p == 1) mma(d, a.hi, b.l0, b.l1);
  else mma(d, a.hi, b.h0, b.h1);
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

// x <- g x + d at that element, in fp32 (one rounding) from the copy
// `from`, split again into the copy `to`
__device__ __forceinline__ void frag_update(float* to, const float* from,
                                            int blk, int r8, int c8, float g,
                                            float d) {
  const int e = frag_at(blk, r8, c8);
  uint32_t hi, lo;
  split(fmaf(g, from[e] + from[e + 2], d), hi, lo);
  to[e] = __uint_as_float(hi);
  to[e + 2] = __uint_as_float(lo);
}

// 16 bytes global -> shared in flight; zero-filled when !ok (src not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v by element type: the staged row's pitch (elements), the passes of a
// product with v as its B operand, and v's B fragment at rows j, j + 1 of
// column n (a bf16 value is exact in tf32: hi is the value, lo 0)
template <typename TV>
struct VTraits;
template <>
struct VTraits<float> {
  static constexpr int PITCH = TD + 4;
  static constexpr int PASSES = 3;
  static __device__ __forceinline__ BFrag frag(const float* vs, int j, int n) {
    return bsplit(vs[j * PITCH + n], vs[(j + 1) * PITCH + n]);
  }
  static __device__ __forceinline__ float zero() { return 0.0f; }
};
template <>
struct VTraits<__nv_bfloat16> {
  static constexpr int PITCH = TD + 8;
  static constexpr int PASSES = 2;
  static __device__ __forceinline__ BFrag frag(const __nv_bfloat16* vs, int j,
                                               int n) {
    return BFrag{__float_as_uint(__bfloat162float(vs[j * PITCH + n])),
                 __float_as_uint(__bfloat162float(vs[(j + 1) * PITCH + n])),
                 0u, 0u};
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.0f);
  }
};

// What one chunk's work reads and writes: its staged rows, the state
// before it and the copy that takes the state after it, P's rows, the
// decay table, and the outputs
template <typename TV>
struct Chunk {
  const float* qs;     // C x PQ  q rows
  const float* ks;     // C x PQ  k rows
  const TV* vs;        // C x VP  v rows of the hd tile
  const float* scur;   // S before the chunk, split
  float* snext;        // S after it
  const float* zcur;   // z before the chunk
  float* znext;        // z after it
  float* pbuf;         // C x PP  P
  const float* etab;   // gamma^d, d = 0..C
  float* ng;           // num at row 0 of the chunk, column 0 of the hd tile
  float* dg;           // den at row 0 of the chunk
  long long nl, dl;    // their row strides
  int rows;            // rows of the chunk before L
  int wv;              // live columns of the hd tile
  float gC;            // gamma^C
  bool den_out;        // this block writes den (the first hd tile)
  bool n2;             // num's column pairs are 8-byte aligned
};

// One warp's share of one chunk: row tile RT (rows 16 RT ..), quarter nq of
// the hd tile (n-tiles 2 nq, 2 nq + 1). Its key tiles of q k^T are
// kt = nq + 4u, u < NK (those above the diagonal are computed and dropped,
// so that no mma is predicated); its units of the write are U0 .. U0 + NU -
// 1 (unit u: rows 16 (u / 2) .., n-tile 2 nq + u % 2); two warps of row tile
// 3 keep dz
template <typename TV, int RT>
__device__ __forceinline__ void chunk_work(const Chunk<TV>& ck, const int nq,
                                           const int lane) {
  using VT = VTraits<TV>;
  constexpr int NP = VT::PASSES;
  constexpr int NKT = 2 * RT + 2;     // key tiles at or below the diagonal
  constexpr int NK = (NKT + 3) / 4;   // ... this warp computes
  constexpr int U0 = RT == 0 ? 0 : RT == 1 ? 4 : 7;
  constexpr int NU = RT == 0 ? 4 : RT == 1 ? 3 : RT == 2 ? 1 : 0;
  constexpr int MT0 = U0 / 2, MT1 = (U0 + NU - 1) / 2;  // their m-tiles
  const int g = lane >> 2, t = lane & 3;
  const int ia = 16 * RT + g, ib = ia + 8;  // this lane's rows
  const float* etab = ck.etab;
  const float* qr = ck.qs + ia * PQ + t;
  float* pr = ck.pbuf + 16 * RT * PP;  // the row tile's P

  // 1. this warp's key tiles of P = (q k^T) * gamma^(i-j), into the row
  //    tile's P in shared memory
  {
    float s[NK][4];
#pragma unroll
    for (int u = 0; u < NK; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[u][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < MAX_M / 8; ++kk) {
      const Frag qf = fsplit(qr[8 * kk], qr[8 * PQ + 8 * kk],
                             qr[8 * kk + 4], qr[8 * PQ + 8 * kk + 4]);
      BFrag kb[NK];
#pragma unroll
      for (int u = 0; u < NK; ++u) {
        const float* kr = ck.ks + (8 * (nq + 4 * u) + g) * PQ + 8 * kk + t;
        kb[u] = bsplit(kr[0], kr[4]);
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int u = 0; u < NK; ++u) mma_pass(p, s[u], qf, kb[u]);
    }
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      // the accumulator holds rows ia, ib at keys j, j + 1
      const int j = 8 * (nq + 4 * u) + 2 * t;
      if (j < 8 * NKT) {
        const float p0 = j <= ia ? s[u][0] * etab[max(ia - j, 0)] : 0.0f;
        const float p1 = j + 1 <= ia ? s[u][1] * etab[max(ia - j - 1, 0)]
                                     : 0.0f;
        const float p2 = j <= ib ? s[u][2] * etab[max(ib - j, 0)] : 0.0f;
        const float p3 = j + 1 <= ib ? s[u][3] * etab[max(ib - j - 1, 0)]
                                     : 0.0f;
        *reinterpret_cast<float2*>(pr + g * PP + j) = make_float2(p0, p1);
        *reinterpret_cast<float2*>(pr + (g + 8) * PP + j) =
            make_float2(p2, p3);
      }
    }
  }
  // the four warps of the row tile exchange their parts of P
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + RT) : "memory");

  // 2. num = P v over the row tile's key tiles, P from shared memory as the
  //    A operand (keys j, j + 1 of a lane are its k-indices t, t + 4, and
  //    v's rows are read in that order); den = rowsum(P)
  float acc[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float dsum0 = 0.0f, dsum1 = 0.0f;  // rows ia, ib (this lane's part)
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    const int j = 8 * kt + 2 * t;
    const float2 pa = *reinterpret_cast<const float2*>(pr + g * PP + j);
    const float2 pb = *reinterpret_cast<const float2*>(pr + (g + 8) * PP + j);
    dsum0 += pa.x + pa.y;
    dsum1 += pb.x + pb.y;
    const Frag pf = fsplit(pa.x, pb.x, pa.y, pb.y);
    BFrag vb[2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
      vb[n] = VT::frag(ck.vs, j, 8 * (2 * nq + n) + g);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (NP == 3 || p != 1) {
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_pass(p, acc[n], pf, vb[n]);
      }
    }
  }

  // 3. the read of the state as it stood before this chunk:
  //    num += gamma^pos (q S), den += gamma^pos (q . z)
  {
    float qsa[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) qsa[n][e] = 0.0f;
    float qz0 = 0.0f, qz1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < MAX_M / 8; ++kk) {
      const float a0 = qr[8 * kk], a1 = qr[8 * PQ + 8 * kk],
                  a2 = qr[8 * kk + 4], a3 = qr[8 * PQ + 8 * kk + 4];
      const float z0 = ck.zcur[8 * kk + t], z1 = ck.zcur[8 * kk + t + 4];
      qz0 = fmaf(a0, z0, fmaf(a2, z1, qz0));
      qz1 = fmaf(a1, z0, fmaf(a3, z1, qz1));
      const Frag qf = fsplit(a0, a1, a2, a3);
      BFrag sb[2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        sb[n] = frag_load(ck.scur, kk * NT + 2 * nq + n, lane);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_pass(p, qsa[n], qf, sb[n]);
    }
    const float ea = etab[ia], eb = etab[ib];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      acc[n][0] = fmaf(ea, qsa[n][0], acc[n][0]);
      acc[n][1] = fmaf(ea, qsa[n][1], acc[n][1]);
      acc[n][2] = fmaf(eb, qsa[n][2], acc[n][2]);
      acc[n][3] = fmaf(eb, qsa[n][3], acc[n][3]);
    }
    dsum0 = fmaf(ea, qz0, dsum0);
    dsum1 = fmaf(eb, qz1, dsum1);
  }

  // 4. emit: each row's den summed over the four lanes that hold it
  dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 1);
  dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 2);
  dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 1);
  dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 2);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int i = x ? ib : ia;
    if (i < ck.rows) {
      if (ck.den_out && nq == 0 && t == 0) ck.dg[i * ck.dl] = x ? dsum1 : dsum0;
      float* nr = ck.ng + i * ck.nl;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 8 * (2 * nq + n) + 2 * t;
        const float o0 = acc[n][2 * x], o1 = acc[n][2 * x + 1];
        if (ck.n2 && col + 1 < ck.wv) {
          *reinterpret_cast<float2*>(nr + col) = make_float2(o0, o1);
        } else {
          if (col < ck.wv) nr[col] = o0;
          if (col + 1 < ck.wv) nr[col + 1] = o1;
        }
      }
    }
  }

  // 5. the write: dS = (k gamma^(C-pos))^T v into fresh accumulators for
  //    this warp's units, then S <- gC S + dS in fp32 from the exact split
  //    copy of the state before the chunk into the other copy, split again;
  //    no warp reads that copy before the next block barrier
  if constexpr (NU > 0) {
    float dacc[NU][4];
#pragma unroll
    for (int ui = 0; ui < NU; ++ui)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[ui][e] = 0.0f;
#pragma unroll 2
    for (int k8 = 0; k8 < C / 8; ++k8) {
      const int j = 8 * k8 + 2 * t;  // this lane's keys j, j + 1
      const float bj0 = etab[C - j], bj1 = etab[C - j - 1];
      Frag af[MT1 - MT0 + 1];  // one a m-tile, shared by its units
#pragma unroll
      for (int mt = MT0; mt <= MT1; ++mt) {
        // k^T by m-tile: rows 16 mt + g (+ 8), k-indices t, t + 4 = keys
        // j, j + 1
        const float* kr = ck.ks + j * PQ + 16 * mt + g;
        af[mt - MT0] = fsplit(kr[0] * bj0, kr[8] * bj0, kr[PQ] * bj1,
                              kr[PQ + 8] * bj1);
      }
      BFrag vb[2];  // the quarter's two n-tiles
#pragma unroll
      for (int n = 0; n < 2; ++n)
        vb[n] = VT::frag(ck.vs, j, 8 * (2 * nq + n) + g);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        if (NP == 3 || p != 1) {
#pragma unroll
          for (int ui = 0; ui < NU; ++ui)
            mma_pass(p, dacc[ui], af[((U0 + ui) >> 1) - MT0],
                     vb[(U0 + ui) & 1]);
        }
      }
    }
#pragma unroll
    for (int ui = 0; ui < NU; ++ui) {
      const int u = U0 + ui;
      // rows 16 (u / 2) + g (+ 8) are k-blocks 2 (u / 2) (+ 1), row g there
      const int blk = 2 * (u >> 1) * NT + 2 * nq + (u & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        frag_update(ck.snext, ck.scur, blk + (e >> 1) * NT, g,
                    2 * t + (e & 1), ck.gC, dacc[ui][e]);
    }
  }
  // ... and z <- gC z + (k gamma^(C-pos))^T 1 in fp32: one column of k a
  //     lane of two warps of row tile 3 (columns past m are 0)
  if constexpr (RT == 3) {
    if (nq < 2) {
      const int d = 32 * nq + lane;
      float zp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int j = 0; j < C; ++j)
        zp[j & 3] = fmaf(etab[C - j], ck.ks[j * PQ + d], zp[j & 3]);
      ck.znext[d] =
          fmaf(ck.gC, ck.zcur[d], (zp[0] + zp[1]) + (zp[2] + zp[3]));
    }
  }
}

// Requires m <= 64 and m % 4 == 0. fast_qk / fast_v: q and k / v may be
// staged 16 bytes at a time (the launcher checks pointers and strides)
template <typename TV>
__global__ void __launch_bounds__(THREADS, 1)
lin_attn_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const TV* __restrict__ v,
                   const float* __restrict__ log_gamma,
                   float* __restrict__ num, float* __restrict__ den,
                   const Strides st, const int L, const int m, const int hd,
                   const int fast_qk, const int fast_v) {
  using VT = VTraits<TV>;
  constexpr int VP = VT::PITCH;
  constexpr int VE = 16 / sizeof(TV);  // elements of v a 16-byte copy moves
  constexpr int VS = TD / VE;          // 16-byte segments of a v row
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = tile * TD;
  const int wv = min(TD, hd - c0);  // live columns of this tile

  const float* qg = q + b * st.qb + h * st.qh;
  const float* kg = k + b * st.kb + h * st.kh;
  const TV* vg = v + b * st.vb + h * st.vh + c0;
  float* ng = num + b * st.nb + h * st.nh + c0;
  float* dg = den + b * st.db + h * st.dh;
  const bool n2 = ((st.nb | st.nh | st.nl | (long long)c0) & 1) == 0 &&
                  (reinterpret_cast<uintptr_t>(num) & 7) == 0;

  // the state starts at 0; columns past m and past the hd tile of the
  // staged rows are never written and stay 0
  for (int e = tid; e < SM_FLOATS; e += THREADS) smem[e] = 0.0f;
  __syncthreads();
  float* etab = smem + SM_E;
  const float lg = log_gamma[h];
  for (int i = tid; i <= C; i += THREADS) etab[i] = expf(lg * (float)i);
  const float gC = expf(lg * (float)C);

  // chunk c's q, k and v rows into buffer c & 1, one cp.async group
  auto issue = [&](int c) {
    const int l0 = c * C;
    float* qd = smem + SM_Q + (c & 1) * C * PQ;
    float* kd = smem + SM_K + (c & 1) * C * PQ;
    TV* vd = reinterpret_cast<TV*>(smem + SM_V + (c & 1) * C * PV);
    if (fast_qk) {  // 16 segments of 4 floats a row, those before m
#pragma unroll
      for (int i = 0; i < C * 16 / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e >> 4, x = 4 * (e & 15);
        if (x < m) {
          const bool ok = l0 + r < L;
          const long long row = ok ? l0 + r : 0;
          cp16(qd + r * PQ + x, qg + row * st.ql + x, ok);
          cp16(kd + r * PQ + x, kg + row * st.kl + x, ok);
        }
      }
    } else {
      for (int e = tid; e < C * MAX_M; e += THREADS) {
        const int r = e / MAX_M, x = e % MAX_M;
        if (x < m) {
          const bool ok = l0 + r < L;
          const long long row = l0 + r;
          qd[r * PQ + x] = ok ? qg[row * st.ql + x] : 0.0f;
          kd[r * PQ + x] = ok ? kg[row * st.kl + x] : 0.0f;
        }
      }
    }
    if (fast_v) {
#pragma unroll
      for (int i = 0; i < C * VS / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e / VS, x = VE * (e % VS);
        if (x < wv) {
          const bool ok = l0 + r < L;
          const long long row = ok ? l0 + r : 0;
          cp16(vd + r * VP + x, vg + row * st.vl + x, ok);
        }
      }
    } else {
      for (int e = tid; e < C * TD; e += THREADS) {
        const int r = e / TD, x = e % TD;
        if (x < wv) {
          const bool ok = l0 + r < L;
          const long long row = l0 + r;
          vd[r * VP + x] = ok ? vg[row * st.vl + x] : VT::zero();
        }
      }
    }
    cp_commit();
  };

  // warp w: row tile rt = w / 4, quarter nq = w % 4 of the hd tile; each
  // SM sub-partition (warps w % 4) holds one warp of every row tile
  const int rt = warp >> 2;
  const int nq = warp & 3;
  const int nC = (L + C - 1) / C;
  issue(0);
  for (int c = 0; c < nC; ++c) {
    const int l0 = c * C;
    const Chunk<TV> ck{
        smem + SM_Q + (c & 1) * C * PQ, smem + SM_K + (c & 1) * C * PQ,
        reinterpret_cast<const TV*>(smem + SM_V + (c & 1) * C * PV),
        smem + SM_S + (c & 1) * SF, smem + SM_S + ((c + 1) & 1) * SF,
        smem + SM_Z + (c & 1) * MAX_M, smem + SM_Z + ((c + 1) & 1) * MAX_M,
        smem + SM_P, etab, ng + l0 * st.nl, dg + l0 * st.dl, st.nl, st.dl,
        min(C, L - l0), wv, gC, tile == 0, n2};
    cp_wait_all();
    // chunk c is staged, and the state after chunk c - 1 is written; every
    // read of the buffers chunk c + 1 will write is done
    __syncthreads();
    if (c + 1 < nC) issue(c + 1);  // in flight during this chunk
    switch (rt) {
      case 0: chunk_work<TV, 0>(ck, nq, lane); break;
      case 1: chunk_work<TV, 1>(ck, nq, lane); break;
      case 2: chunk_work<TV, 2>(ck, nq, lane); break;
      default: chunk_work<TV, 3>(ck, nq, lane); break;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TV>
int launch(const float* q, const float* k, const void* v, const float* lg,
           float* num, float* den, const Strides& st, int B, int H, int L,
           int m, int hd, cudaStream_t stream) {
  if (m > MAX_M || m % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * SM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      lin_attn_tc_kernel<TV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)err;
  }
  constexpr int VE = 16 / sizeof(TV);
  const int fast_qk = aligned16(q) && aligned16(k) &&
                      ((st.qb | st.qh | st.ql | st.kb | st.kh | st.kl) & 3)
                          == 0;
  const int fast_v = aligned16(v) && hd % VE == 0 && st.vb % VE == 0 &&
                     st.vh % VE == 0 && st.vl % VE == 0;
  dim3 grid((hd + TD - 1) / TD, H, B);
  lin_attn_tc_kernel<TV><<<grid, THREADS, smem, stream>>>(
      q, k, static_cast<const TV*>(v), lg, num, den, st, L, m, hd, fast_qk,
      fast_v);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success; cudaErrorInvalidValue
// for an m above 64 or not a multiple of 4). `v_bf16` selects a
// __nv_bfloat16 v (else float); `strides` points to 15 element strides:
// (batch, head, row) of q, k, v, num and den. Checks nothing else the
// Python wrapper checks (shapes, types, the device).
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
