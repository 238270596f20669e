// Flash attention forward for Hopper (sm_90a), built by kernel.py with nvcc
// into a shared library that exposes one plain C entry point.
//
// out[b, h, i] = sum_j softmax_j(q_i . k_j / sqrt(hd)) v_j over the keys j
// of query i (j <= i when causal; also i - j < W under a local window W,
// causal only), with the online-softmax statistics of the reference:
// running max m (from -1e30), running sum l and accumulator acc, all fp32,
// and l == 0 -> 1 before the division. A masked logit weighs exactly 0: the
// reference's -1e30 gives 0 wherever a row has seen a visible key, and a
// row whose keys in a tile are all masked (a window's edge tile) adds only
// what the next visible key's correction 2^(-1e30 - m) wipes out, so the
// kernels mask with -inf and add nothing there.
// q is (B, H, Lq, hd); k and v are (B, KV, Lk, hd), read at head h / (H /
// KV) (GQA without a copy of the cache; any G, powers of two or not); Lq ==
// Lk when causal, any Lk when not (cross-attention); any strides with a
// unit last stride,
// so the model's (B, L, H, hd) tensors are read in place. bf16 or fp32
// inputs, the output in q's type and layout. v's head dim vd may differ from
// q's and k's hd; the scale stays 1/sqrt(hd) and out is (B, H, L, vd). The
// (hd, vd) pairs instantiated: (16, 16), (32, 32), (64, 64), (128, 128),
// (192, 128) (MLA: nope 128 + rope 64 packed into one q/k head, v 128),
// (256, 256) (Gemma-7B) and (24, 16) (the smoke DeepSeek configs' MLA).
//
// Replaces the TPU kernel `flash_attention_pallas` in
// src/repro/kernels/flash_attention/kernel.py (body `_flash_kernel`).
//
// Bound on an H100, reckoned from the code (not measured) for the served
// prefill shape B = 4, H = 32, L = 4096, hd = 64, causal: q k^T and P v over
// the causal half are 4 * hd * L^2 / 2 * B * H = 2.7e11 operations: 0.278 ms
// at the 989 TFLOP/s of the bf16 tensor cores, 4.104 ms at the 67 TFLOP/s of
// fp32 outside them. The bytes (q, k, v, out: 4 * B * H * L * hd in bf16,
// less for GQA's k and v) take about 0.03 ms at 3.35 TB/s: bound by
// operations. The softmax adds 1.07e9 exps, ~0.26 ms on the special
// function units at 1,980 MHz.
//
// Two kernels. The Pallas grid is (B * H, q blocks), each step streaming
// the whole K/V of its head through VMEM; here one block owns one (b, h,
// tile of 64 query rows) in the grid (q tiles, H, B), the heaviest causal
// tiles scheduled first, and streams 64-key tiles of K and V; under
// `causal` the loop stops at the diagonal tile, and under a window W it
// starts at the tile that holds key q0 - W + 1, so beyond W every q tile
// visits the same number of key tiles. Only the diagonal tile, a window's
// edge tiles and a ragged last tile are masked (keys at or past Lk get
// weight 0, rows past Lq are not written).
//
// bf16 (`flash_wgmma_kernel`): the products on the tensor cores, through
// wgmma. One warpgroup of 128 threads owns the 64 rows. S = Q K^T is hd / 16
// m64n64k16 steps, Q and K both K-major in shared memory; S stays in fp32
// registers and goes through the online softmax in fp32 in the log2 domain: P
// = 2^(S * scale * log2(e) - m), one FFMA and one ex2.approx (~2 ulp) a logit;
// the row max, the correction 2^(m - m_new) and the row sum l of the fp32 P,
// all fp32; O is rescaled only when a row max of the warp moved. The
// accumulator layout of S is the A-fragment layout of P V, so P feeds O += P V
// from registers; V, MN-major in shared memory, is read through wgmma's
// transpose flag. P is split in two: P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// two products into the same fp32 O. One bf16 rounding of P puts each output
// 29-62 bf16 roundings from the fp32 result (a CPU emulation of both designs;
// 68.6 measured on the card at the served shape); hi + lo keeps it within one,
// the gate of chip_smoke.py, for 1.5x the tensor work of one product (~12% of
// a launch on an H100, measured). Tiles are slabs of 64 rows x 128 bytes (64
// columns; hd = 128 takes two slabs, hd < 64 leaves the rest of each row zero)
// in wgmma's 128-byte swizzle, copied by TMA: one thread issues the boxes of Q
// and of each K/V tile through 4-D tensor maps over the strided tensors
// (encoded on the host per launch), elements past L or hd arrive as zeros, and
// each tile completes on an mbarrier of a ring of two K/V stages: tile kt + 1
// is in flight while tile kt computes. 41 KiB of shared memory a block at hd
// <= 64, so several blocks share an SM and one's softmax overlaps another's
// products. TMA needs 16-byte-aligned rows: the wrapper checks.
//
// fp32 (`flash_kernel`): fp32 FMA on the CUDA cores, as in the reference
// kernel (TF32 would miss the 2e-5 bound). 256 threads; the 64 x 64 logit
// tile is a 16 x 16 thread grid, 4 x 4 logits a thread (rows ty + 16 i,
// columns tx + 16 j, so the 16-byte row loads of q and k hit distinct
// banks); the row max and row sum are shuffles over the 16 lanes that share
// a row; P goes through shared memory for P v, where a thread owns 4 rows x
// vd/16 columns of acc in registers. One block uses 3 * 64 * (hd + 4) +
// 64 * 68 floats of shared memory (68 KiB at hd = 64), so three blocks
// share an SM; with vd beside hd, 2 * 64 * (hd + 4) + 64 * (vd + 4) + 64 * 68
// floats: 148 KiB at (192, 128) and 212 KiB at (256, 256), one block an SM.
//
// The wide pairs in bf16: q and k take hd / 64 slabs (three at 192), v and O
// vd / 64 (two at 128, four at 256), so a block holds 105 KiB of shared
// memory at (192, 128) and 161 KiB at (256, 256), one block an SM; at vd =
// 256 the O accumulator is 128 fp32 registers a thread beside S's 32 and
// P's 32 fragments. A simple port of the same loop: its times at these
// shapes are in PERF.md.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up through the runtime, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>  // INFINITY
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows of a block
constexpr int BK = 64;   // keys of a K/V tile
constexpr int THREADS = 256;
constexpr int PLD = BK + 4;  // padded row of P in shared memory
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }

// the key tiles [kt0, nk) that q tile qt visits: under `causal` up to the
// diagonal tile (BQ == BK), under a window W (causal only) from the tile
// that holds key q0 - W + 1, the first that row q0 sees
__device__ __forceinline__ void key_tiles(int qt, int Lk, int causal,
                                          int window, int& kt0, int& nk) {
  const int nk_all = (Lk + BK - 1) / BK;
  nk = causal ? min(qt + 1, nk_all) : nk_all;
  kt0 = causal && window > 0 ? max(0, qt * BQ - window + 1) / BK : 0;
}

// whether query row `row` may not see key `key`
__device__ __forceinline__ bool masked(int row, int key, int Lk, int causal,
                                       int window) {
  return key >= Lk || (causal && key > row) ||
         (window > 0 && row - key >= window);
}

// element strides of the four operands: (batch, head, row); the last
// dimension is contiguous
struct Strides {
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol;
};

template <typename T, int HD, int VD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Strides st, int G,
             int Lq, int Lk, float scale, int causal, int window) {
  constexpr int LD = HD + 4;    // padded row of the q/k tiles
  constexpr int LDV = VD + 4;   // padded row of the v tile
  constexpr int CPT = VD / 16;  // columns of acc a thread owns
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x LD, q * scale
  float* ks = qs + BQ * LD;                      // BK x LD
  float* vs = ks + BK * LD;                      // BK x LDV
  float* ps = vs + BK * LDV;                     // BQ x PLD

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (Lq + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q0 = qt * BQ;
  const T* qg = q + b * st.qb + h * st.qh;
  const T* kg = k + b * st.kb + kvh * st.kh;
  const T* vg = v + b * st.vb + kvh * st.vh;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, row = q0 + r;
    qs[r * LD + d] = row < Lq ? to_float(qg[row * st.ql + d]) * scale : 0.f;
  }
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  int kt0, nk;
  key_tiles(qt, Lk, causal, window, kt0, nk);

  for (int kt = kt0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P v is done with vs and ps
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD, row = k0 + r;
      ks[r * LD + d] = row < Lk ? to_float(kg[row * st.kl + d]) : 0.f;
    }
    for (int e = tid; e < BK * VD; e += THREADS) {
      const int r = e / VD, d = e % VD, row = k0 + r;
      vs[r * LDV + d] = row < Lk ? to_float(vg[row * st.vl + d]) : 0.f;
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
        if (masked(qp, k0 + tx + 16 * j, Lk, causal, window))
          s[i][j] = -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mnew = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - mnew);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mnew);  // -inf -> 0
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
        const float* vrow = vs + (kk + u) * LDV + tx * CPT;
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
    if (row >= Lq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* orow = out + b * st.ob + h * st.oh + row * st.ol + tx * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store_as(orow + c, acc[i][c] / li);
  }
}

template <typename T, int HD, int VD>
int launch(const T* q, const T* k, const T* v, T* out, const Strides& st,
           int B, int H, int G, int Lq, int Lk, float scale, int causal,
           int window, cudaStream_t stream) {
  const int smem =
      (2 * BQ * (HD + 4) + BK * (VD + 4) + BQ * PLD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD, VD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD, VD><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, st, G, Lq, Lk, scale, causal, window);
  return (int)cudaGetLastError();
}

// ---- bf16: wgmma on the tensor cores -------------------------------------

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int STAGES = 2;        // the K/V ring
constexpr int ROW_BYTES = 128;   // a slab row: 64 bf16, the 128-byte swizzle
constexpr int SLAB_BYTES = 64 * ROW_BYTES;  // 64 rows of a slab
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (each >> 4), layout type 1 (128-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this thread arrives on the barrier and adds `bytes` to the transfers the
// phase waits for
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// adds `bytes` to the transfers the barrier's phase waits for, no arrival
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// one TMA copy of a 64 x 64 box at (column c0, row c1, head c2, batch c3)
// of `map` into the slab at dst; its bytes complete on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, ~2 ulp
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a copy that never lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads and writes across the
// asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define D32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B for a 64 x 16 A and a 16 x 64 B, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for A (64 x 16) in registers and B (16 x 64) MN-major in shared
// memory (the transpose flag set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// slabs of a head dim: one 64-column slab per 64 columns, at least one
__host__ __device__ constexpr int slabs(int d) {
  return d < 64 ? 1 : d / 64;
}

// the K and V slabs of stage s: Q's QS slabs first, then the stages' K (QS
// slabs), V (VS slabs) pairs
template <int QS, int VS>
__device__ __forceinline__ uint32_t k_slot(uint32_t qs, int s) {
  return qs + SLAB_BYTES * (QS + s * (QS + VS));
}
template <int QS, int VS>
__device__ __forceinline__ uint32_t v_slot(uint32_t qs, int s) {
  return k_slot<QS, VS>(qs, s) + QS * SLAB_BYTES;
}

// one thread's copies of K/V tile t, the i-th tile of the block's loop,
// into stage i % STAGES, and the one arrival of that stage's barrier phase
template <int QS, int VS>
__device__ __forceinline__ void load_kv(int i, int t, uint32_t qs,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint64_t* full,
                                        int kvh, int b) {
  const int s = i % STAGES;
  const uint32_t bar = smem_u32(&full[s]);
  mbar_arrive_expect(bar, (QS + VS) * SLAB_BYTES);
  for (int sl = 0; sl < QS; ++sl)
    tma_load(k_slot<QS, VS>(qs, s) + sl * SLAB_BYTES, tk, bar, 64 * sl,
             t * BK, kvh, b);
  for (int sl = 0; sl < VS; ++sl)
    tma_load(v_slot<QS, VS>(qs, s) + sl * SLAB_BYTES, tv, bar, 64 * sl,
             t * BK, kvh, b);
}

// One warpgroup per (b, h, 64 query rows). Thread (warp w, lane) holds, of
// every m64n64 accumulator, element 4 j + e at row 16 w + lane / 4 + 8 (e / 2)
// and column 8 j + 2 (lane % 4) + e % 2. The maps view q as (hd, L, H, B),
// k as (hd, L, KV, B) and v as (vd, L, KV, B) in elements, boxes of 64 x 64
// x 1 x 1.
template <int HD, int VD>
__global__ void __launch_bounds__(WG_THREADS)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, Strides st, int G,
                   int Lq, int Lk, float scale_log2, int causal, int window) {
  constexpr int QS = slabs(HD), VS = slabs(VD);
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES];  // tile of stage s has landed

  // tiles start on 1024-byte boundaries, as the swizzle requires
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (Lq + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q0 = qt * BQ;
  int kt0, nk;
  key_tiles(qt, Lk, causal, window, kt0, nk);
  const int n = nk - kt0;  // the tiles of this block's loop

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Q lands with the first K/V tile on stage 0's barrier (whose one
    // arrival comes with that tile); the ring holds the first STAGES - 1
    // tiles in flight. Boxes reach past L (and past hd < 64): TMA fills
    // those elements with zeros.
    mbar_expect(smem_u32(&full[0]), QS * SLAB_BYTES);
    for (int sl = 0; sl < QS; ++sl)
      tma_load(qs + sl * SLAB_BYTES, &tq, smem_u32(&full[0]), 64 * sl, q0, h,
               b);
    for (int i = 0; i < STAGES - 1 && i < n; ++i)
      load_kv<QS, VS>(i, kt0 + i, qs, &tk, &tv, full, kvh, b);
  }
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 16 * warp + g;  // rows row0 and row0 + 8
  float o[VS][32];
#pragma unroll
  for (int sl = 0; sl < VS; ++sl)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[sl][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n; ++it) {
    const int kt = kt0 + it, stage = it % STAGES;
    if (it + STAGES - 1 < n) {  // later tiles fly while this one computes
      if (it > 0) __syncthreads();  // the slot's last reader is done
      if (tid == 0)
        load_kv<QS, VS>(it + STAGES - 1, kt + STAGES - 1, qs, &tk, &tv, full,
                        kvh, b);
    }
    mbar_wait(smem_u32(&full[stage]), (it / STAGES) & 1);

    // S = Q K^T: hd / 16 steps of k16 along each 128-byte row (rounded up:
    // TMA fills the columns past hd with zeros)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < (HD + 15) / 16; ++ks) {
      const uint32_t off = (ks / 4) * SLAB_BYTES + (ks % 4) * 32;
      wgmma_ss(s, descriptor(qs + off, 16, 1024),
               descriptor(k_slot<QS, VS>(qs, stage) + off, 16, 1024),
               ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax in the log2 domain; only the diagonal tile, a
    // window's edge tiles and a ragged last one are masked (the logits
    // themselves, before scaling, to -inf: 2^-inf = 0)
    const int k0 = kt * BK;
    if ((causal && kt == qt) || k0 + BK > Lk ||
        (window > 0 && q0 + BQ - 1 - k0 >= window)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (masked(row0 + 8 * (e >> 1), k0 + 8 * j + 2 * t4 + (e & 1), Lk,
                     causal, window))
            s[4 * j + e] = -INFINITY;
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], mneg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // scale > 0, so the max of the scaled logits is the scaled max
      const float mnew = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = ex2(m[r] - mnew);
      m[r] = mnew;
      mneg[r] = -mnew;
      l[r] *= corr[r];  // this thread's part of the row sum
    }
    // P = 2^(S scale - m) in fp32, summed into l, split into bf16 hi + lo
    // A fragments: k16 chunk c, register 4 c + 2 (j % 2) + (row half)
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = ex2(fmaf(s[4 * j + 2 * r], scale_log2, mneg[r]));
        const float p1 = ex2(fmaf(s[4 * j + 2 * r + 1], scale_log2, mneg[r]));
        l[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi));
        const int reg = 4 * (j / 2) + 2 * (j % 2) + r;
        ph[reg] = pack_bf16(hi);
        pl[reg] = pack_bf16(lo);
      }
    // the O rescale, unless no row max of this warp moved
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int sl = 0; sl < VS; ++sl)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[sl][i] *= corr[(i >> 1) & 1];
    }

    // O += P_hi V + P_lo V: 4 k16 chunks of keys (16 rows of V, 2048 bytes)
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int sl = 0; sl < VS; ++sl) {
        const uint64_t bv =
            descriptor(v_slot<QS, VS>(qs, stage) + sl * SLAB_BYTES + c * 2048,
                       SLAB_BYTES, 1024);
        wgmma_rs(o[sl], ph[4 * c], ph[4 * c + 1], ph[4 * c + 2],
                 ph[4 * c + 3], bv);
        wgmma_rs(o[sl], pl[4 * c], pl[4 * c + 1], pl[4 * c + 2],
                 pl[4 * c + 3], bv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int sl = 0; sl < VS; ++sl) fence_regs(o[sl]);
    fence_regs(ph);
    fence_regs(pl);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 1.f : l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    __nv_bfloat16* orow = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int sl = 0; sl < VS; ++sl)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * sl + 8 * j + 2 * t4;
        if (col >= VD) continue;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[sl][4 * j + 2 * r] / l[r],
                                  o[sl][4 * j + 2 * r + 1] / l[r]);
      }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime at first use
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a map over a bf16 tensor read as (hd, L, heads, B) (L = Lq for q, Lk for
// k and v) with element strides
// (row, head, batch) and a unit one along hd: 64 x 64 boxes in the
// 128-byte swizzle of the slabs, elements past the tensor read as zero
bool tensor_map(CUtensorMap* map, const void* base, int hd, int L, int heads,
                int B, long long s_row, long long s_head, long long s_batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)L,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2,
                                 (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int VD>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* out,
                 const Strides& st, int B, int H, int G, int Lq, int Lk,
                 float scale, int causal, int window, cudaStream_t stream) {
  constexpr int QS = slabs(HD), VS = slabs(VD);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, HD, Lq, H, B, st.ql, st.qh, st.qb) ||
      !tensor_map(&tk, k, HD, Lk, H / G, B, st.kl, st.kh, st.kb) ||
      !tensor_map(&tv, v, VD, Lk, H / G, B, st.vl, st.vh, st.vb))
    return (int)cudaErrorInvalidValue;
  // Q and STAGES K/V pairs, and room to align them to 1024 bytes
  const int smem = (QS + STAGES * (QS + VS)) * SLAB_BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, VD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_wgmma_kernel<HD, VD><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, out, st, G, Lq, Lk, scale * LOG2E, causal, window);
  return (int)cudaGetLastError();
}

int dispatch_bf16(int hd, int vd, const void* q, const void* k, const void* v,
                  void* out, const Strides& st, int B, int H, int G, int Lq,
                  int Lk, float scale, int causal, int window,
                  cudaStream_t s) {
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  bf* ot = static_cast<bf*>(out);
  switch (hd * 1000 + vd) {
    case 16016: return launch_wgmma<16, 16>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 24016: return launch_wgmma<24, 16>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 32032: return launch_wgmma<32, 32>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 64064: return launch_wgmma<64, 64>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 128128: return launch_wgmma<128, 128>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 192128: return launch_wgmma<192, 128>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 256256: return launch_wgmma<256, 256>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_f32(int hd, int vd, const void* q, const void* k, const void* v,
                 void* out, const Strides& st, int B, int H, int G, int Lq,
                 int Lk, float scale, int causal, int window,
                 cudaStream_t s) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(out);
  switch (hd * 1000 + vd) {
    case 16016: return launch<float, 16, 16>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 24016: return launch<float, 24, 16>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 32032: return launch<float, 32, 32>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 64064: return launch<float, 64, 64>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 128128: return launch<float, 128, 128>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 192128: return launch<float, 192, 128>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    case 256256: return launch<float, 256, 256>(qt, kt, vt, ot, st, B, H, G, Lq, Lk, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success; an (hd, vd) pair not
// instantiated is cudaErrorInvalidValue). `bf16` selects __nv_bfloat16
// operands and the wgmma kernel (else float and the fp32 kernel); `strides`
// points to 12 element strides: (batch, head, row) of q, k, v and out.
// `window` > 0 is a local window (causal only); Lq and Lk are the query
// and key lengths (equal when causal). Checks nothing the Python wrapper
// checks (shapes, types, the device, the (hd, vd) pair, G = H / KV, the
// window and lengths, the bf16 path's 16-byte-aligned rows).
extern "C" int flash_attention_launch(int bf16, int hd, int vd, const void* q,
                                      const void* k, const void* v, void* out,
                                      const long long* strides, int B, int H,
                                      int G, int Lq, int Lk, float scale,
                                      int causal, int window, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bf16(hd, vd, q, k, v, out, st, B, H, G, Lq, Lk,
                              scale, causal, window, s)
              : dispatch_f32(hd, vd, q, k, v, out, st, B, H, G, Lq, Lk, scale,
                             causal, window, s);
}
