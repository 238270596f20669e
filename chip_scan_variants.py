#!/usr/bin/env python3
"""Variants of the selective scan kernel (B6) on a CUDA card: what each
costs and how close each comes to a float64 scan.

Run from the root of a checkout, on a machine with one CUDA card (Hopper,
sm_90a) and nvcc:

    python3 chip_scan_variants.py [--out results.json]

It builds, in parallel, variants of `kernels/selective_scan/selective_scan.cu`
made by editing its text: the exp of the decay (the committed 2^(dt a2 + 1)
/ 2, expf, or 2^(dt a2) unshifted), the order of the fma of h's update (the
committed fma(du, B, dA h), or fma(dA, h, du B), which is the order the
one-thread-a-channel kernel of the first port compiled to), and the layout
(the committed one thread a channel, or N split over N / 4 lanes a channel
with y summed by a shuffle reduce-scatter, LANE_SPLIT below). For each it
reports:

  * its time per launch at the served Falcon-Mamba-7B prefill shape
    (Bt = 4, L = 4096, din = 8192, N = 16; f32 and bf16 inputs), as
    chip_smoke.py times it;
  * its largest error at the 24 shapes of the card test
    tests/test_torch_cuda.py::test_scan_kernel_ragged_shapes, against the
    plain chunked scan and the float32 sequential oracle (the test's
    measure, bound 2e-5) and against a float64 sequential scan;
  * chip_smoke.py's phase 4d gate reading (the full-width Falcon-Mamba-7B
    served in float32, the kernel against the plain chunked scan: prefill
    logits <= 1e-4, cache <= 1e-5), the plain run made once;
  * y and h_final against a float64 scan of the model's own scan inputs at
    layers 0, 31 and 63 (captured from that plain run), for the plain
    chunked scan and each variant.

Nothing here is a gate: it measures, and exits 0 unless a build or a
launch fails. It imports neither jax nor the reference package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# N split over lanes: a group of N / 4 neighbouring lanes owns one (b, d),
# each lane 4 states; u, dt, B and C staged in shared memory; y summed over
# the group by a shuffle reduce-scatter once per 16-step chunk
LANE_SPLIT = r"""template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ D,
            const float* __restrict__ h0, float* __restrict__ y,
            float* __restrict__ h_final, Strides st, int L, int din) {
  constexpr int LPC = N / NPL;             // lanes a channel
  constexpr int CPB = THREADS / LPC;       // channels a block
  constexpr int PER = (TL * N + THREADS - 1) / THREADS;  // B/C loads a thread
  constexpr int SPL = TL / LPC;  // steps of a chunk a lane stores; also the
                                 // u (and dt) loads a thread, TL CPB / THREADS
  __shared__ __align__(16) float bs[2][TL][N];
  __shared__ __align__(16) float cs[2][TL][N];
  __shared__ float us[2][TL][CPB];
  __shared__ float ds[2][TL][CPB];

  const int tid = threadIdx.x;
  const int q = tid % LPC;                 // this lane's states 4q .. 4q + 3
  const int ch = tid / LPC;                // this lane's channel in the block
  const int d = blockIdx.x * CPB + ch;
  const int b = blockIdx.y;
  const bool live = d < din;
  const int dd = live ? d : din - 1;  // a valid channel for the loads

  float a[NPL], h[NPL];
  {
    const float4 a4 = *reinterpret_cast<const float4*>(A + (long long)dd * N
                                                       + NPL * q);
    a[0] = a4.x * LOG2E; a[1] = a4.y * LOG2E;
    a[2] = a4.z * LOG2E; a[3] = a4.w * LOG2E;
    const float4 h4 = h0 != nullptr
        ? *reinterpret_cast<const float4*>(h0 + ((long long)b * din + dd) * N
                                           + NPL * q)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    h[0] = h4.x; h[1] = h4.y; h[2] = h4.z; h[3] = h4.w;
  }
  const float Dd = D[dd];
  const int d0 = blockIdx.x * CPB;  // the block's first channel
  const T* ug = u + b * st.ub + d0;
  const T* dg = dt + b * st.db + d0;
  const T* bg = Bm + b * st.bb;
  const T* cg = Cm + b * st.cb;
  float* yg = y + (long long)b * L * din + d;

  // chunk 0 into buffer 0
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int e = tid + k * THREADS;
    const int j = e / CPB, c = e % CPB;
    const bool ok = j < L && d0 + c < din;
    us[0][j][c] = ok ? to_float(ug[j * st.ul + c]) : 0.f;
    ds[0][j][c] = ok ? to_float(dg[j * st.dl + c]) : 0.f;
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
    // the next chunk's loads, in flight while this chunk computes. They
    // stay in their own type until they are stored, so that no upcast waits
    // on a load that is still in flight.
    const int t1 = t0 + TL;
    T un[SPL], dn[SPL], bn[PER], cn[PER];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int e = tid + k * THREADS;
      const int j = e / CPB, c = e % CPB;
      const bool ok = t1 + j < L && d0 + c < din;
      un[k] = ok ? ug[(long long)(t1 + j) * st.ul + c] : zero<T>();
      dn[k] = ok ? dg[(long long)(t1 + j) * st.dl + c] : zero<T>();
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * THREADS;
      const int j = e / N, n = e % N;
      const bool ok = e < TL * N && t1 + j < L;
      bn[k] = ok ? bg[(long long)(t1 + j) * st.bl + n] : zero<T>();
      cn[k] = ok ? cg[(long long)(t1 + j) * st.cl + n] : zero<T>();
    }

    float part[TL];  // this lane's 4-state part of y_t, t = t0 + j
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      const float dtv = ds[buf][j][ch], uv = us[buf][j][ch];
      const float du = dtv * uv;
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[buf][j][NPL * q]);
      const float4 c4 = *reinterpret_cast<const float4*>(&cs[buf][j][NPL * q]);
      h[0] = fmaf(du, b4.x, decay(dtv, a[0]) * h[0]);
      h[1] = fmaf(du, b4.y, decay(dtv, a[1]) * h[1]);
      h[2] = fmaf(du, b4.z, decay(dtv, a[2]) * h[2]);
      h[3] = fmaf(du, b4.w, decay(dtv, a[3]) * h[3]);
      // D u rides in the part of the group's first lane
      part[j] = h[0] * c4.x + h[1] * c4.y + h[2] * c4.z + h[3] * c4.w
                + (q == 0 ? uv * Dd : 0.f);
    }
    // reduce-scatter over the lanes of the group: lane q ends with the
    // whole y of steps q * SPL .. q * SPL + SPL - 1
    if (LPC == 4) {
#pragma unroll
      for (int i = 0; i < TL / 2; ++i) {
        const bool upper = q & 2;
        const float send = upper ? part[i] : part[i + TL / 2];
        const float keep = upper ? part[i + TL / 2] : part[i];
        part[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
      }
    }
    if (LPC >= 2) {
      constexpr int HALF = SPL;  // values left after this step
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const bool upper = q & 1;
        const float send = upper ? part[i] : part[i + HALF];
        const float keep = upper ? part[i + HALF] : part[i];
        part[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
    }
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int j = q * SPL + i;
      if (live && t0 + j < L)
        yg[(long long)(t0 + j) * din] = part[i];
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
    for (int k = 0; k < SPL; ++k) {
      const int e = tid + k * THREADS;
      us[buf ^ 1][e / CPB][e % CPB] = to_float(un[k]);
      ds[buf ^ 1][e / CPB][e % CPB] = to_float(dn[k]);
    }
    __syncthreads();  // the next buffer is written; this one is free
  }

  if (live) {
    *reinterpret_cast<float4*>(h_final + ((long long)b * din + d) * N
                               + NPL * q) = make_float4(h[0], h[1], h[2], h[3]);
  }
}

template <typename T, int N>
int launch(const void* u, const void* dt, const float* A, const void* B,
           const void* C, const float* D, const float* h0, float* y,
           float* h_final, const Strides& st, int Bt, int L, int din,
           cudaStream_t stream) {
  constexpr int CPB = THREADS / (N / NPL);
  dim3 grid((din + CPB - 1) / CPB, Bt);
  scan_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D, h0, y, h_final,
      st, L, din);
  return (int)cudaGetLastError();
}
"""


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise AssertionError(f"variant edit does not apply: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """name -> source text."""
    order_f2 = "h[n] = fmaf(du, bv[i], dA * h[n]);"
    order_f1 = "h[n] = fmaf(dA, h[n], du * bv[i]);"
    line = next(ln for ln in src.splitlines() if order_f2 in ln)
    shifted = "return 0.5f * ex2(fmaf(dt, a2, 1.0f));"

    def exp(s, kind):
        if kind == "expf":
            return _sub(s, shifted, "return expf(dt * a2);").replace(
                " * LOG2E", "")
        if kind == "ex2":
            return _sub(s, shifted, "return ex2(dt * a2);")
        return s

    f1 = _sub(src, line, line.split(order_f2)[0] + order_f1)
    start = src.index("template <typename T, int N>\n__global__")
    end = src.index("template <typename T>\nint launch_n")
    split = _sub(src[:start] + LANE_SPLIT + "\n" + src[end:],
                 "constexpr int TL = 16;",
                 "constexpr int TL = 16;\nconstexpr int NPL = 4;")
    out = {}
    for kind in ("shifted", "expf", "ex2"):
        out[f"{kind}"] = exp(src, kind)
        out[f"{kind}, fma(dA, h, du B)"] = exp(f1, kind)
        out[f"{kind}, lane split"] = exp(split, kind)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.selective_scan import kernel as sk
    from repro_torch.kernels.selective_scan import ops as sops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.models import api

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    def log(msg):
        print(f"[{time.perf_counter() - t_start:6.1f} s] {msg}", flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"card: {card.strip()}")
    work = ROOT / "build" / "scan_variants"
    work.mkdir(parents=True, exist_ok=True)
    srcs = variants(sk.SOURCE.read_text())

    def build(item):
        i, (name, text) = item
        path = work / f"scan_variant_{i}.cu"
        path.write_text(text)
        return name, _nvcc.build(path, f"scan_variant_{i}")[0]

    with ThreadPoolExecutor(len(srcs)) as ex:
        built = list(ex.map(build, enumerate(srcs.items())))
    libs = {}
    for name, path in built:
        lib = ctypes.CDLL(str(path))
        lib.selective_scan_launch.argtypes = sk._ARGTYPES
        lib.selective_scan_launch.restype = ctypes.c_int
        libs[name] = lib
    log(f"built {len(libs)} variants")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    res = {name: {} for name in libs}

    def use(name):
        sk._lib = libs[name]

    @torch.no_grad()
    def scan64(u, dt, A, B, C, D, h0=None):
        """The sequential oracle's recurrence in float64 throughout."""
        u, dt, B, C, A, D = (t.double() for t in (u, dt, B, C, A, D))
        Bt, L, din = u.shape
        h = (torch.zeros((Bt, din, A.shape[1]), dtype=torch.float64,
                         device=u.device) if h0 is None else h0.double())
        y = torch.empty((Bt, L, din), dtype=torch.float64, device=u.device)
        for t in range(L):
            h = (torch.exp(dt[:, t, :, None] * A[None]) * h
                 + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :])
            y[:, t] = (h * C[:, t, None, :]).sum(-1) + u[:, t] * D[None]
        return y, h

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / b.double().abs().max())

    def absd(a, b):
        return float((a.double() - b.double()).abs().max())

    # 1. time per launch at the served shape
    rng = np.random.default_rng(19)
    served = {str(dt).split(".")[1]: cs._scan_inputs(
        rng, cs.SSM["served_shape"], dt, dev)
        for dt in (torch.float32, torch.bfloat16)}
    for name in libs:
        use(name)
        for dt, a in served.items():
            res[name][f"ms_{dt}"] = min(
                cs.device_ms(lambda: sops.scan(*a), cs.TOPO["reps"])
                for _ in range(2))
        log(f"{name}: {res[name]['ms_float32']:.4f} ms (f32), "
            f"{res[name]['ms_bfloat16']:.4f} ms (bf16) a launch")
    del served
    torch.cuda.empty_cache()

    # 2. the card test's shapes
    for name in libs:
        res[name]["test_measure"] = res[name]["test_vs_f64"] = 0.0
    for N in (4, 8, 16):
        for Bt, L, din in ((2, 1001, 100), (1, 77, 333)):
            for dtype in ("float32", "bfloat16"):
                for with_h0 in (False, True):
                    rng = np.random.default_rng(L + din + N)
                    dt_ = getattr(torch, dtype)

                    def t(x, d=torch.float32):
                        return torch.tensor(x, dtype=torch.float32,
                                            device=dev).to(d)

                    a = (t(rng.normal(size=(Bt, L, din)), dt_),
                         t(np.abs(rng.normal(size=(Bt, L, din))) * 0.1, dt_),
                         t(-np.abs(rng.normal(size=(din, N))) - 0.1),
                         t(rng.normal(size=(Bt, L, N)), dt_),
                         t(rng.normal(size=(Bt, L, N)), dt_),
                         t(rng.normal(size=(din,))))
                    h0 = (torch.tensor(rng.normal(size=(Bt, din, N)),
                                       dtype=torch.float32, device=dev)
                          if with_h0 else None)
                    wants = (sops.scan(*a, h0=h0, use_kernel=False),
                             selective_scan_ref(*a, h0=h0))
                    w64 = scan64(*a, h0=h0)
                    for name in libs:
                        use(name)
                        y, h = sops.scan(*a, h0=h0)
                        r = res[name]
                        r["test_measure"] = max(
                            [r["test_measure"]] + [max(absd(y, wy), absd(
                                h, wh)) for wy, wh in wants])
                        r["test_vs_f64"] = max(r["test_vs_f64"],
                                               absd(y, w64[0]),
                                               absd(h, w64[1]))
    for name in libs:
        log(f"{name}: card-test shapes, worst abs err "
            f"{res[name]['test_measure']:.3e} vs plain and the float32 "
            f"oracle (bound 2e-5), {res[name]['test_vs_f64']:.3e} vs "
            "float64")

    # 3. the phase 4d gate, and the model's own scan inputs
    cfg, pcfg = cs._ssm_cfg("cuda", "float32"), cs._ssm_cfg("chunked",
                                                            "float32")
    model = api.init_params(cfg, cs.TOPO["seed"], device=dev)
    toks, lengths = cs._prompts(cfg)
    kept, calls, plain_scan = {}, [0], sops.selective_scan

    def capture(u, dt, A, Bm, Cm, D, *a, **k):
        if calls[0] in (0, 31, 63):
            kept[calls[0]] = tuple(x.detach().clone()
                                   for x in (u, dt, A, Bm, Cm, D))
        calls[0] += 1
        return plain_scan(u, dt, A, Bm, Cm, D, *a, **k)

    n = cs.TOPO["gate_steps"]
    sops.selective_scan = capture
    try:
        want = cs._serve(pcfg, model, toks, lengths, n, dev, sops)
    finally:
        sops.selective_scan = plain_scan
    for name in libs:
        use(name)
        got = cs._serve(cfg, model, toks, lengths, n, dev, sops,
                        feed=want[3])
        r = res[name]
        r["gate_logits"] = cs.rel_err(got[0], want[0])
        r["gate_cache"] = max(cs.rel_err(got[1]["blocks0"][k],
                                         want[1]["blocks0"][k])
                              for k in got[1]["blocks0"])
        r["gate_decode"] = max(cs.rel_err(a, b)
                               for a, b in zip(got[2][:n], want[2]))
        log(f"{name}: phase 4d gate logits {r['gate_logits']:.4e} (<= "
            f"{cs.LOGIT_TOL}), cache {r['gate_cache']:.4e} (<= "
            f"{cs.CACHE_TOL}), decode {r['gate_decode']:.4e}")
        del got
    del want, model
    torch.cuda.empty_cache()
    plain = {}
    for layer, a in sorted(kept.items()):
        y64, h64 = scan64(*a)
        py, ph = plain_scan(*a)
        plain[layer] = (rel(py, y64), rel(ph, h64))
        line = [f"plain y {plain[layer][0]:.3e} h {plain[layer][1]:.3e}"]
        for name in libs:
            use(name)
            y, h = sops.scan(*a)
            res[name][f"layer{layer}_vs_f64"] = (rel(y, y64), rel(h, h64))
            line.append(f"{name} y {rel(y, y64):.3e} h {rel(h, h64):.3e}")
        log(f"layer {layer} scan inputs {tuple(a[0].shape)}, against "
            f"float64 (relative to max): " + " | ".join(line))
        del y64, h64, py, ph
        torch.cuda.empty_cache()
    sk._lib = None
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": card.strip(), "variants": res,
             "plain_layers_vs_f64": plain}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
