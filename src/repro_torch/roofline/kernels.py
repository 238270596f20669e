"""The work of each kernel of the port, as a function of its shapes.

Each `*_work` gives what one call of a kernel must do: (bytes, operations)
(the scan also its exps), the bytes with each input read once and each
output written once, the operations those of the function it computes (a
multiply-add counted as two). They are the formulas behind the bound
column of `PERF.md` §6, which `chip_smoke.py` prints, and the work that
`roofline.count` records for a kernel wrapper's call, whichever route runs
it (the CUDA kernel, or its plain version on CPU or fake tensors).

Pure Python: importing it costs nothing.
"""
from __future__ import annotations

# peak rates of one H100 SXM (NVIDIA H100 Tensor Core GPU data sheet):
# HBM3 bytes/s, and flop/s outside the tensor cores (fp32) and in them
# (dense, no sparsity); the bound of a call is the larger of its bytes and
# its operations over these
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense, in the tensor cores
TF32_FLOPS_PER_S = 495e12  # dense, in the tensor cores; 3xTF32 takes three
# exp2 results a clock on one SM's special function units (4 quadrants of
# 4, sm_90: CUDA C++ Programming Guide, arithmetic instruction throughput)
SFU_PER_CLOCK_PER_SM = 16


def _f_ops(mode: str, k: int) -> int:
    """fp32 operations of one f(x + y): the add, then the family's ops
    (an exp or a division counted as one)."""
    return 1 + {"poly": 2 * k, "exp": 3, "expq": 6, "rational": 4}[mode]


def fdist_work(B, a, b, d, mode, k, v_bytes=4, out_bytes=4):
    """B1: (bytes, operations) of one batched call: each input read once,
    the output written once; a*b evaluations of f plus a*b*d multiply-adds
    per job."""
    nbytes = 4 * (B * a + B * b + k) + v_bytes * B * b * d + out_bytes * B * a * d
    return nbytes, B * a * b * (2 * d + _f_ops(mode, k))


def bound(nbytes, ops, flops_per_s=FP32_FLOPS_PER_S):
    """(least time on an H100 in ms, what bounds it) for this much work,
    its operations at `flops_per_s` (fp32 outside the tensor cores unless
    given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def topo_work(B, H, L, m, hd, C, R):
    """B2: (bytes, operations) of one causal sweep: q, k, v, the mask
    pieces and the output each moved once; per (b, h, chunk) the causal
    half of q k^T and P v (C (C+1) / 2 pairs, what the mask needs), the row
    sums, and the state's read and write (2 C R m (hd + 1) operations
    each). R = 0: decay mode."""
    nC = L // C
    tables = H if R == 0 else 2 * H * L * R
    nbytes = 4 * (2 * B * H * L * m + 2 * B * H * L * hd + H * C * C + tables)
    pairs = C * (C + 1) // 2
    r = max(R, 1)
    ops_ = B * H * nC * (pairs * (2 * m + 2 * hd + 2)
                         + 4 * C * r * m * (hd + 1) + 2 * C * hd)
    return nbytes, ops_


def _window_pairs(L: int, window: int) -> int:
    """sum over i < L of min(i + 1, window)."""
    w = min(L, window)
    return w * (w + 1) // 2 + (L - w) * window


def flash_work(B, H, KV, L, hd, causal, nbytes_el, vd=None, Lk=None,
               window=0):
    """B5: (bytes, operations) of one call: q, k, v and out each moved
    once; q k^T and P v over the (query, key) pairs the mask keeps (2 hd +
    2 vd operations a pair, v's head dim vd = hd unless given; the
    softmax's exps not counted). Lk: the keys' length (cross-attention; L
    unless given); window: a causal window of that many keys (query i
    keeps min(i + 1, window) pairs)."""
    vd, Lk = vd or hd, Lk or L
    if causal and window:
        pairs = _window_pairs(L, window)
    else:
        pairs = L * (L + 1) // 2 if causal else L * Lk
    nbytes = nbytes_el * (B * H * L * (hd + vd) + B * KV * Lk * (hd + vd))
    return nbytes, B * H * pairs * 2 * (hd + vd)


def linear_work(B, H, L, m, hd, v_bytes):
    """B4: (bytes, operations) of one call: qf, kf (fp32), v, num and den
    (fp32) each moved once; the function's least operations, which do not
    depend on the kernel's chunk: those of a chunk of one row, per row the
    read of the state S, z and its update (4 m (hd + 1)) and the diagonal
    pair (2 m + 2 hd + 2)."""
    nbytes = (4 * 2 * B * H * L * m + v_bytes * B * H * L * hd
              + 4 * B * H * L * (hd + 1) + 4 * H)
    return nbytes, B * H * L * (4 * m * (hd + 1) + 2 * m + 2 * hd + 2)


def scan_work(Bt, L, din, N, in_bytes):
    """B6: (bytes, fp32 operations, exps) of one scan from h0 = 0: u, dt,
    B, C (in_bytes each), A, D read once, y and h_final (fp32) written
    once; per state update dt A, the state's multiply-add and C h's (5
    operations) and one exp; per (b, t, d) dt u, D u and its add (3)."""
    nbytes = (in_bytes * (2 * Bt * L * din + 2 * Bt * L * N)
              + 4 * (din * N + din + Bt * L * din + Bt * din * N))
    updates = Bt * L * din * N
    return nbytes, 5 * updates + 3 * Bt * L * din, updates


def scan_bound(nbytes, ops_, exps, sms, clock_mhz):
    """(least time in ms, "bytes" or "operations", the binding term): the
    larger of bytes over HBM, fp32 operations over the fp32 peak, and exps
    over the special function units (SFU_PER_CLOCK_PER_SM a clock on each
    of `sms` SMs at the card's maximum SM clock)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "fp32 operations": ops_ / FP32_FLOPS_PER_S,
             "sfu exps": exps / (SFU_PER_CLOCK_PER_SM * sms
                                 * clock_mhz * 1e6)}
    term = max(terms, key=terms.get)
    return (terms[term] * 1e3, "bytes" if term == "bytes" else "operations",
            term, {k: v * 1e3 for k, v in terms.items()})
