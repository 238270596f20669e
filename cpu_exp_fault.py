"""Fresh-process check of PyTorch's CPU float32 `exp` (torch and numpy only).

    python cpu_exp_fault.py [--rounds 16] [--warm-up] [--threads N]

Each round runs a torch process that keeps the cores busy for 2 s, then a
fresh process that makes a few small parallel ops and then its first
float32 `torch.exp`, over 12 x 61 x 61 values (the shape of a forest plan's
leaf bucket), and holds it against float64 numpy. On a CPU build of torch
whose `exp` goes through MKL's VML (`vmsExp` in its high-accuracy mode),
one OpenMP thread's share of that first call can come back wrong by ~1e-4
relative. Each wrong share is then recomputed by `vmsExp` in its low-
accuracy EP mode on MKL's AVX2 code path and compared bit for bit.
`--warm-up` makes one parallel exp first; `--threads` sets OMP_NUM_THREADS.
Prints one line a round and a JSON summary last."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

BUSY = """
import time, torch
a = torch.rand(512, 512)
t = time.time()
while time.time() - t < 2:
    a = torch.tanh(a @ a)
"""

FIRST_EXP = """
import sys
import numpy as np
import torch
rng = np.random.default_rng(0)
if sys.argv[2] == "1":
    torch.exp(torch.rand(64, 64, 64))
torch.zeros(575, 121)[torch.arange(575), torch.arange(575) % 121] = 1.0
X = torch.cat([torch.zeros(575, 121), torch.zeros(1, 121)])
torch.zeros_like(X)
X[torch.from_numpy(rng.integers(0, 576, (12, 61)))]
x = -0.5 * torch.from_numpy(rng.uniform(0, 20, (12, 61, 61)).astype(np.float32))
y = torch.exp(x)
np.savez(sys.argv[1], x=x.numpy().ravel(), y=y.numpy().ravel())
"""

# vmsExp(n, a, r, mode) as torch's CPU library exports it; the mode bits are
# MKL's VML_EP | VML_FTZDAZ_OFF | VML_ERRMODE_IGNORE
VML_EP = """
import ctypes, os, sys
import numpy as np
import torch
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                               "libtorch_cpu.so"))
d = np.load(sys.argv[1])
x = np.ascontiguousarray(d["x"][int(sys.argv[2]):int(sys.argv[3])])
r = np.empty_like(x)
fp = ctypes.POINTER(ctypes.c_float)
lib.vmsExp(ctypes.c_int(x.size), x.ctypes.data_as(fp), r.ctypes.data_as(fp),
           ctypes.c_int64(0x3 | 0x140000 | 0x100))
np.save(sys.argv[4], r)
"""


def _py(code, *args, env=None):
    subprocess.run([sys.executable, "-c", code, *map(str, args)], check=True,
                   env=env)


def main(argv=None) -> dict:
    import numpy as np
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--warm-up", action="store_true")
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)
    env = dict(os.environ)
    if args.threads:
        env["OMP_NUM_THREADS"] = str(args.threads)
    bad, ep_equal, worst = 0, 0, 0.0
    with tempfile.TemporaryDirectory() as tmp:
        out, ep = os.path.join(tmp, "exp.npz"), os.path.join(tmp, "ep.npy")
        for r in range(args.rounds):
            _py(BUSY)
            _py(FIRST_EXP, out, int(args.warm_up), env=env)
            d = np.load(out)
            rel = np.abs(d["y"] / np.exp(d["x"].astype(np.float64)) - 1)
            worst = max(worst, float(rel.max()))
            wrong = np.flatnonzero(rel > 1e-6)
            line = f"round {r}: max rel err {rel.max():.3e}"
            if wrong.size:
                bad += 1
                lo, hi = int(wrong.min()), int(wrong.max()) + 1
                _py(VML_EP, out, lo, hi, ep,
                    env={**env, "MKL_ENABLE_INSTRUCTIONS": "AVX2"})
                same = bool(np.array_equal(np.load(ep), d["y"][lo:hi]))
                ep_equal += same
                line += (f", elements {lo}-{hi - 1} of {rel.size} wrong; "
                         f"equal to vmsExp EP on AVX2: {same}")
            print(line, flush=True)
    res = {"rounds": args.rounds, "warm_up": args.warm_up,
           "threads": args.threads, "bad_rounds": bad,
           "bad_equal_to_vml_ep_avx2": ep_equal, "max_rel_err": worst}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
