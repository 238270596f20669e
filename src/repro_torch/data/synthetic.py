"""Deterministic synthetic LM data, host-sharded: the port's own copy of the
reference's `data/synthetic.py` (numpy only), so that `batch_at(step)` gives
the reference's arrays bit for bit.

The stream is a pure function of (seed, host_id, num_hosts, step) so that a
restarted job consumes *exactly* the same batches (the bit-identical resume
of `train.loop`). The generator mixes a Markov bigram component with copy
spans so that a real LM can actually reduce loss on it.

With `vlm_prefix` (patches) or `encdec_src` (frames) the batch also holds
the stub frontends' inputs, "patch_embeds" (B, vlm_prefix, 1024) and
"src_embeds" (B, encdec_src, 1024), float32 normals drawn from the same
generator after the tokens, in the reference's order. The reference's
background prefetch thread is not copied: the loop calls `batch_at` only.
"""
from __future__ import annotations

import numpy as np


class SyntheticLMStream:
    def __init__(self, vocab_size: int, batch_size: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 vlm_prefix: int = 0, encdec_src: int = 0,
                 branching: int = 8):
        assert batch_size % num_hosts == 0
        self.vocab = vocab_size
        self.local_batch = batch_size // num_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.vlm_prefix = vlm_prefix
        self.encdec_src = encdec_src
        # fixed bigram table (shared across hosts); low branching keeps the
        # transition structure learnable within a few hundred steps
        rng = np.random.default_rng(seed)
        k = min(branching, vocab_size)
        self._succ = rng.integers(0, vocab_size, size=(vocab_size, k))

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a given global step (resume-safe)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.host_id)
        B, L = self.local_batch, self.seq_len
        toks = np.empty((B, L), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=B)
        choice = rng.integers(0, self._succ.shape[1], size=(B, L))
        for t in range(1, L):
            toks[:, t] = self._succ[toks[:, t - 1], choice[:, t]]
        # copy spans: repeat a chunk to create learnable long-range structure
        span = max(2, L // 8)
        for b in range(B):
            s = rng.integers(0, L - 2 * span)
            toks[b, s + span:s + 2 * span] = toks[b, s:s + span]
        out = {"tokens": toks}
        if self.vlm_prefix:
            out["patch_embeds"] = rng.normal(
                size=(B, self.vlm_prefix, 1024)).astype(np.float32)
        if self.encdec_src:
            out["src_embeds"] = rng.normal(
                size=(B, self.encdec_src, 1024)).astype(np.float32)
        return out
