"""Batched serving engine: slot-based continuous batching over a fixed-size
decode batch (vLLM-style, simplified to fixed shapes).

The reference's `repro.serve.engine` on the port. Requests join free
slots; every engine tick runs one decode step for the whole batch;
finished sequences (EOS or the cache bound) free their slot. The decode
cache is allocated once at construction on `device` (None: the CUDA
card), paged at slot granularity.

Prefill is FUSED: whole (right-padded) prompts run through one
`api.prefill_into_cache` call per admission group, which writes the
KV/state into the cache and gives the first generated token, with no
token-by-token replay through decode. Prompt lengths bucket to the next
power of two, so each bucket is one shape (the reference compiles once
per bucket; `analysis.trace_guard` counts the buckets the same way).
Decode takes a per-slot position VECTOR, which makes mid-wave admission
legal: a request joining a freed slot starts at its own position while
its neighbours keep decoding at theirs. A mid-wave prefill runs all B
rows; rows with length 0 keep their cache (`lm.forward_prefill_into_
cache`). `prefill_mode="replay"` restores the fresh-wave lockstep path,
and encoder-decoder models always use it.

Topological masking is first-class: a request may carry its own prompt
tree (`Request(tree=...)`) or name a registered plan by content sha
(`Request(plan_sha=...)` + a `PlanRegistry`). All live trees are packed
into ONE forest plan (block-diagonal, zero cross-request coupling),
patched on eviction through `ftfi.update_plan` and validated by the plan
guard on every swap (`serve.forest_masks`). A tree group's prefill runs
the topo layers through Alg. 1 on the plan executor (the Chebyshev
engine: no kernel launch), its decode the causal recurrence.

Fault isolation: a failing slot is evicted and its request re-queued with
bounded retry and exponential backoff instead of killing the batch; a
prefill or decode-step crash evicts the group/wave but leaves the engine
serviceable; per-request deadlines bound queue and decode time. Every
model call of the port is functional on the cache (each layer's new
cache is a new tensor; the old one is only read), and `self.cache` is
reassigned only after a call returns, so a call that raises part-way
leaves every live slot's rows as they were. A request stopped by the
`S - 1` cache bound completes with `truncated=True`, and `run()`
exhausting `max_ticks` fails every in-flight and queued request with an
explicit "engine stopped" error. Each tick moves the (B, V) logits to
the host once, as float32 numpy: argmax and the finiteness test run
there. Greedy decode is deterministic, so a retried request replays from
scratch onto the exact tokens it would have produced.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.analysis import trace_guard
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve.forest_masks import ForestMaskManager, PlanRegistry
from repro_torch.testing import faults


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # robustness knobs/outcome (per-request overrides of engine defaults)
    max_retries: int | None = None   # None -> engine default
    deadline_ticks: int | None = None  # ticks from submit() until expiry
    retries: int = 0
    error: str | None = None         # set iff done without a full answer
    truncated: bool = False          # done, but stopped by the cache bound
    # topological masking: a per-request tree over the prompt tokens, given
    # directly or by content sha into the engine's PlanRegistry
    tree: object = None              # WeightedTree | None
    plan_sha: str | None = None
    # host clock stamps (time.perf_counter(), s) the engine sets: submit,
    # the first token of the answer delivered (a retry's, after an
    # eviction), done
    t_submit: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _host_logits(logits) -> np.ndarray:
    """The (B, V) logits on the host as float32 numpy: one copy a call."""
    return logits.detach().float().cpu().numpy()


class ServeEngine:
    def __init__(self, cfg, params, batch_slots: int = 4, max_len: int = 256,
                 eos_id: int | None = None, plan=None,
                 max_retries: int = 2, retry_backoff: int = 1,
                 prefill_mode: str = "fused", registry=None,
                 mask_leaf_size: int = 8, device=None):
        """`params` is the model (`api.init_params` or
        `convert.from_reference`), living on `device` (None: the CUDA
        card, raising without one).

        `plan` optionally preloads a functional integration plan (an
        `ftfi.save_plan` artifact path, this package's or the reference's,
        or a (PlanSpec, PlanParams) pair) so topological-mask serving never
        rebuilds the IT at startup: a square plan that covers the model's
        patch grid is installed as the ViT grid plan, and the provenance
        (content hash, seed, leaf_size) is surfaced in `plan_banner()`.
        Either form passes the plan guard before anything reads its index
        arrays. Plans built on demand (the forest mask) consult the disk
        plan cache when `FTFI_PLAN_CACHE` is configured.

        `max_retries` bounds how many times a faulted request is
        re-queued before it is failed (`Request.error` set);
        `retry_backoff` scales the exponential re-admission delay (backoff
        * 2**(retries-1) ticks). `prefill_mode` selects "fused" (one
        prefill call per admission group, mid-wave admission) or "replay"
        (the fresh-wave path that feeds prompts token by token through
        decode; forced for encoder-decoder models). `registry` (a
        `PlanRegistry` or a directory path) resolves `Request.plan_sha`
        topologies; `mask_leaf_size` is the forest plan's leaf size.
        """
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.plan_spec = self.plan_params = None
        self.plan_grid_side = None  # set iff the plan serves the ViT grid
        if plan is not None:
            if isinstance(plan, (str, bytes)) or hasattr(plan, "__fspath__"):
                from repro_torch import ftfi

                plan = ftfi.load_plan(plan, device=self.device)  # validated
            else:
                from repro_torch.core import plan_guard

                plan_guard.validate(plan[0], plan[1],
                                    where="ServeEngine(plan=...)")
            self.plan_spec, self.plan_params = plan
            side = int(round(np.sqrt(self.plan_spec.n)))
            # install only when the plan covers THIS model's patch grid: a
            # square n from another model must not be claimed as served
            if (side * side == self.plan_spec.n
                    and getattr(cfg, "num_prefix_embeddings", None)
                    == self.plan_spec.n):
                from repro_torch.models import vit

                self.plan_grid_side = vit.install_grid_plan(
                    self.plan_spec, self.plan_params, device=self.device)
        self.B = batch_slots
        self.S = max_len
        self.eos = eos_id
        self.max_retries = int(max_retries)
        self.retry_backoff = max(0, int(retry_backoff))
        if prefill_mode not in ("fused", "replay"):
            raise ValueError(f"prefill_mode must be 'fused' or 'replay', "
                             f"got {prefill_mode!r}")
        if cfg.is_encdec:
            prefill_mode = "replay"  # fused prefill is decoder-only
        self.prefill_mode = prefill_mode
        if registry is not None and not isinstance(registry, PlanRegistry):
            registry = PlanRegistry(registry, leaf_size=mask_leaf_size,
                                    device=self.device)
        self.registry = registry
        self.masks = ForestMaskManager(self.B, leaf_size=mask_leaf_size,
                                       device=self.device)
        self.cache = api.init_cache(cfg, self.B, self.S, device=self.device)
        self.slot_req: list[Request | None] = [None] * self.B
        self.slot_pos = np.zeros(self.B, dtype=np.int64)
        self._seen: set = set()  # (site, bucket) pairs already recorded
        self.queue: list[Request] = []
        self._tick = 0
        self._stats = {
            "ticks": 0, "completed": 0, "failed": 0, "retries": 0,
            "evictions": 0, "step_failures": 0, "slot_faults": 0,
            "deadline_expired": 0, "truncated": 0, "stopped_inflight": 0,
            "prefill_calls": 0, "prefill_failures": 0,
            "prefill_tokens": 0, "decode_tokens": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
        }

    # -- model calls --------------------------------------------------------

    def _record(self, site: str, bucket=None, detail: str = "") -> None:
        """`trace_guard.record(site)` on this engine's first call of
        (site, bucket): where the reference's jitted body would trace."""
        if (site, bucket) not in self._seen:
            self._seen.add((site, bucket))
            trace_guard.record(site, detail=detail)

    def _decode(self, toks, pos):
        self._record("serve.decode")
        return api.decode_fn(self.cfg, self.params, self.cache, toks, pos,
                             self.S, device=self.device)

    def _prefill(self, tokens, lengths):
        # one bucket per pow2 prompt length, then shape-stable
        Lp = tokens.shape[1]
        self._record("serve.prefill", Lp, detail=f"L{Lp}")
        return api.prefill_into_cache(self.cfg, self.params, self.cache,
                                      tokens, lengths, self.S,
                                      device=self.device)

    def _prefill_tree(self, tokens, lengths, spec, pp, pack, unpack):
        from repro_torch.core import masks as M
        from repro_torch.models import attention as A

        # the reference's spec is a static jit argument keyed by its
        # digest: one bucket per (pow2 length, forest plan)
        Lp = tokens.shape[1]
        self._record("serve.prefill_tree", (Lp, spec.digest),
                     detail=f"L{Lp}")
        cfg = self.cfg
        backend = A.resolve_topo_backend(cfg)
        tree_mask = {
            "make_fastmult": lambda coeffs: M.make_tree_fastmult(
                (spec, pp), cfg.topo_g, coeffs, cfg.topo_dist_scale,
                backend=backend, device=self.device),
            "pack": pack, "unpack": unpack,
        }
        return api.prefill_into_cache(cfg, self.params, self.cache, tokens,
                                      lengths, self.S, tree_mask=tree_mask,
                                      device=self.device)

    # -- banners and stats --------------------------------------------------

    def plan_banner(self) -> str:
        """Provenance lines for the serve log: which integration plan this
        engine serves with, where it came from, and whether on-demand
        builds are backed by the disk plan cache."""
        from repro_torch.core import plan_cache

        if plan_cache.enabled():
            st = plan_cache.stats()
            cache_line = (f"plan-cache: {st['dir']} "
                          f"({st['entries']} entries, "
                          f"{st['bytes'] / 1e6:.1f}/"
                          f"{st['max_bytes'] / 1e6:.0f} MB)")
        else:
            cache_line = "plan-cache: disabled (set FTFI_PLAN_CACHE)"
        if self.plan_spec is None:
            return f"plan: none (no preloaded integration plan)\n{cache_line}"
        s = self.plan_spec
        if self.plan_grid_side is not None:
            status = (f"installed as {self.plan_grid_side}x"
                      f"{self.plan_grid_side} grid integrator — "
                      "zero IT rebuild")
        else:
            status = ("loaded, NOT installed: plan does not cover this "
                      "model's patch grid; consume via Integrator.from_plan")
        return (f"plan: sha={s.fingerprint[:12]} seed={s.seed} "
                f"leaf_size={s.leaf_size} n={s.n} trees={s.num_trees} "
                f"grid_h={s.grid_h} reweightable={s.reweightable} "
                f"({status})\n{cache_line}")

    def stats(self) -> dict:
        """Engine health snapshot: serving counters plus the robustness
        counters of the layers underneath (degradation ladder, plan guard,
        disk plan cache, forest-mask manager)."""
        from repro_torch.core import ladder, plan_cache, plan_guard

        return {
            **self._stats,
            "ladder": ladder.stats(),
            "plan_guard": plan_guard.stats(),
            "plan_cache": plan_cache.stats() if plan_cache.enabled() else None,
            "forest_masks": dict(self.masks.stats),
        }

    def health_banner(self) -> str:
        """One-line health summary for the serve log."""
        st = self.stats()
        lad = st["ladder"]
        blocked = ",".join(sorted(lad["blocked"])) or "none"
        return (f"health: ticks={st['ticks']} done={st['completed']} "
                f"failed={st['failed']} retries={st['retries']} "
                f"evictions={st['evictions']} "
                f"truncated={st['truncated']} "
                f"stopped={st['stopped_inflight']} "
                f"demotions={lad['demotions']} blocked={blocked} "
                f"validations={st['plan_guard']['validations']} "
                f"(rejected {st['plan_guard']['failures']}) "
                f"{self.mesh_banner()}")

    def mesh_banner(self) -> str:
        """Device provenance segment: how many devices this process sees
        (the CUDA cards, or 1 on the CPU) against what the preloaded plan
        artifact was sharded for."""
        from repro_torch.core.plan_shard import SHARD_LAYOUT_VERSION

        n = torch.cuda.device_count() if self.device.type == "cuda" else 1
        seg = f"devices={n}"
        s = self.plan_spec
        if s is not None and int(getattr(s, "shard_layout", 0) or 0):
            axes = ",".join(getattr(s, "mesh_axes", ()) or ()) or "-"
            seg += (f" plan_mesh={int(s.mesh_devices)}({axes}) "
                    f"shard_layout=v{int(s.shard_layout)}/"
                    f"v{SHARD_LAYOUT_VERSION}")
        else:
            seg += " plan_mesh=unsharded"
        return seg

    def submit(self, req: Request):
        req._submit_tick = self._tick
        req._not_before = self._tick
        req.t_submit = time.perf_counter()
        req.t_first_token = req.t_done = None
        self.queue.append(req)

    # -- failure handling ---------------------------------------------------

    def _fail(self, req: Request, reason: str) -> None:
        req.done = True
        req.error = reason
        req.t_done = time.perf_counter()
        self._stats["failed"] += 1

    def _deadline_left(self, req: Request) -> int | None:
        if req.deadline_ticks is None:
            return None
        return req._submit_tick + req.deadline_ticks - self._tick

    def _evict(self, slot: int, reason: str) -> None:
        """Per-request isolation: free the slot and either re-queue the
        request (bounded retry, exponential backoff, output replayed from
        scratch: greedy decode is deterministic) or fail it."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        self.masks.evict(slot)
        if req is None:
            return
        self._stats["evictions"] += 1
        req.retries += 1
        req.out = []
        req.truncated = False
        req._pending_prompt = None
        limit = self.max_retries if req.max_retries is None else req.max_retries
        if req.retries > limit:
            self._fail(req, f"failed after {limit} retries: {reason}")
        else:
            self._stats["retries"] += 1
            req._not_before = (self._tick
                               + self.retry_backoff * 2 ** (req.retries - 1))
            self.queue.append(req)

    def _emit(self, req: Request, token: int) -> None:
        req.out.append(token)
        if len(req.out) == 1:
            req.t_first_token = time.perf_counter()

    # -- admission ----------------------------------------------------------

    def _validate_request(self, req: Request) -> str | None:
        """Admission-time request validation; returns an error string (the
        request fails cleanly) or None (admissible; `req._tree`
        resolved)."""
        req._tree = None
        if not req.prompt:
            return "empty prompt"
        if len(req.prompt) >= self.S:
            return (f"prompt length {len(req.prompt)} >= max_len {self.S} "
                    "(no room to generate)")
        tree = req.tree
        if tree is None and req.plan_sha is not None:
            if self.registry is None:
                return (f"request names plan_sha={req.plan_sha} but the "
                        "engine has no plan registry")
            try:
                tree = self.registry.resolve_tree(req.plan_sha)
            except Exception as e:
                return (f"plan_sha {req.plan_sha} unresolved: "
                        f"{type(e).__name__}: {e}")
        if tree is not None:
            if self.prefill_mode != "fused":
                return "tree-masked requests require prefill_mode='fused'"
            if self.cfg.attention_variant != "topo":
                return ("tree-masked requests require "
                        "attention_variant='topo', engine serves "
                        f"{self.cfg.attention_variant!r}")
            if tree.num_vertices != len(req.prompt):
                return (f"tree has {tree.num_vertices} vertices for a "
                        f"{len(req.prompt)}-token prompt")
        req._tree = tree
        return None

    def _admit(self) -> list[int]:
        """Admit queued requests into free slots (FIFO). Fused prefill
        makes mid-wave admission legal (every slot decodes at its own
        position), so any free slot is fair game on any tick. Replay mode
        keeps the fresh-wave rule (admission only when no slot is active:
        its wave starts together at position 0). Queued requests still in
        retry backoff stay queued; expired deadlines and invalid requests
        (empty/oversized prompt, unresolvable tree) fail here. Returns the
        admitted slots."""
        admitted: list[int] = []
        if (self.prefill_mode == "replay"
                and any(r is not None for r in self.slot_req)):
            return admitted
        still_queued: list[Request] = []
        free = [s for s in range(self.B) if self.slot_req[s] is None]
        for req in self.queue:
            left = self._deadline_left(req)
            if left is not None and left <= 0:
                self._stats["deadline_expired"] += 1
                self._fail(req, f"deadline expired after "
                                f"{req.deadline_ticks} ticks in queue")
                continue
            if not free or req._not_before > self._tick:
                still_queued.append(req)
                continue
            err = self._validate_request(req)
            if err is not None:
                self._fail(req, err)
                continue
            slot = free[0]
            if req._tree is not None:
                try:
                    self.masks.admit(slot, req._tree)
                except Exception as e:
                    self._fail(req, f"forest-mask admit failed: "
                                    f"{type(e).__name__}: {e}")
                    continue
            free.pop(0)
            self.slot_req[slot] = req
            self.slot_pos[slot] = 0
            req._pending_prompt = (list(req.prompt)
                                   if self.prefill_mode == "replay" else None)
            admitted.append(slot)
        self.queue = still_queued
        return admitted

    # -- fused prefill ------------------------------------------------------

    def _prefill_admitted(self, slots: list[int]) -> None:
        """Fused prefill of freshly admitted slots: one call per group
        (plain and tree-masked prompts prefill apart: the tree group
        threads the packed forest plan through the topo layers)."""
        plain = [s for s in slots if self.slot_req[s]._tree is None]
        treed = [s for s in slots if self.slot_req[s]._tree is not None]
        for group, use_tree in ((plain, False), (treed, True)):
            if group:
                self._prefill_group(group, use_tree)

    def _prefill_group(self, group: list[int], use_tree: bool) -> None:
        reqs = {s: self.slot_req[s] for s in group}
        Lp = min(self.S, _next_pow2(max(
            8, max(len(r.prompt) for r in reqs.values()))))
        tokens = np.zeros((self.B, Lp), dtype=np.int32)
        lengths = np.zeros((self.B,), dtype=np.int32)
        for s, req in reqs.items():
            tokens[s, :len(req.prompt)] = req.prompt
            lengths[s] = len(req.prompt)
        t0 = time.perf_counter()
        try:
            faults.fire("serve.prefill", tick=self._tick)
            if use_tree:
                pack, unpack = self.masks.pack_maps(Lp, group, self.B)
                logits, cache = self._prefill_tree(
                    tokens, lengths, self.masks.spec, self.masks.params,
                    pack, unpack)
            else:
                logits, cache = self._prefill(tokens, lengths)
            logits_np = _host_logits(logits)
        except Exception as e:
            # group failure: the engine survives, the group is re-queued
            self._stats["prefill_failures"] += 1
            reason = f"prefill failed: {type(e).__name__}: {e}"
            for s in group:
                self._evict(s, reason)
            return
        self.cache = cache
        self._stats["prefill_calls"] += 1
        self._stats["prefill_s"] += time.perf_counter() - t0
        logits_np = faults.transform("serve.prefill_logits", logits_np,
                                     tick=self._tick)
        finite = np.isfinite(logits_np).all(axis=-1)
        nxt = np.argmax(logits_np, axis=-1)
        for s in group:
            req = reqs[s]
            if not finite[s]:
                self._stats["slot_faults"] += 1
                self._evict(s, "non-finite prefill logits")
                continue
            self._emit(req, int(nxt[s]))
            self._stats["prefill_tokens"] += len(req.prompt)
            self.slot_pos[s] = len(req.prompt)
            self._finish_if_done(s)

    # -- completion ---------------------------------------------------------

    def _finish_if_done(self, s: int) -> None:
        """Completion check for slot `s`: EOS, max_new_tokens, or the cache
        bound. Hitting `S - 1` before the request's budget marks the
        answer `truncated` (counted) instead of passing it off as full."""
        req = self.slot_req[s]
        if req is None or (self.prefill_mode == "replay"
                           and req._pending_prompt):
            return
        hit_eos = (self.eos is not None and req.out
                   and req.out[-1] == self.eos)
        full = len(req.out) >= req.max_new_tokens
        at_bound = self.slot_pos[s] >= self.S - 1
        if not (hit_eos or full or at_bound):
            return
        if at_bound and not (hit_eos or full):
            req.truncated = True
            self._stats["truncated"] += 1
        req.done = True
        req.t_done = time.perf_counter()
        self._stats["completed"] += 1
        self.slot_req[s] = None
        self.slot_pos[s] = 0
        self.masks.evict(s)

    def step(self):
        """One engine tick: admit + fused-prefill new requests, then one
        batched decode feeding every active slot its next token at its OWN
        position. Faults are contained: a prefill/decode crash evicts (and
        re-queues) the group/wave, a non-finite logits row evicts only that
        slot. A freshly prefilled slot joins the same tick's decode with
        its real first token (an admission tick therefore yields two
        tokens for the new request)."""
        self._tick += 1
        self._stats["ticks"] += 1
        admitted = self._admit()
        # enforce per-request deadlines on the active wave too (covers a
        # wave stalled by repeated step failures)
        for s in range(self.B):
            req = self.slot_req[s]
            if req is None:
                continue
            left = self._deadline_left(req)
            if left is not None and left <= 0:
                self._stats["deadline_expired"] += 1
                self.slot_req[s] = None
                self.slot_pos[s] = 0
                self.masks.evict(s)
                self._stats["evictions"] += 1
                self._fail(req, f"deadline expired after "
                                f"{req.deadline_ticks} ticks")
        admitted = [s for s in admitted if self.slot_req[s] is not None]
        if admitted and self.prefill_mode == "fused":
            self._prefill_admitted(admitted)
        active = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not active:
            return False
        # each slot feeds its next token at its own position: prompt replay
        # (replay mode) or its latest generation. Inactive rows decode junk
        # at position 0, overwritten by the next prefill before anything
        # reads it.
        toks = np.zeros((self.B, 1), dtype=np.int32)
        for s in active:
            req = self.slot_req[s]
            if req._pending_prompt:
                toks[s, 0] = req._pending_prompt[0]
            elif req.out:
                toks[s, 0] = req.out[-1]
        pos = np.clip(self.slot_pos, 0, self.S - 1).astype(np.int32)
        t0 = time.perf_counter()
        try:
            faults.fire("serve.step", tick=self._tick)
            logits, cache = self._decode(toks, pos)
            logits_np = _host_logits(logits[:, -1, :])
        except Exception as e:
            # whole-step failure: the engine survives, the wave is re-queued
            self._stats["step_failures"] += 1
            reason = f"decode step failed: {type(e).__name__}: {e}"
            for s in active:
                self._evict(s, reason)
            return True
        self.cache = cache
        self._stats["decode_s"] += time.perf_counter() - t0
        logits_np = faults.transform("serve.logits", logits_np,
                                     tick=self._tick)
        finite = np.isfinite(logits_np).all(axis=-1)
        nxt = np.argmax(logits_np, axis=-1)
        for s in active:
            req = self.slot_req[s]
            if not finite[s]:
                # per-slot corruption: only this request is touched
                self._stats["slot_faults"] += 1
                self._evict(s, "non-finite logits")
                continue
            if req._pending_prompt:
                req._pending_prompt.pop(0)
                self._stats["prefill_tokens"] += 1
                if not req._pending_prompt:
                    self._emit(req, int(nxt[s]))
                    self._stats["decode_tokens"] += 1
            else:
                self._emit(req, int(nxt[s]))
                self._stats["decode_tokens"] += 1
            self.slot_pos[s] += 1
            self._finish_if_done(s)
        return True

    def run(self, max_ticks: int = 10000):
        """Tick until drained or `max_ticks`. Exhausting the tick budget
        with work still in flight is an engine stop, not a quiet return:
        every in-flight and queued request is failed with an explicit
        "engine stopped" error (counted in `stats()["stopped_inflight"]`
        and the health banner) so callers never see a hung request."""
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        leftovers = ([r for r in self.slot_req if r is not None]
                     + list(self.queue))
        if leftovers:
            for req in leftovers:
                self._stats["stopped_inflight"] += 1
                self._fail(req, f"engine stopped: max_ticks={max_ticks} "
                                "exhausted before completion")
            self.slot_req = [None] * self.B
            self.slot_pos[:] = 0
            self.queue = []
            for s in range(self.B):
                self.masks.evict(s)
        return ticks
