"""Batched serving loop: continuous-batching-lite over prefill +
decode_step, with optional TULIP-packed weights.

The port of ``repro.launch.serve``.  With packed=True the Engine holds
the packed parameter tree: every binarizable projection is a
PackedArray (int32 words + layout metadata) that flows straight into
prefill / decode, unpacked at use as the reference does.

Requests enter a queue; slots in the fixed decode batch are assigned as
they free up (each slot tracks its own ``step``, so sequences of
different lengths coexist in one decode batch).

Prefill runs once per prompt-length *bucket*, not once per request:
prompts are right-padded to the next power of two (``pow2_ceil``, the
rule the BNN server's batch buckets use), clamped to the cache
capacity, and the prefill function for that bucket is built once and
kept in ``Engine._prefill_cache``; ``prefill_traces`` counts the buckets
built (the reference counts jit traces: in eager torch nothing is
compiled, so the count bounds the shapes prefill runs at).  Logits are
taken at the true last token through ``prefill(lengths=...)``.
Right-padding is safe for attention stacks (causal masking + the
ring-cache invariant); recurrent stacks (mamba / rglru) and enc-dec
stacks use exact lengths.

The Engine runs on the card unless the caller passes a CPU device:

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced \\
        --requests 6 --max-new 8 [--packed] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels.packed import resolve_device, tree_nbytes
from repro_torch.models import model as M
from repro_torch.models.quantize import pack_model_params
from repro_torch.serving.bucketing import pow2_ceil


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class Engine:
    """Fixed-batch decode engine with slot recycling, on ``device``
    (None = the card; params are moved there).  Every token is the
    argmax of its logits (greedy); sampling is not ported."""

    def __init__(self, cfg, params, batch_slots: int, capacity: int,
                 packed: bool = False, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.packed = packed
        params = tree.map(lambda t: t.to(self.device), params)
        self.params = pack_model_params(params) if packed else params
        self.param_bytes = tree_nbytes(self.params)
        self.B = batch_slots
        self.capacity = capacity
        self.caches = M.init_caches(cfg, batch_slots, capacity, self.device)
        self.steps = np.zeros((batch_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self._prefill_cache: Dict[int, Any] = {}
        self.prefill_traces = 0
        # right-padding pads never reach attention output (causal mask +
        # ring-cache overwrite), but they do pollute recurrent state —
        # those archs cache per exact length instead of per bucket
        kinds = set(M.decoder_pattern(cfg))
        self._bucketed = not (kinds & {"mamba", "rglru"}) \
            and not cfg.is_encdec

    def _decode(self, params, batch):
        return M.decode_step(params, self.cfg, batch)

    def _prefill_len(self, n: int) -> int:
        """Bucket a prompt length: next power of two, clamped to the
        cache capacity (padding past capacity would evict real tokens
        from the ring); exact length for recurrent stacks."""
        if not self._bucketed or n >= self.capacity:
            return n
        return min(pow2_ceil(n), self.capacity)

    def _get_prefill(self, padded_len: int):
        """The prefill for one bucketed prompt length — built once,
        reused for every admit that lands in the bucket."""
        fn = self._prefill_cache.get(padded_len)
        if fn is None:
            def fn(params, tokens, lengths):
                return M.prefill(params, self.cfg, {"tokens": tokens},
                                 cache_capacity=self.capacity,
                                 lengths=lengths)
            self._prefill_cache[padded_len] = fn
            self.prefill_traces += 1
        return fn

    def _admit(self, req: Request, slot: int) -> None:
        """Prefill the prompt for one slot and splice its caches in."""
        n = len(req.prompt)
        padded = self._prefill_len(n)
        toks = np.zeros((1, padded), np.int64)
        toks[0, :n] = req.prompt
        logits, caches1 = self._get_prefill(padded)(
            self.params, torch.from_numpy(toks).to(self.device),
            torch.tensor([n], dtype=torch.int32, device=self.device))
        tok = int(torch.argmax(logits[0, -1]))
        req.out.append(tok)
        _splice_slot(self.caches, caches1, slot)
        self.steps[slot] = len(req.prompt)
        self.slot_req[slot] = req

    def step(self) -> None:
        toks = np.zeros((self.B, 1), np.int64)
        for s, r in enumerate(self.slot_req):
            if r is not None and r.out:
                toks[s, 0] = r.out[-1]
        batch = {"tokens": torch.from_numpy(toks).to(self.device),
                 "step": torch.from_numpy(self.steps.copy()).to(self.device),
                 "caches": self.caches}
        logits, self.caches = self._decode(self.params, batch)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for s, r in enumerate(self.slot_req):
            if r is None:
                continue
            self.steps[s] += 1
            r.out.append(int(nxt[s]))
            if len(r.out) >= r.max_new:
                r.done = True
                self.slot_req[s] = None

    def run(self, requests: List[Request], log=print) -> List[Request]:
        pending = list(requests)

        def active():
            return any(r is not None for r in self.slot_req)

        t0 = time.perf_counter()
        n_steps = 0
        while pending or active():
            for s in range(self.B):
                if self.slot_req[s] is None and pending:
                    self._admit(pending.pop(0), s)
            self.step()
            n_steps += 1
        dt = time.perf_counter() - t0
        total = sum(len(r.out) for r in requests)
        log(f"served {len(requests)} requests / {total} tokens in "
            f"{n_steps} engine steps, {dt:.2f}s "
            f"({total / max(dt, 1e-9):.1f} tok/s); params "
            f"{self.param_bytes / 1e6:.1f} MB "
            f"({'packed' if self.packed else 'dense'}) on {self.device}")
        return requests


def _splice_slot(big_tree, one_tree, slot: int) -> None:
    """Write a 1-row prefill cache into slot ``slot`` of the batch cache,
    in place (the engine owns its caches).

    The batch axis is 1 for cycle-stacked leaves (leading [n_cycles])
    and 0 for remainder-layer leaves."""
    for part, axis in (("layers", 1), ("rem", 0)):
        tree.map(lambda big, one: big.narrow(axis, slot, 1).copy_(one),
                 big_tree[part], one_tree[part])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--packed", action="store_true",
                    help="TULIP bit-packed weights")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg).replace(dtype="float32")
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    eng = Engine(cfg, params, batch_slots=args.slots,
                 capacity=args.capacity, packed=args.packed, device=dev)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                    args.max_new)
            for i in range(args.requests)]
    eng.run(reqs)
    for r in reqs[:3]:
        print(f"req {r.rid}: +{len(r.out)} tokens {r.out[:8]}")


if __name__ == "__main__":
    main()
