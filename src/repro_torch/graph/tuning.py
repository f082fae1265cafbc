"""The tuner's search over the compiled models' launches.

``kernels.autotune`` holds the tuning table, the candidates of each key
and the timer; this module gives it the models' launches: for a
``CompiledBNN`` at a batch, one runner per kernel launch of its plan,
on random operands of the launch's shapes with the main path's
epilogue (per-channel thresholds, packed outputs), launching with a
given plan through the kernel's private ``_launch``.

    python -m repro_torch.kernels.autotune --model binarynet alexnet \\
        --batches 1 32 256 --out chiprun_out/tuning.json

is the command line (``kernels.autotune.main``); it needs the card.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.workloads import alexnet_imagenet, binarynet_cifar10
from repro_torch.graph.compile import CompiledBNN, compile
from repro_torch.graph.ir import from_workload
from repro_torch.graph.passes import plan_tuning_keys
from repro_torch.kernels import autotune, fused_mlp, packed_conv
from repro_torch.kernels import popcount_gemm
from repro_torch.kernels.autotune import Entry, Key, tvec, words
from repro_torch.kernels.ops import conv_padding
from repro_torch.kernels.packed import resolve_device

__all__ = ["MODELS", "step_runners", "tune_models"]

MODELS = {"binarynet": binarynet_cifar10, "alexnet": alexnet_imagenet}

Runner = Tuple[Key, str, Callable[[Entry], Any]]


def step_runners(cb: CompiledBNN, batch: int, device: torch.device,
                 seed: int = 0) -> List[Runner]:
    """(key, label, runner) for each kernel launch of ``cb``'s plan at
    ``batch`` rows (the binarize step's pack has no launch plan to
    tune)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = cb.spec.conv_nodes
    out: List[Runner] = []
    for step in cb.plan:
        keys = plan_tuning_keys(cb.spec, (step,), batch)
        if not keys:
            continue
        key, a = keys[0], step.args
        if step.kind == "binary_conv" and a["impl"] == "direct":
            nd = convs[a["conv_idx"]]
            c32 = -(-nd.c_in // 32)
            ph, pw = conv_padding(a["pad"], nd.kh, nd.kw)
            xw = packed_conv.pad_words_spatial(
                words(gen, batch, nd.h_in, nd.w_in, c32), ph, pw
            ).contiguous()
            ww = words(gen, nd.kh * nd.kw * c32, nd.c_out)
            kw = dict(kh=nd.kh, kw=nd.kw, c=nd.c_in, stride=a["stride"],
                      ho=nd.h_out, wo=nd.w_out, pack_out=True,
                      threshold_vec=tvec(gen, nd.c_out, 40))

            def run(e, xw=xw, ww=ww, kw=kw):
                return packed_conv._launch(xw, ww, (e["bm"], e["bn"]), **kw)
        elif step.kind in ("binary_conv", "dense"):
            m, n, k32 = key[2:]
            pack = key[0].endswith("+pack")
            xp, wp = words(gen, m, k32), words(gen, n, k32)
            kw = dict(pack_out=True, threshold_vec=tvec(gen, n, 40)) \
                if pack else {}

            def run(e, xp=xp, wp=wp, k=32 * k32, kw=kw):
                return popcount_gemm._launch(
                    xp, wp, k, (e["bm"], e["bn"], e["wk"]), **kw)
        else:
            m, k0, ns = key[2:]
            ks = [k0] + list(ns[:-1])
            x = words(gen, m, -(-k0 // 32))
            ws = [words(gen, n, -(-k // 32)) for n, k in zip(ns, ks)]
            ts = [tvec(gen, n, 40) for n in ns]

            def run(e, x=x, ws=ws, ks=ks, ts=ts):
                return fused_mlp._launch(x, ws, ks, ts, (e["bm"], e["cs"]))
        out.append((key, f"{cb.spec.name} B={batch} {step.name}", run))
    return out


def tune_models(models: Sequence[str], batches: Sequence[int],
                device: Any = None, decode: bool = True,
                log: Optional[Callable[[str], None]] = print) -> List[dict]:
    """Tune every key of the models' plans at ``batches`` (and, with
    ``decode``, ``binary_dense`` at the decode GEMMs) on the card into
    the tuning table: each key once, in first-seen order.  Returns one
    row per key: its rule plan and time, its best plan and time, and
    every candidate's (entry, ms)."""
    dev = resolve_device(device)
    jobs: List[Runner] = []
    for name in models:
        spec = from_workload(MODELS[name]())
        for b in batches:
            jobs += step_runners(compile(spec, device=dev, batch=b), b, dev)
    if decode:
        jobs += autotune.decode_runners(dev)
    rows, seen = [], set()
    for key, label, run in jobs:
        if key in seen:
            continue
        seen.add(key)
        rule = autotune.resolve(key, dev, tuned=False)
        res = autotune.autotune(key, run, device=dev)
        rule_ms = next(ms for e, ms in res.times if e == rule)
        rows.append({"key": key, "label": label, "rule": rule,
                     "rule_ms": rule_ms, "best": res.entry,
                     "best_ms": res.ms, "times": res.times})
        if log is not None:
            log(f"{label} {autotune.key_str(key)}: rule {rule} "
                f"{rule_ms:.5f} ms, best {res.entry} {res.ms:.5f} ms "
                f"(rule/best {rule_ms / res.ms:.3f})")
    return rows
