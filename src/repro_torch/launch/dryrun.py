"""Dry-run: count every (arch x shape x variant) cell without allocation
— the port's counterpart of ``repro.launch.dryrun``.

The reference jits each cell with ``ShapeDtypeStruct`` stand-ins on 512
fake devices, compiles it, and reads XLA's ``memory_analysis`` and
``cost_analysis`` plus ``hlo_cost.analyze`` of the compiled text.  The
port has no HLO.  Here params and inputs are meta tensors
(``abstract_params`` / ``input_specs``, packed trees through
``pack_model_params``), the port's own step runs on them once under
``repro_torch.runtime.op_cost.Counter``, and the record carries:

  * ``cost`` — the run as walked: every op dispatched, at the cut depth
    and with each chunk loop counted once (what XLA's
    ``cost_analysis`` gives for a ``while`` body);
  * ``cost2`` / ``collectives`` — trip-scaled, the counterpart of
    ``hlo_cost.analyze``: a layer cycle is counted as the difference of
    two runs with k and k + 1 cycles (``op_cost.extrapolate``; it
    prices the cycle's backward, remat recompute and optimizer work
    with it) and scaled to the config's cycle count; chunk loops under
    no grad run one trip, scaled (``op_cost.scan``);
  * ``memory`` in XLA's names — ``argument_size_in_bytes`` (params +
    optimizer state + inputs, at full size), ``output_size_in_bytes``
    (the step's outputs) and ``temp_size_in_bytes`` (the peak of live
    bytes created during the step, outputs live at that peak
    included: torch has no donation), the last two extrapolated over
    the cycles as the cost is;
  * ``n_params`` / ``n_params_active`` from ``cfg.param_count``, as the
    reference.

``collectives_static`` is left out: it reads collective ops out of the
HLO text.  The run needs no device; on a host with a card the record
adds the card's ``total_memory`` beside the counts.

The mesh has one value, ``one_card``.  ``tp_only_packed_kv8`` keeps its
config changes (packed weights, int8 KV); its other difference in the
reference, FSDP off, has no meaning on one card.

The step functions are the port's own: ``launch.train.make_train_step``
with ``optim.adamw`` for train (a packed tree trains its floating
leaves and holds the words fixed: ``jax.grad`` refuses integer leaves,
so the reference's train x packed cells fail there), ``model.prefill``
at ``cache_capacity=seq_len``, ``model.decode_step``.

  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape \\
      train_4k --variant baseline --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all --variant packed
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.configs import (ARCHS, SHAPES, get_arch, get_shape,
                                 shape_applicable)
from repro_torch.kernels.packed import PackedArray
from repro_torch.launch.train import deterministic, make_train_step
from repro_torch.models import model as M
from repro_torch.models.quantize import pack_model_params
from repro_torch.models.transformer import find_cycle
from repro_torch.optim import adamw
from repro_torch.runtime import op_cost

__all__ = ["MESHES", "VARIANTS", "build_cell", "cell_config",
           "cut_depth", "main", "run_cell", "step_cost"]

VARIANTS = ("baseline", "remat_none", "remat_dots", "packed",
            "moe_capacity", "moe_gather", "kv_int8", "tp_only_packed_kv8",
            "big_chunks", "remat_dots_big_chunks", "packed_moe_capacity")
MESHES = ("one_card",)
BASE_CYCLES = 2        # the deepest base cut (k cycles, then k + 1)


def cell_config(arch: str, shape_name: str, variant: str = "baseline"):
    """The config of one cell: the reference's per-variant rules."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    if shape.kind == "train" and cfg.padded_vocab() >= 65536:
        cfg = cfg.replace(logits_chunk=8192)
    if shape.kind == "train":
        remat = {"remat_none": "none", "remat_dots": "dots"}.get(
            variant, "full")
        cfg = cfg.replace(remat=remat)
    if variant == "packed":
        cfg = cfg.replace(pack_weights=True)
    if variant == "moe_capacity":
        cfg = cfg.replace(moe_impl="capacity")
    if variant == "moe_gather":
        cfg = cfg.replace(moe_impl="gather")
    if variant in ("kv_int8", "tp_only_packed_kv8"):
        cfg = cfg.replace(kv_cache_dtype="int8")
    if variant == "big_chunks":
        cfg = cfg.replace(attn_q_chunk=2048, attn_kv_chunk=4096)
    if variant == "remat_dots_big_chunks":
        cfg = cfg.replace(attn_q_chunk=2048, attn_kv_chunk=4096,
                          remat="dots")
    if variant == "packed_moe_capacity":
        cfg = cfg.replace(pack_weights=True, moe_impl="capacity")
    return cfg


def _packs(variant: str) -> bool:
    return variant.startswith("packed") or variant.endswith("packed") \
        or variant == "tp_only_packed_kv8"


def _frozen_words_step(cfg, opt_cfg: adamw.AdamWConfig) -> Callable:
    """The train step over a packed tree: the floating leaves get
    ``loss_fn``'s gradients and AdamW, the words stay as they are."""

    def step(params, opt_state, batch):
        flat, tdef = _tree.flatten(params)
        idx = [i for i, t in enumerate(flat)
               if isinstance(t, torch.Tensor) and t.is_floating_point()]
        train = [flat[i].detach().requires_grad_(True) for i in idx]
        full = list(flat)
        for i, t in zip(idx, train):
            full[i] = t
        with deterministic(train[0].device):
            loss = M.loss_fn(_tree.unflatten(tdef, full), cfg, batch)
            grads = torch.autograd.grad(loss, train, allow_unused=True,
                                        materialize_grads=True)
        with torch.no_grad():
            new, opt_state, metrics = adamw.apply_updates(
                [t.detach() for t in train], opt_state, list(grads),
                opt_cfg)
        for i, t in zip(idx, new):
            full[i] = t
        return _tree.unflatten(tdef, full), opt_state, \
            dict(metrics, loss=loss.detach())
    return step


def _float_leaves(params) -> List[torch.Tensor]:
    return [t for t in _tree.leaves(params)
            if isinstance(t, torch.Tensor) and t.is_floating_point()]


def build_cell(arch: str, shape_name: str, variant: str = "baseline",
               cfg=None, shape=None) -> Tuple[Any, Callable, tuple]:
    """(cfg, step, meta args) of one cell; ``cfg`` overrides the cell's
    config (the dry-run passes depth cuts of it), ``shape`` its
    ShapeConfig."""
    if cfg is None:
        cfg = cell_config(arch, shape_name, variant)
    shape = shape or get_shape(shape_name)
    params = M.abstract_params(cfg)
    if _packs(variant):
        params = pack_model_params(params)
    inputs = M.input_specs(cfg, shape)
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        if _packs(variant):
            fn = _frozen_words_step(cfg, opt_cfg)
            opt = adamw.init(_float_leaves(params))
        else:
            fn = make_train_step(cfg, opt_cfg)
            opt = adamw.init(params)
        return cfg, fn, (params, opt, inputs)
    if shape.kind == "prefill":
        def fn(params, batch):
            return M.prefill(params, cfg, batch,
                             cache_capacity=shape.seq_len)
    else:
        def fn(params, batch):
            return M.decode_step(params, cfg, batch)
    return cfg, fn, (params, inputs)


# ------------------------------------------------------------------ #
# depth cuts                                                           #
# ------------------------------------------------------------------ #
def _stacks(cfg) -> Dict[str, Tuple[Tuple[str, ...], int, int]]:
    """{stack: (cycle, n_cycles, n_rem)} of the config's layer stacks."""
    out = {"decoder": find_cycle(M.decoder_pattern(cfg))}
    if cfg.is_encdec:
        out["encoder"] = find_cycle(("full_attn",) * cfg.encoder_layers)
    return out


def cut_depth(cfg, cycles: Dict[str, int]):
    """``cfg`` with each named stack cut to ``cycles[stack]`` cycles,
    its remainder layers kept; raises if the cut changes the cycle."""
    full = _stacks(cfg)
    kw = {}
    for name, k in cycles.items():
        cyc, _, rem = full[name]
        n = k * len(cyc) + rem
        kw["num_layers" if name == "decoder" else "encoder_layers"] = n
    cut = cfg.replace(**kw)
    got = _stacks(cut)
    for name, k in cycles.items():
        cyc, n_full, rem = full[name]
        pat_full = M.decoder_pattern(cfg) if name == "decoder" else None
        if got[name] != (cyc, k, rem) or (
                pat_full is not None and M.decoder_pattern(cut)[k * len(
                    cyc):] != pat_full[n_full * len(cyc):]):
            raise ValueError(f"cutting {name} of {cfg.name} to {k} cycles "
                             f"changes its cycle: {got[name]}")
    return cut


def _tensor_storages(tree) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for t in _tree.leaves(tree):
        if isinstance(t, PackedArray):
            t = t.words
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _nbytes(*trees) -> int:
    seen: Dict[int, int] = {}
    for tr in trees:
        seen.update(_tensor_storages(tr))
    return sum(seen.values())


def _measure(fn: Callable, args: tuple) -> Dict[str, Any]:
    """One counted run: its Cost, peak of live created bytes, output
    bytes and dispatched ops."""
    with op_cost.Counter(scale_loops=True) as c:
        out = fn(*args)
        out_bytes = _nbytes(out)
        peak = c.peak_bytes
    return {"cost": c.cost, "peak": peak, "out": out_bytes, "ops": c.ops,
            "unpriced": dict(c.unpriced)}


def _base_cut(cfg, deep: Dict[str, int]) -> Dict[str, int]:
    """The shallowest cut that keeps every deep stack's cycle: 1 cycle
    a stack where that is still the cycle, else ``BASE_CYCLES``."""
    for k in (1, BASE_CYCLES):
        cut = {s: k for s in deep}
        try:
            cut_depth(cfg, cut)
            cut_depth(cfg, {s: k + 1 for s in deep})
            return cut
        except ValueError:
            continue
    raise ValueError(f"no depth cut of {cfg.name} keeps its cycles")


def step_cost(arch: str, shape_name: str, variant: str = "baseline",
              cfg=None, shape=None) -> Dict[str, Any]:
    """Count one cell: runs at k and k + 1 cycles a stack (k from
    ``_base_cut``; a stack no deeper than that runs whole), scaled to
    the config's cycle counts.  Returns the full config, the walked and
    the scaled Cost, memory and the runs' op counts.  ``cfg`` and
    ``shape`` override the cell's, as in ``build_cell``."""
    if cfg is None:
        cfg = cell_config(arch, shape_name, variant)
    stacks = _stacks(cfg)
    deep = {s: n for s, (_, n, _) in stacks.items() if n > BASE_CYCLES + 1}
    base_cut = _base_cut(cfg, deep)

    def run(cut):
        return _measure(*build_cell(arch, shape_name, variant,
                                    cut_depth(cfg, cut), shape)[1:])
    base = run(base_cut)
    runs = {"base": base}
    for s in deep:
        runs[s] = run(dict(base_cut, **{s: base_cut[s] + 1}))
    trips = {s: n - base_cut[s] for s, n in deep.items()}
    cost2 = op_cost.extrapolate(
        base["cost"], [(runs[s]["cost"], trips[s]) for s in deep])

    def scaled(key):
        return base[key] + sum(trips[s] * (runs[s][key] - base[key])
                               for s in deep)
    return {"cfg": cfg, "cost": base["cost"], "cost2": cost2,
            "peak": scaled("peak"), "out": scaled("out"), "runs": runs,
            "cycles": {s: n for s, (_, n, _) in stacks.items()},
            "walked_cycles": base_cut}


def run_cell(arch: str, shape_name: str, mesh_kind: str = "one_card",
             variant: str = "baseline") -> Dict[str, Any]:
    """The reference's record for one cell (see the module docstring)."""
    if mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r}: the port runs on one card "
                         f"({MESHES})")
    cfg0 = get_arch(arch)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg0, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "variant": variant, "applicable": ok,
    }
    if not ok:
        rec["skip_reason"] = why
        return rec
    t0 = time.time()
    try:
        res = step_cost(arch, shape_name, variant)
        cfg = res["cfg"]
        _, _, args = build_cell(arch, shape_name, variant, cfg)
        rec["memory"] = {
            "argument_size_in_bytes": _nbytes(*args),
            "output_size_in_bytes": int(res["out"]),
            "temp_size_in_bytes": int(res["peak"]),
        }
        c, c2 = res["cost"], res["cost2"]
        rec["cost"] = {"flops": c.flops, "bytes_accessed": c.bytes,
                       "ops": res["runs"]["base"]["ops"],
                       "walked_cycles": res["walked_cycles"]}
        rec["cost2"] = {"flops": c2.flops, "bytes": c2.bytes,
                        "collectives": dict(c2.collectives),
                        "collective_bytes": c2.collective_bytes,
                        "cycles": res["cycles"]}
        rec["collectives"] = dict(c2.collectives,
                                  total=c2.collective_bytes)
        rec["n_params"] = cfg.param_count()
        rec["n_params_active"] = cfg.param_count(active_only=True)
        if torch.cuda.is_available():
            rec["device_total_memory"] = \
                torch.cuda.get_device_properties(0).total_memory
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = time.time() - t0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="one_card", choices=MESHES)
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for a, s in cells:
        rec = run_cell(a, s, args.mesh, args.variant)
        name = f"{a}__{s}__{args.mesh}__{args.variant}.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(rec, f, indent=1)
        status = ("SKIP" if not rec.get("applicable")
                  else "OK" if rec.get("ok") else "FAIL")
        print(f"[{status}] {a} x {s} x {args.mesh} "
              f"({rec.get('wall_s', 0):.1f}s)"
              + (f" :: {rec.get('error', '')}" if status == "FAIL" else ""),
              flush=True)
        failures += status == "FAIL"
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
