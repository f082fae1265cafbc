"""Dry-run: count every (arch x shape x mesh x variant) cell without
allocation — the port's counterpart of ``repro.launch.dryrun``.

The reference jits each cell with ``ShapeDtypeStruct`` stand-ins on 512
fake devices, compiles it, and reads XLA's ``memory_analysis`` and
``cost_analysis``, ``collective_bytes`` of the per-device HLO and
``hlo_cost.analyze`` of it.  The port has no HLO.  Here params and
inputs are meta tensors (``abstract_params`` / ``input_specs``, packed
trees through ``pack_model_params``), the port's own step runs on them
once under ``repro_torch.runtime.op_cost.Counter``, and the record
carries:

  * ``cost`` — the run at the walked depth (k cycles a stack, see
    below), every op it dispatched, a chunk loop under no grad run one
    trip and counted as all of them (``op_cost.scan``);
  * ``cost2`` / ``collectives`` — trip-scaled, the counterpart of
    ``hlo_cost.analyze``: a layer cycle is counted as the difference of
    two runs with k and k + 1 cycles (``op_cost.extrapolate``; it
    prices the cycle's backward, remat recompute, optimizer work and,
    on a mesh, its gathers and reductions with it) and scaled to the
    config's cycle count;
  * ``collectives_static`` — the walked run's collective operand bytes
    by kind, with ``total``: the counterpart of the reference's count
    of the HLO text, which counts a loop body once (0 on one card);
  * ``memory`` in XLA's names — ``argument_size_in_bytes`` (params +
    optimizer state + inputs as this device holds them; their parts in
    ``argument_split``), ``output_size_in_bytes`` (the step's outputs)
    and ``temp_size_in_bytes`` (the peak of live bytes created during
    the step, outputs live at that peak included: torch has no
    donation), the last two extrapolated over the cycles as the cost
    is;
  * ``n_params`` / ``n_params_active`` from ``cfg.param_count``, as the
    reference.

The run needs no card; on a host with one the record adds the card's
``total_memory`` beside the counts.

Meshes.  ``one_card`` runs the one-process steps:
``launch.train.make_train_step`` with ``optim.adamw`` for train (a
packed tree trains its floating leaves and holds the words fixed:
``jax.grad`` refuses integer leaves, so the reference's train x packed
cells fail there), ``model.prefill`` at ``cache_capacity=seq_len``,
``model.decode_step``; ``tp_only_packed_kv8`` keeps its config changes
(packed weights, int8 KV), FSDP off has no meaning on one card.

``single`` (16 x 16, ("data", "model")) and ``multi`` (2 x 16 x 16,
("pod", "data", "model")) are the reference's production meshes, made
real: ``run_cell`` opens torch's fake process group of 256 or 512
ranks (``launch.mesh.fake_world``), builds the ``DeviceMesh`` with
``make_process_mesh(16, pods=)`` and runs rank 0's view of the port's
own SPMD step on meta tensors.  Params are DTensors placed by
``param_specs(..., stacked_prefixes=("decoder", "encoder"))`` (FSDP
off, ``fsdp_axis="__off__"``, for the ``tp_only*`` variants, as the
reference: their weights stay where they are placed), packed words
split as words; the AdamW moments as their params, the step
replicated; the inputs are the rank's blocks by ``batch_specs``.  The
steps run on the params' local blocks (``sharding.tp_blocks``) under
``sharding.tensor_parallel``, as the reference's pjit program does:

  * train — ``launch.train.make_mesh_train_step`` (a packed tree: its
    twin ``_mesh_frozen_words_step``, the words gathered with their
    cycle and never differentiated): every tensor-parallel layer on the
    rank's "model" blocks (heads, d_ff, vocab; the rest whole, gathered
    over "model"), a cycle's FSDP blocks all-gathered over "data" when
    it runs (again in the backward under remat) and freed after, the
    leaves outside the stacks once a step, the grads reduce-scattered
    over "data" to the rank's blocks in the backward, summed over "pod"
    and divided by the batch group's size in float32, MoE's batch
    statistics over the batch group, the global norm, AdamW on the
    rank's blocks;
  * prefill / decode — neither package has a mesh serving path; the
    reference's is the jit inside its dry-run, so the port's is here:
    ``prefill`` / ``decode_step`` on the blocks as train's forward, on
    the rank's rows; the frontend inputs (``frames`` /
    ``image_embeds``, whose d_model ``batch_specs`` splits over
    "model") gathered over "model"; the caches stay in their
    ``batch_specs`` blocks (a rank's kv heads, or its block of slots
    where the kv heads do not divide: split-KV decode combines the
    ranks' partial softmaxes over "model"; the recurrent states'
    channels, gathered for the Mamba / RG-LRU blocks, which compute
    whole, and cut back); the logits gathered over "model" (the
    reference's ``out_shardings`` None).

A batch the batch axes do not divide is replicated over them by
``fit_spec`` (long_500k's batch of 1: every rank computes the same row,
as in the reference).  How the numbers differ from XLA's compiled
program of the reference:

  * flops — a device's dot flops are the global step's over pod x
    data x model where every tensor-parallel dim divides; a layer
    computed whole (heads that do not split, the Mamba and RG-LRU
    channels) and a rank's kv heads read whole cost their share more;
  * temp — one cycle's gathered weights at a time (two under remat's
    recompute in the backward), the grads' float32 copies for the
    reduction, eager activations of the rank's rows;
  * collectives — operand bytes of each c10d op a rank calls: the FSDP
    all-gathers (the rank's block), the grads' reduce-scatters (the
    rank's "model" block of the float32 grad, whole over "data") and
    the all-reduces over "pod" or the batch group of the leaves not
    split over "data", the tensor-parallel all-reduces of the
    row-parallel outputs and of the column-parallel inputs' gradients,
    the vocab-parallel loss's max and sums, the norm and MoE's two
    means; a gather over two mesh dims is two all-gathers;
  * bytes — eager: every op a materialisation boundary, an upper bound
    of a fused program's; a cache insert clones the leaf where XLA
    writes in place.

A fake group's collectives leave their outputs as they were: the
counts are right, the values are not (meta tensors have none).

  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape \\
      train_4k --variant baseline --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all --variant packed
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape \\
      decode_32k --mesh both --variant packed      # single and multi
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch import tree as _tree
from repro_torch.configs import (ARCHS, SHAPES, get_arch, get_shape,
                                 shape_applicable)
from repro_torch.kernels.packed import PackedArray
from repro_torch.launch import train as T
from repro_torch.launch.mesh import fake_world, make_process_mesh, rules_mesh
from repro_torch.models import model as M
from repro_torch.models.quantize import pack_model_params
from repro_torch.models.transformer import find_cycle
from repro_torch.optim import adamw
from repro_torch.runtime import op_cost
from repro_torch.runtime import sharding as shd

__all__ = ["MESHES", "VARIANTS", "WORLDS", "build_cell", "cell_config",
           "cut_depth", "main", "place_cell", "production_mesh", "run_cell",
           "step_cost"]

VARIANTS = ("baseline", "remat_none", "remat_dots", "packed",
            "moe_capacity", "moe_gather", "kv_int8", "tp_only_packed_kv8",
            "big_chunks", "remat_dots_big_chunks", "packed_moe_capacity")
MESHES = ("one_card", "single", "multi")
WORLDS = {"single": 256, "multi": 512}     # ranks of the production meshes
BASE_CYCLES = 2        # the deepest base cut (k cycles, then k + 1)
FIT_BYTES = 80e9       # a card's memory: the CLI counts the cells over it


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


def _is_float(t: Any) -> bool:
    """A floating leaf (a ``sharding.Block``'s by its local block)."""
    t = getattr(t, "local", t)
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _frozen_loss_and_grads(params, cfg, batch):
    """(loss, grads) of a packed tree: ``loss_fn``'s gradients of the
    floating leaves, None in place of every words leaf (held fixed)."""
    flat, tdef = _tree.flatten(params)
    idx = [i for i, t in enumerate(flat) if _is_float(t)]
    train = [flat[i].detach().requires_grad_(True) for i in idx]
    full = list(flat)
    for i, t in zip(idx, train):
        full[i] = t
    local = [getattr(t, "local", t) for t in train]
    with T.deterministic(local[0].device):
        loss = M.loss_fn(_tree.unflatten(tdef, full), cfg, batch)
        grads = torch.autograd.grad(loss, local, allow_unused=True,
                                    materialize_grads=True)
    out: List[Any] = [None] * len(flat)
    for i, g in zip(idx, grads):
        out[i] = g
    return loss.detach(), _tree.unflatten(tdef, out)


def _frozen_words_step(cfg, opt_cfg: adamw.AdamWConfig) -> Callable:
    """The train step over a packed tree: the floating leaves get
    ``loss_fn``'s gradients and AdamW, the words stay as they are."""

    def step(params, opt_state, batch):
        loss, grads = _frozen_loss_and_grads(params, cfg, batch)
        flat, tdef = _tree.flatten(params)
        idx = [i for i, t in enumerate(flat) if _is_float(t)]
        with torch.no_grad():
            new, opt_state, metrics = adamw.apply_updates(
                [flat[i] for i in idx], opt_state, _tree.leaves(grads),
                opt_cfg)
        for i, t in zip(idx, new):
            flat[i] = t
        return _tree.unflatten(tdef, flat), opt_state, \
            dict(metrics, loss=loss)
    return step


def _mesh_frozen_words_step(cfg, opt_cfg: adamw.AdamWConfig,
                            mesh) -> Callable:
    """``_frozen_words_step`` on ``mesh``, the twin of
    ``make_mesh_train_step``: ``mesh_loss_and_grads`` on the rank's
    blocks (words too: gathered over "data" with their cycle, never
    differentiated), the floating leaves' grads as their blocks, AdamW
    on them; the words DTensors stay as they are.  Every rank of the
    mesh calls it (it makes the batch group)."""
    groups = shd.tp_groups(mesh)

    def step(params, opt_state, batch):
        loss, grads = T.mesh_loss_and_grads(
            params, cfg, batch, groups, grads_of=_frozen_loss_and_grads)
        flat, tdef = _tree.flatten(params)
        idx = [i for i, t in enumerate(flat) if _is_float(t)]
        blocks = _tree.leaves(grads)
        del grads
        new, opt_state, metrics = T.mesh_apply_updates(
            [flat[i] for i in idx], opt_state, blocks, opt_cfg)
        for i, t in zip(idx, new):
            flat[i] = t
        return _tree.unflatten(tdef, flat), opt_state, \
            dict(metrics, loss=loss)
    return step


def _float_leaves(params) -> List[torch.Tensor]:
    return [t for t in _tree.leaves(params) if _is_float(t)]


# ------------------------------------------------------------------ #
# the mesh steps' inputs                                               #
# ------------------------------------------------------------------ #
def _is_spec(x: Any) -> bool:
    return isinstance(x, shd.P)


def _model_dim(spec: shd.P) -> Optional[int]:
    """The tensor dim that ``spec`` splits over "model", or None."""
    for d, entry in enumerate(spec):
        if "model" in shd._axes_of(entry):
            return d
    return None


def _gather_model(batch: Any, specs: Any, mesh) -> Any:
    """The rank's frontend inputs (``frames`` / ``image_embeds``, whose
    d_model ``batch_specs`` splits over "model") gathered over "model"
    (an all-gather over the mesh's "model" dim); the batch-axis splits
    stay, and the caches stay in their blocks."""
    from torch.distributed.tensor import DTensor, Replicate
    m = tuple(mesh.mesh_dim_names).index("model")

    def one(x, spec):
        d = _model_dim(spec)
        if d is None:
            return x
        pl = shd.placements(spec, mesh)
        keep = list(pl)
        keep[m] = Replicate()
        return DTensor.from_local(x, mesh, pl, run_check=False) \
            .redistribute(mesh, keep).to_local()
    return {k: v if k == "caches" else
            _tree.map(one, v, specs[k], is_leaf=_is_spec)
            for k, v in batch.items()}


def place_cell(cfg, shape, variant: str, mesh, params: Any,
               inputs: Any) -> Tuple[Callable, tuple]:
    """(step, args) of a cell on the ``DeviceMesh`` ``mesh`` from whole
    ``params`` and ``inputs`` (meta or real, equal on every rank): the
    params placed by ``param_specs`` (``fsdp_axis="__off__"`` for the
    ``tp_only*`` variants), the AdamW moments as their params, the
    inputs cut to this rank's ``batch_specs`` blocks; the step as the
    module docstring says."""
    fsdp = "__off__" if variant.startswith("tp_only") else "data"
    p_shard, o_shard = T.shardings(params, mesh, fsdp_axis=fsdp)
    placed = shd.distribute(params, p_shard)
    b_specs = shd.batch_specs(inputs, rules_mesh(mesh))
    rows = shd.distribute(inputs, shd.named(b_specs, mesh))
    rows = _tree.map(lambda d: d.to_local(), rows)
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        if _packs(variant):
            f_shard = [s for t, s in zip(_tree.leaves(params),
                                         _tree.leaves(p_shard))
                       if _is_float(t)]
            opt = shd.distribute(
                adamw.init(_float_leaves(params)),
                adamw.OptState(o_shard.step, f_shard, f_shard))
            step = _mesh_frozen_words_step(cfg, opt_cfg, mesh)
        else:
            opt = shd.distribute(adamw.init(params), o_shard)
            step = T.make_mesh_train_step(cfg, opt_cfg, mesh)

        def fn(params, opt_state, batch):
            return step(params, opt_state,
                        _gather_model(batch, b_specs, mesh))
        return fn, (placed, opt, rows)
    groups = shd.tp_groups(mesh)

    def fn(params, batch):
        with torch.no_grad(), shd.tensor_parallel(groups):
            blocks = shd.tp_blocks(params, cfg)
            batch = _gather_model(batch, b_specs, mesh)
            if shape.kind == "prefill":
                return M.prefill(blocks, cfg, batch,
                                 cache_capacity=shape.seq_len)
            return M.decode_step(blocks, cfg, batch)
    return fn, (placed, rows)


def build_cell(arch: str, shape_name: str, variant: str = "baseline",
               cfg=None, shape=None, mesh=None
               ) -> Tuple[Any, Callable, tuple]:
    """(cfg, step, meta args) of one cell; ``cfg`` overrides the cell's
    config (the dry-run passes depth cuts of it), ``shape`` its
    ShapeConfig; ``mesh`` a ``DeviceMesh`` places the cell on it
    (``place_cell``), None is one card."""
    if cfg is None:
        cfg = cell_config(arch, shape_name, variant)
    shape = shape or get_shape(shape_name)
    params = M.abstract_params(cfg)
    if _packs(variant):
        params = pack_model_params(params)
    inputs = M.input_specs(cfg, shape)
    if mesh is not None:
        return (cfg, *place_cell(cfg, shape, variant, mesh, params, inputs))
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        if _packs(variant):
            fn = _frozen_words_step(cfg, opt_cfg)
            opt = adamw.init(_float_leaves(params))
        else:
            fn = T.make_train_step(cfg, opt_cfg)
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
            # a DTensor as the block this rank holds
            t = getattr(t, "_local_tensor", t)
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


def _base_cut(cfg, deep: Dict[str, int], least: int = 1) -> Dict[str, int]:
    """The shallowest cut of at least ``least`` cycles that keeps every
    deep stack's cycle: 1 cycle a stack where that is still the cycle,
    else ``BASE_CYCLES``."""
    for k in range(least, BASE_CYCLES + 1):
        cut = {s: k for s in deep}
        try:
            cut_depth(cfg, cut)
            cut_depth(cfg, {s: k + 1 for s in deep})
            return cut
        except ValueError:
            continue
    raise ValueError(f"no depth cut of {cfg.name} keeps its cycles")


def step_cost(arch: str, shape_name: str, variant: str = "baseline",
              cfg=None, shape=None, mesh=None) -> Dict[str, Any]:
    """Count one cell: runs at k and k + 1 cycles a stack (k from
    ``_base_cut``; a stack no deeper than that runs whole), scaled to
    the config's cycle counts.  Returns the full config, the walked and
    the scaled Cost, memory and the runs' op counts.  ``cfg``,
    ``shape`` and ``mesh`` as in ``build_cell``: on a mesh each cut is
    placed anew, so a cycle's gathers and reductions scale with it; k
    is at least 2 there (a stacked leaf of one cycle is gathered over a
    dim after the first without the concatenation more cycles need)."""
    if cfg is None:
        cfg = cell_config(arch, shape_name, variant)
    stacks = _stacks(cfg)
    deep = {s: n for s, (_, n, _) in stacks.items() if n > BASE_CYCLES + 1}
    base_cut = _base_cut(cfg, deep, least=1 if mesh is None else 2)

    def run(cut):
        return _measure(*build_cell(arch, shape_name, variant,
                                    cut_depth(cfg, cut), shape, mesh)[1:])
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


def production_mesh(mesh_kind: str):
    """The reference's production mesh as a ``DeviceMesh`` over the
    initialised (fake) process group of ``WORLDS[mesh_kind]`` ranks:
    ("data", "model") = (16, 16) or ("pod", "data", "model") =
    (2, 16, 16)."""
    return make_process_mesh(16, pods=2 if mesh_kind == "multi" else 1,
                             device="cpu")


@contextlib.contextmanager
def _world(n: int) -> Iterator[None]:
    """A fake world of ``n`` ranks for the block: the process's own if
    it already runs one of that size, else ``fake_world(n)``."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake" \
            and dist.get_world_size() == n:
        yield
        return
    with fake_world(n):
        yield


def _with_total(collectives: Dict[str, float]) -> Dict[str, float]:
    return dict(collectives, total=float(sum(collectives.values())))


def run_cell(arch: str, shape_name: str, mesh_kind: str = "one_card",
             variant: str = "baseline") -> Dict[str, Any]:
    """The reference's record for one cell (see the module docstring);
    on ``single`` / ``multi`` rank 0's view, with ``mesh_shape`` and
    ``rank`` added."""
    if mesh_kind not in MESHES:
        raise ValueError(f"mesh {mesh_kind!r}: the dry-run runs on one card "
                         f"or on a production mesh, {MESHES}")
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
        with contextlib.ExitStack() as stack:
            dm = None
            if mesh_kind != "one_card":
                import torch.distributed as dist
                stack.enter_context(_world(WORLDS[mesh_kind]))
                dm = production_mesh(mesh_kind)
                rec["mesh_shape"] = dict(zip(dm.mesh_dim_names, dm.shape))
                rec["rank"] = dist.get_rank()
            res = step_cost(arch, shape_name, variant, mesh=dm)
            cfg = res["cfg"]
            _, _, args = build_cell(arch, shape_name, variant, cfg, mesh=dm)
        split = dict(zip(("params", "opt_state", "inputs")
                         if len(args) == 3 else ("params", "inputs"),
                         (_nbytes(a) for a in args)))
        rec["memory"] = {
            "argument_size_in_bytes": _nbytes(*args),
            "output_size_in_bytes": int(res["out"]),
            "temp_size_in_bytes": int(res["peak"]),
            "argument_split": split,
        }
        c, c2 = res["cost"], res["cost2"]
        rec["cost"] = {"flops": c.flops, "bytes_accessed": c.bytes,
                       "ops": res["runs"]["base"]["ops"],
                       "walked_cycles": res["walked_cycles"]}
        rec["cost2"] = {"flops": c2.flops, "bytes": c2.bytes,
                        "collectives": dict(c2.collectives),
                        "collective_bytes": c2.collective_bytes,
                        "cycles": res["cycles"]}
        rec["collectives_static"] = _with_total(c.collectives)
        rec["collectives"] = _with_total(c2.collectives)
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
    ap.add_argument("--mesh", default="one_card",
                    choices=("one_card", "single", "multi", "both"))
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    seen = {"OK": 0, "SKIP": 0, "FAIL": 0}
    over = []
    for a, s in cells:
        for mk in meshes:
            rec = run_cell(a, s, mk, args.variant)
            name = f"{a}__{s}__{mk}__{args.variant}.json"
            with open(os.path.join(args.out, name), "w") as f:
                json.dump(rec, f, indent=1)
            status = ("SKIP" if not rec.get("applicable")
                      else "OK" if rec.get("ok") else "FAIL")
            held = ""
            if status == "OK":
                mem = rec["memory"]
                nb = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                held = f", argument + temp {nb / 1e9:.2f} GB"
                if nb > FIT_BYTES:
                    over.append(f"{a} x {s} x {mk}")
            print(f"[{status}] {a} x {s} x {mk} "
                  f"({rec.get('wall_s', 0):.1f}s{held})"
                  + (f" :: {rec.get('error', '')}" if status == "FAIL"
                     else ""), flush=True)
            seen[status] += 1
    print(f"{seen['OK']} ok, {seen['SKIP']} skipped, {seen['FAIL']} failed; "
          f"argument + temp over {FIT_BYTES / 1e9:g} GB a device: "
          f"{len(over)} of {seen['OK']}" + (f" ({'; '.join(over)})"
                                            if over else ""), flush=True)
    return 1 if seen["FAIL"] else 0


if __name__ == "__main__":
    sys.exit(main())
