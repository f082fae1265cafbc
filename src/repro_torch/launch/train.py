"""Fault-tolerant LLM trainer — the port of
``repro.launch.train``.

The deterministic token stream (``repro_torch.data``) -> one eager
train step (``loss_fn`` and its gradients by ``torch.autograd``, then
AdamW on the latent binarized weights) -> async atomic checkpoints
(``repro_torch.checkpoint``: params, opt state, the data cursor) ->
auto-resume.

Fault tolerance contract (``tests/test_torch_llm_train.py``,
``tests/test_torch_spmd.py``, and ``chip_smoke.py`` on the card at
qwen1.5-0.5b's published config): kill the process at any step;
rerunning with the same ``ckpt_dir`` resumes from the latest complete
checkpoint and reproduces exactly the step sequence an uninterrupted
run would have produced; restore re-shards onto whatever mesh the new
run has (elastic: the world size may change between runs).  A
step-time watchdog records straggler events.

SPMD training (``mesh=`` a ``torch.distributed`` ``DeviceMesh``, e.g.
``launch.mesh.make_process_mesh()``, one process a rank): params and
the AdamW moments are DTensors placed by ``runtime.sharding.
param_specs(..., stacked_prefixes=("decoder", "encoder"))``, as the
reference places them; the step counter is replicated.  Each rank reads
its share of the token stream (its coordinate on ("pod", "data"); ranks
that differ only on "model" read the same rows).  A step
(``make_mesh_train_step``) is the reference's pjit step written out
(Megatron-style tensor parallelism on plain local tensors, no DTensor
propagation through the forward): each rank computes every
tensor-parallel layer on its "model" block of the weights (attention
heads, the FFN's and the experts' d_ff, the vocab of the embedding and
the logits), a layer cycle's FSDP blocks are all-gathered over "data"
when the cycle runs (again in the backward under remat) and freed
after, the leaves outside the stacks once a step, and the gradients
leave the backward reduce-scattered over "data" to the rank's blocks,
summed over "pod" and divided by the batch group's size in float32.
A leaf a layer cannot use as a block (heads that do not split over
"model", the Mamba / RG-LRU in_proj and gate_proj, whose two halves
each rank reads its channels of) is gathered over "model".  MoE's batch statistics are global
(``sharding.global_batch``), the loss is mean-reduced over the batch
group, the global grad norm counts each element once, and AdamW runs
on the rank's own blocks.  With one rank on each axis every helper is
the identity: a world-1 mesh runs the one-process step's ops.
``mesh=None`` is the one-process path.

``train`` runs on the card unless the caller passes ``device="cpu"``
(a mesh's device type must be the same); it never falls back to the
CPU.  Bit-identical resume on the card needs a deterministic step: the
embedding lookup's backward (the tied embedding is read twice), the
target-logit gather's and MoE's scatters add with atomics unless
``torch.use_deterministic_algorithms(True)``, which the step runs
under (restored afterwards).  On the card that mode needs
``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS makes its first handle:
``train`` and ``make_train_step`` set ``:4096:8`` when it is unset and
raise when it holds another value, on every rank (ROADMAP hazard 12).

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
        --steps 20 --batch 8 --seq 64 [--device cpu]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
        --steps 20 --batch 8 --seq 64 --device cpu
        # gloo, world 4: (data, model) = (4, 1), as the reference's CLI;
        # tensor parallelism: train(..., mesh=make_process_mesh(model=2))
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as _tree
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_arch, reduced
from repro_torch.data import DataConfig, DataIterator
from repro_torch.kernels.packed import resolve_device
from repro_torch.launch.mesh import make_process_mesh, rules_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.straggler import StepWatchdog

__all__ = ["deterministic", "loss_and_grads", "main", "make_mesh_train_step",
           "make_train_step", "mesh_apply_updates", "mesh_loss_and_grads",
           "shardings", "train"]

STACKED = ("decoder", "encoder")   # the reference's stacked_prefixes

CUBLAS_CONFIGS = (":4096:8", ":16:8")   # cuBLAS's deterministic settings


def _deterministic_cublas() -> None:
    """Make cuBLAS deterministic for this process, or raise."""
    got = os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIGS[0])
    if got not in CUBLAS_CONFIGS:
        raise RuntimeError(
            f"CUBLAS_WORKSPACE_CONFIG={got!r}: deterministic training on "
            f"the card needs one of {CUBLAS_CONFIGS}")


@contextlib.contextmanager
def deterministic(device: torch.device):
    """``torch.use_deterministic_algorithms(True)`` (and TF32 off) for
    the block, the previous settings restored on exit."""
    if device.type == "cuda":
        _deterministic_cublas()
    was = torch.are_deterministic_algorithms_enabled()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def loss_and_grads(params: Any, cfg, batch: Dict[str, torch.Tensor]):
    """(loss, grads): ``loss_fn`` and one autograd pass over every
    param leaf, deterministic; a leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives.  A ``sharding.Block`` leaf (an
    SPMD step's) is differentiated at its local block."""
    flat, treedef = _tree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    local = [getattr(p, "local", p) for p in leaves]
    with deterministic(local[0].device):
        loss = M.loss_fn(_tree.unflatten(treedef, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, local, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), _tree.unflatten(treedef, list(grads))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig):
    """The step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss and grads, then AdamW (every leaf clamped to
    [-1, 1], as the reference's default); metrics ``loss``,
    ``grad_norm``, ``lr``."""

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        with torch.no_grad():
            params, opt_state, metrics = adamw.apply_updates(
                params, opt_state, grads, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss)
    return step


# ------------------------------------------------------------------ #
# SPMD over a DeviceMesh                                               #
# ------------------------------------------------------------------ #
def shardings(params: Any, mesh: Any, fsdp_axis: str = "data"
              ) -> Tuple[Any, adamw.OptState]:
    """(params', opt state's) ``MeshSharding`` trees on ``mesh``: the
    reference's ``param_specs(..., stacked_prefixes=("decoder",
    "encoder"), fsdp_axis=)``, the moments as their params, the step
    replicated."""
    specs = shd.param_specs(params, rules_mesh(mesh), stacked_prefixes=STACKED,
                            fsdp_axis=fsdp_axis)
    p_shard = shd.named(specs, mesh)
    return p_shard, adamw.OptState(step=shd.MeshSharding(mesh, shd.P()),
                                   m=p_shard, v=p_shard)


def _mean_over(t: torch.Tensor, group: Any, size: int) -> torch.Tensor:
    """The mean of ``t`` over the ``size`` members of ``group``, summed
    in float32, in ``t``'s dtype."""
    if size == 1:
        return t
    x = t.to(torch.float32, copy=True)
    dist.all_reduce(x, group=group)
    return (x / size).to(t.dtype)


def mesh_loss_and_grads(params: Any, cfg, batch: Dict[str, torch.Tensor],
                        groups: shd.TPGroups, grads_of=loss_and_grads):
    """(loss, grads) of the global batch from DTensor ``params`` and
    this rank's rows, the grads as this rank's blocks (in leaf order, a
    plain tensor each).  ``grads_of`` (``loss_and_grads``) runs on the
    params' local blocks (``sharding.tp_blocks``) under
    ``sharding.tensor_parallel(groups)``, with MoE's batch statistics
    over the batch group: each layer computes on its "model" blocks, a
    cycle's leaves are gathered over "data" when it runs, and each
    leaf's gradient leaves the backward summed over the batch group
    (reduce-scattered over "data", then over "pod") and divided by its
    size, in float32.  The loss is mean-reduced over the batch group."""
    blocks = shd.tp_blocks(params, cfg)
    with shd.tensor_parallel(groups), \
            shd.global_batch(groups.batch, groups.batch_size):
        loss, grads = grads_of(blocks, cfg, batch)
    return _mean_over(loss, groups.batch, groups.batch_size), grads


def _global_norm(blocks, like) -> torch.Tensor:
    """The global norm of a gradient held as one block per rank (the
    blocks of the DTensors ``like``): each rank sums the squares of the
    blocks it holds the first copy of, leaf by leaf, and the sums are
    added over the mesh, so each element counts once."""
    total = None
    for g, p in zip(blocks, like):
        if shd.holds_first_copy(p):
            sq = torch.sum(torch.square(g.to(torch.float32)))
            total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=blocks[0].device)
    dist.all_reduce(total)
    return torch.sqrt(total)


def _from_local(x: torch.Tensor, like: Any) -> Any:
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def make_mesh_train_step(cfg, opt_cfg: adamw.AdamWConfig, mesh):
    """The SPMD step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``mesh``: DTensor params and opt state (``shardings``),
    ``batch`` this rank's rows.  ``mesh_loss_and_grads`` (the grads
    arrive as the rank's blocks), the global norm (``_global_norm``),
    then AdamW on the rank's blocks; metrics as ``make_train_step``'s.
    Every rank of the mesh calls it (it makes the batch group)."""
    groups = shd.tp_groups(mesh)

    def step(params, opt_state, batch):
        loss, grads = mesh_loss_and_grads(params, cfg, batch, groups)
        blocks = _tree.leaves(grads)
        del grads
        params, opt_state, metrics = mesh_apply_updates(
            params, opt_state, blocks, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss)
    return step


def mesh_apply_updates(params: Any, opt_state: adamw.OptState,
                       blocks: List[torch.Tensor], opt_cfg: adamw.AdamWConfig):
    """AdamW on this rank's blocks: ``blocks`` holds each leaf's
    gradient as the block its DTensor param holds here
    (``mesh_loss_and_grads``'), in leaf order; the global norm
    (``_global_norm``), AdamW on the blocks of ``params`` and
    ``opt_state``, and the results placed as the params.  Returns
    ``(params, opt_state, metrics)``."""
    flat_p, tdef = _tree.flatten(params)
    with torch.no_grad():
        gn = _global_norm(blocks, flat_p)
        local = [_tree.unflatten(tdef, [x.to_local() for x in
                                        _tree.leaves(t)])
                 for t in (opt_state.m, opt_state.v)]
        new_p, new_o, metrics = adamw.apply_updates(
            _tree.unflatten(tdef, [p.to_local() for p in flat_p]),
            adamw.OptState(opt_state.step.to_local(), *local),
            _tree.unflatten(tdef, blocks), opt_cfg, grad_norm=gn)

    def place(t):
        return _tree.unflatten(tdef, [_from_local(x, p) for x, p in
                                      zip(_tree.leaves(t), flat_p)])
    opt_state = adamw.OptState(_from_local(new_o.step, opt_state.step),
                               place(new_o.m), place(new_o.v))
    return place(new_p), opt_state, metrics


def _mesh_device(mesh: Any, device: Any) -> torch.device:
    """The device a mesh run trains on, or raise: ``mesh`` must be a
    ``DeviceMesh`` over the whole default process group whose device
    type is ``device``'s (None: the card)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be None or a torch.distributed "
                        f"DeviceMesh (launch.mesh.make_process_mesh), not "
                        f"{type(mesh).__name__}")
    want = torch.device("cuda" if device is None else device)
    if mesh.device_type != want.type:
        raise ValueError(f"the mesh's device type {mesh.device_type!r} is "
                         f"not the device {want.type!r} (None means the "
                         f"card)")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh has {mesh.size()} ranks, the default "
                         f"process group {dist.get_world_size()}")
    return resolve_device(device)


# ------------------------------------------------------------------ #
# the trainer                                                          #
# ------------------------------------------------------------------ #
def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
          lr: float = 3e-4, mesh=None, device=None, seed: int = 0,
          log_every: int = 5, log_fn=print,
          run_steps: Optional[int] = None) -> Dict[str, Any]:
    """Train ``cfg`` on the token stream on ``device`` (None = the
    card), in one process or, with ``mesh`` a ``DeviceMesh``, SPMD on
    every rank of it (every rank calls this alike; only rank 0 logs).
    run_steps: execute at most this many steps this invocation
    (simulated preemption — the schedule horizon stays ``steps``)."""
    dev = resolve_device(device) if mesh is None else \
        _mesh_device(mesh, device)
    shard, n_shards = (0, 1) if mesh is None else shd.batch_shard(mesh)
    if global_batch % n_shards:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"the mesh's {n_shards} batch shards")
    if dev.type == "cuda":
        _deterministic_cublas()
    if mesh is not None and dist.get_rank() != 0:
        log_fn = _quiet
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=max(steps, 2),
                                warmup_steps=max(2, steps // 10))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    # drawn on the host: one seed gives the same params on any device
    # and on every rank, which keeps its own blocks of them
    params = M.init_params(torch.Generator().manual_seed(seed), cfg, dev)
    opt_state = adamw.init(params)
    places = None
    if mesh is not None:
        places = shardings(params, mesh)
        params, opt_state = shd.distribute((params, opt_state), places)

    start_step = 0
    data = DataIterator(dcfg, shard=shard, n_shards=n_shards)
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        (params, opt_state), meta = restore(ckpt_dir, (params, opt_state),
                                            shardings=places)
        start_step = int(meta["extra"]["step"])
        data = DataIterator.from_state(dcfg, meta["extra"]["data"],
                                       shard=shard, n_shards=n_shards)
        log_fn(f"[resume] from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg) if mesh is None else \
        make_mesh_train_step(cfg, opt_cfg, mesh)
    wd = StepWatchdog()
    losses = []
    end = steps if run_steps is None else min(steps, start_step + run_steps)
    for it in range(start_step, end):
        batch = {k: torch.from_numpy(v).to(dev).long()
                 for k, v in next(data).items()}
        wd.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        slow = wd.stop()
        losses.append(loss)
        if it % log_every == 0 or it == steps - 1:
            log_fn(f"step {it:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f}"
                   + (" [straggler]" if slow else ""))
        if ckpt and ((it + 1) % ckpt_every == 0 or it == end - 1):
            ckpt.save(it + 1, (params, opt_state),
                      extra={"step": it + 1, "data": data.state_dict()})
    if ckpt:
        ckpt.wait()
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "straggler_events": wd.flags}


def _quiet(*_: Any) -> None:
    """The log of a rank other than 0."""


def main(argv=None):
    """The CLI.  Under ``torch.distributed.run`` (``WORLD_SIZE`` set)
    every rank joins the default process group (NCCL on the card, gloo
    with ``--device cpu``) and trains SPMD on ``make_process_mesh()``,
    every rank on "data" (the reference's ``make_local_mesh()``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg).replace(dtype="float32")
    kw = dict(steps=args.steps, global_batch=args.batch, seq_len=args.seq,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr,
              seed=args.seed, device=args.device)
    spmd = "WORLD_SIZE" in os.environ
    if spmd:
        cpu = torch.device(args.device or "cuda").type == "cpu"
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl")
    try:
        out = train(cfg, mesh=make_process_mesh(device=args.device)
                    if spmd else None, **kw)
    finally:
        if spmd:
            dist.destroy_process_group()
    if spmd and int(os.environ.get("RANK", 0)) != 0:
        return out
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return out


if __name__ == "__main__":
    main()
