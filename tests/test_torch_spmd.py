"""SPMD training over a ``torch.distributed`` ``DeviceMesh``
(``repro_torch.launch.train.train(mesh=...)``) and the elastic
checkpoint restore, on the CPU with gloo ranks.

The rank programs live in this file and run as ``python
tests/test_torch_spmd.py <job> <dir>``: each job spawns its gloo ranks
(a ``file://`` init under the test's tmp dir, a 60 s process-group
timeout) and the test gives the whole job a hard deadline, so a hung
collective fails its test.  Their top level imports only numpy, torch
and pytest; the reference's job imports jax after setting 4 forced host
devices, as ``tests/test_runtime.py::test_elastic_reshard_subprocess``
does.

* Placement: every rank's ``to_local()`` block of every param leaf
  equals the block ``NamedSharding.blocks`` gives its coordinates under
  ``param_specs(..., ("decoder", "encoder"))``, on the (4, 1), (2, 2),
  (1, 4) and (2, 1, 2) meshes, for qwen1.5-0.5b, mixtral-8x22b and
  whisper-large-v3 reduced; a dim split over ("pod", "data") gives
  DTensor's block and ``NamedSharding.blocks``' the same.
* Against the one-process port, at world 4: the tensor-parallel step's
  loss within ``LOSS_TOL`` and its grads (the rank's reduce-scattered
  blocks, gathered whole) within ``GRAD_TOL`` x max|g| of
  ``loss_and_grads`` on the same global batch, all ten reduced
  archs on (2, 2) (MoE's aux loss over the global batch) and qwen on
  (4, 1) and (1, 4); the params after one step within ``PARAM_TOL`` x
  max|p| but for counted elements (``step_close``); ``train(mesh=)``'s
  first step likewise.
* Against the reference's own sharded step: qwen reduced (2 layers,
  float32) under ``jax.jit`` with ``param_specs`` shardings on a (2, 2)
  mesh of forced host devices; the port's (2, 2) step from the same
  params (``convert.params_from_numpy``).  ``compressed_psum`` over 4
  gloo ranks against the reference's ``shard_map`` on 4 devices.
* Resume: a world-4 run cut by ``run_steps`` and resumed equals its own
  uninterrupted run bit for bit.  Elastic: the world-4 checkpoint reads
  back at worlds 2 and 1, and without ``shardings=``, bit for bit; a
  one-process checkpoint reads back onto a mesh; the world-2 resume
  continues within ``step_close``.
* Entry points: ``make_process_mesh()`` and ``train(mesh=...)`` raise
  with no card and no ``device="cpu"``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_spmd.py
"""
import datetime
import json
import os
import pickle
import signal
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 300        # seconds a job may take, its spawns included
PG_TIMEOUT = 60       # seconds a collective may wait
LOSS_TOL = 1e-5       # relative
GRAD_TOL = 1e-5       # x max|g| of each leaf
PARAM_TOL = 1e-4      # x max|p| of each leaf
# AdamW's first step moves an element by lr x g / (|g| + eps): where g is
# within GRAD_TOL x max|g| of zero, a rounding difference of the sum
# (split over ranks in one run, not in the other) can flip its sign and
# move the element by up to 2 lr; where |g| is within EPS_ZONE (100 x
# AdamW's eps of 1e-8), the eps term turns a relative difference of g
# into one of the step.  Such elements are counted and held to STEP_FLIPS of a
# leaf (plus a few for the smallest leaves).
STEP_FLIPS = 1e-3
EPS_ZONE = 1e-6
LR = 1e-3
B, S = 4, 16          # the global batch of the one-step gates
ARCH_IDS = ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b", "command-r-plus-104b",
            "command-r-35b", "internlm2-20b", "qwen1.5-0.5b",
            "recurrentgemma-2b", "whisper-large-v3", "llama-3.2-vision-11b",
            "falcon-mamba-7b"]
PLACED = ("qwen1.5-0.5b", "mixtral-8x22b", "whisper-large-v3")
SHAPES = {"4x1": (4, 1), "2x2": (2, 2), "1x4": (1, 4), "2x1x2": (2, 1, 2)}
STEP_CASES = [(a, "2x2") for a in ARCH_IDS] + [("qwen1.5-0.5b", "4x1"),
                                               ("qwen1.5-0.5b", "1x4")]
RUN = dict(steps=4, global_batch=4, seq_len=16, ckpt_every=2, lr=LR,
           log_every=1)
CUT = 2


# ------------------------------------------------------------------ #
# shared by the ranks and the tests                                    #
# ------------------------------------------------------------------ #
def cfg_of(arch, **kw):
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch(arch)).replace(dtype="float32", **kw)


def resume_cfg():
    return cfg_of("qwen1.5-0.5b", num_layers=2)


def opt_cfg():
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=LR, total_steps=10, warmup_steps=2)


def init(arch):
    from repro_torch.models import model as M
    return M.init_params(torch.Generator().manual_seed(0), cfg_of(arch),
                         "cpu")


def global_batch(cfg, seed=5):
    """A numpy-seeded batch of B rows (+ Whisper frames / image
    embeddings), int64 tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision_patches":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def rows(batch, shard, n):
    per = B // n
    return {k: v[shard * per:(shard + 1) * per] for k, v in batch.items()}


def full(tree_):
    """Every leaf whole (a DTensor gathered: every rank calls this)."""
    from repro_torch import tree
    return [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in tree.leaves(tree_)]


def whole_grads(grads, like):
    """The mesh step's gradient blocks (one a leaf, in leaf order) as
    whole tensors: each placed as its DTensor param ``like`` and
    gathered (every rank calls this)."""
    from repro_torch import tree
    from repro_torch.launch import train as T
    return [T._from_local(g, p).full_tensor()
            for g, p in zip(tree.leaves(grads), tree.leaves(like))]


def psum_inputs(rank, n=1500):
    rng = np.random.default_rng(100 + rank)
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    x[::97] = 0.0
    e = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    return x, e


# ------------------------------------------------------------------ #
# the rank programs                                                    #
# ------------------------------------------------------------------ #
def _join(rank, world, out, job):
    """Join ``job``'s gloo group of ``world`` ranks (a store file of its
    own: a file store is not reused)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out}/pg_{job}_{world}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT))


def _mesh(shape):
    from repro_torch.launch.mesh import make_process_mesh
    if len(shape) == 3:
        return make_process_mesh(model=shape[2], pods=shape[0],
                                 device="cpu")
    return make_process_mesh(model=shape[1], device="cpu")


def _placement(rank, report):
    """Each leaf's local block against NamedSharding.blocks at this
    rank's coordinates, on every mesh shape and placed arch."""
    from repro_torch import tree
    from repro_torch.launch.mesh import Mesh, rules_mesh
    from repro_torch.launch.train import shardings
    from repro_torch.runtime import sharding as shd
    for key, shape in SHAPES.items():
        dm = _mesh(shape)
        slots = Mesh(np.array([torch.device("cpu")] * dm.size(),
                              dtype=object).reshape(shape),
                     dm.mesh_dim_names)
        me = int(np.ravel_multi_index(dm.get_coordinate(), shape))
        for arch in PLACED:
            params = init(arch)
            p_shard, _ = shardings(params, dm)
            placed = shd.distribute(params, p_shard)
            specs = shd.param_specs(params, rules_mesh(dm),
                                    stacked_prefixes=("decoder", "encoder"))
            bad, cut = [], 0
            for (path, w), d, spec in zip(
                    tree.flatten_with_path(params)[0], tree.leaves(placed),
                    tree.leaves(specs, is_leaf=lambda s: isinstance(
                        s, shd.P))):
                block = shd.NamedSharding(slots, spec).blocks(w.shape)[me]
                want = w[tuple(slice(a, b) for a, b in block)]
                cut += want.numel() < w.numel()
                if not torch.equal(d.to_local(), want):
                    bad.append(path)
            report[f"{arch}@{key}"] = dict(bad=bad, cut=cut,
                                           leaves=len(tree.leaves(params)))
    # a dim split over two mesh dims: DTensor's block is blocks'
    dm = _mesh((2, 2, 1))
    slots = Mesh(np.array([torch.device("cpu")] * 4, dtype=object)
                 .reshape(2, 2, 1), dm.mesh_dim_names)
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    spec = shd.P(("pod", "data"), None)
    d = shd.MeshSharding(dm, spec).distribute(x)
    me = int(np.ravel_multi_index(dm.get_coordinate(), (2, 2, 1)))
    block = shd.NamedSharding(slots, spec).blocks(x.shape)[me]
    report["pod_data"] = dict(
        local=torch.equal(d.to_local(),
                          x[tuple(slice(a, b) for a, b in block)]),
        whole=torch.equal(d.full_tensor(), x))


def _steps(rank, result):
    """One mesh step of every STEP_CASES case from the seed's params."""
    from repro_torch import tree
    from repro_torch.launch import train as T
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    meshes = {k: _mesh(SHAPES[k]) for k in ("2x2", "4x1", "1x4")}
    for arch, key in STEP_CASES:
        dm, cfg = meshes[key], cfg_of(arch)
        groups = shd.tp_groups(dm)
        params = init(arch)
        p_shard, o_shard = T.shardings(params, dm)
        params, opt = shd.distribute((params, adamw.init(params)),
                                     (p_shard, o_shard))
        mine = rows(global_batch(cfg), *shd.batch_shard(dm))
        loss, grads = T.mesh_loss_and_grads(params, cfg, mine, groups)
        new_p, new_o, met = T.make_mesh_train_step(cfg, opt_cfg(), dm)(
            params, opt, mine)
        got = dict(loss=float(loss), grads=whole_grads(grads, params),
                   params=full(new_p), m=full(new_o.m),
                   grad_norm=float(met["grad_norm"]),
                   step=int(new_o.step.full_tensor()))
        if rank == 0:
            result[f"{arch}@{key}"] = got
    for key in ("4x1", "2x2", "1x4"):
        out = T.train(resume_cfg(), **dict(RUN, steps=1), mesh=meshes[key],
                      device="cpu", log_fn=lambda *_: None)
        got = dict(losses=out["losses"], params=full(out["params"]))
        if rank == 0:
            result[f"train@{key}"] = got


def _resume(rank, out, result):
    """A world-4 run cut at CUT and resumed against its uninterrupted
    run; the cut run's checkpoint (step CUT in ``ck4``) stays for the
    elastic job."""
    from repro_torch.checkpoint import save
    from repro_torch.launch import train as T
    kw = dict(RUN, mesh=_mesh((2, 2)), device="cpu")
    d = os.path.join(out, "ck4")
    logs, resumed_logs = [], []
    ref = T.train(resume_cfg(), **kw, log_fn=logs.append)
    cut = T.train(resume_cfg(), **kw, ckpt_dir=d, run_steps=CUT,
                  log_fn=lambda *_: None)
    cut_state = full((cut["params"], cut["opt_state"]))
    res = T.train(resume_cfg(), **kw, ckpt_dir=d, log_fn=resumed_logs.append)
    # the synchronous save of DTensor state, and a write that fails on
    # rank 0 (its directory is a file) raising on every rank
    state = (res["params"], res["opt_state"])
    save(os.path.join(out, "ck4s"), RUN["steps"], state)
    blocker = os.path.join(out, "blocker")
    if rank == 0:
        with open(blocker, "w") as f:
            f.write("not a directory")
    try:
        save(blocker, 1, state)
        failed = None
    except OSError as e:
        failed = type(e).__name__
    got = dict(ref_losses=ref["losses"], failed_save=failed,
               ref_state=full((ref["params"], ref["opt_state"])),
               cut_losses=cut["losses"], cut_state=cut_state,
               res_losses=res["losses"],
               res_state=full((res["params"], res["opt_state"])),
               logs=logs, resumed_logs=resumed_logs)
    with open(os.path.join(out, f"failed_save{rank}.json"), "w") as f:
        json.dump(failed, f)
    if rank == 0:
        result["resume"] = got


def job_world4(rank, out):
    """Placement, the one-step gates, the resume (world 4)."""
    import torch.distributed as dist
    _join(rank, 4, out, "world4")
    report, result = {}, {}
    _placement(rank, report)
    _steps(rank, result)
    _resume(rank, out, result)
    with open(os.path.join(out, f"placement{rank}.json"), "w") as f:
        json.dump(report, f)
    if rank == 0:
        torch.save(result, os.path.join(out, "world4.pt"))
    dist.destroy_process_group()


def job_elastic(rank, world, out):
    """The world-4 checkpoint at world 2 or 1 (with shardings, and as a
    template of DTensors without them), the one-process checkpoint onto
    the mesh, and at world 2 the resume to the end."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    _join(rank, world, out, "elastic")
    dm = _mesh((world, 1))
    params = M.init_params(torch.Generator().manual_seed(0), resume_cfg(),
                           "cpu")
    places = T.shardings(params, dm)
    state = shd.distribute((params, adamw.init(params)), places)
    got = {}
    for name, d in (("world4", "ck4"), ("one_process", "ck1")):
        placed, meta = restore(os.path.join(out, d), state, step=CUT,
                               shardings=places)
        got[name] = dict(
            step=meta["extra"]["step"], state=full(placed),
            placed_ok=all(a.placements == s.placements
                          and a.device_mesh == s.mesh for a, s in
                          zip(_leaves(placed), _leaves(places))))
    if world == 2:
        res = T.train(resume_cfg(), **RUN, mesh=dm, device="cpu",
                      ckpt_dir=os.path.join(out, "ck4w2"),
                      log_fn=lambda *_: None)
        got["resumed"] = dict(losses=res["losses"],
                              state=full((res["params"], res["opt_state"])))
        # the one-process checkpoint resumed on the mesh
        res = T.train(resume_cfg(), **RUN, mesh=dm, device="cpu",
                      ckpt_dir=os.path.join(out, "ck1w2"),
                      log_fn=lambda *_: None)
        got["resumed_one_process"] = dict(
            losses=res["losses"],
            state=full((res["params"], res["opt_state"])))
    if rank == 0:
        torch.save(got, os.path.join(out, f"elastic{world}.pt"))
    dist.destroy_process_group()


def _leaves(t):
    from repro_torch import tree
    return tree.leaves(t)


def job_refstep(rank, out):
    """The port's (2, 2) step from the reference's params and batch, and
    ``compressed_psum`` over the 4 ranks."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import train as T
    from repro_torch.optim import adamw
    from repro_torch.runtime import compression as tcomp
    from repro_torch.runtime import sharding as shd
    _join(rank, 4, out, "refstep")
    with open(os.path.join(out, "reference.pkl"), "rb") as f:
        ref = pickle.load(f)
    dm = _mesh((2, 2))
    cfg = resume_cfg()
    params = params_from_numpy(ref["params"], device="cpu")
    p_shard, o_shard = T.shardings(params, dm)
    params, opt = shd.distribute((params, adamw.init(params)),
                                 (p_shard, o_shard))
    batch = {k: torch.from_numpy(v).long() for k, v in ref["batch"].items()}
    mine = rows(batch, *shd.batch_shard(dm))
    loss, grads = T.mesh_loss_and_grads(params, cfg, mine,
                                        shd.tp_groups(dm))
    new_p, _, met = T.make_mesh_train_step(cfg, opt_cfg(), dm)(
        params, opt, mine)
    got = dict(loss=float(loss), grads=whole_grads(grads, params),
               params=full(new_p), grad_norm=float(met["grad_norm"]))
    x, e = (torch.from_numpy(a) for a in psum_inputs(rank))
    y, err = tcomp.compressed_psum(x, e)
    q, scale, _ = tcomp.quantize_int8(x + e)
    q32 = tcomp._psum(q.to(torch.int32), None)
    s = tcomp._psum(scale, None)
    got["psum"] = dict(y=y.numpy(), err=err.numpy(), q32=q32.numpy(),
                       s=s.numpy())
    torch.save(got, os.path.join(out, f"refstep{rank}.pt"))
    dist.destroy_process_group()


def job_reference(out):
    """The reference: qwen reduced (2 layers, float32) initialised by
    ``repro.models.init_params`` and one ``make_train_step`` jitted
    with ``param_specs`` shardings on a (2, 2) mesh of forced host
    devices (``src/repro/launch/train.py:65-85``), its grads too; and
    ``compressed_psum`` under ``shard_map`` over 4 devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as JP

    from repro import configs
    from repro import models as jM
    from repro.launch.train import make_train_step
    from repro.optim import adamw
    from repro.runtime import compression as jcomp
    from repro.runtime import sharding as jshd
    assert len(jax.devices()) == 4
    cfg = configs.reduced(configs.get_arch("qwen1.5-0.5b")).replace(
        dtype="float32", num_layers=2)
    ocfg = adamw.AdamWConfig(lr=LR, total_steps=10, warmup_steps=2)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    # Auto axes, the pjit propagation the reference's step is written for
    # (jax's default Explicit axes refuse its embedding gather, as they
    # refuse its sharded server's slice: ROADMAP hazard 6)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with mesh:
        params = jM.init_params(jax.random.PRNGKey(0), cfg)
        host = jax.tree.map(np.asarray, params)
        specs = jshd.param_specs(params, mesh,
                                 stacked_prefixes=("decoder", "encoder"))
        p_shard = jshd.named(specs, mesh)
        o_shard = jshd.named(adamw.OptState(step=JP(), m=specs, v=specs),
                             mesh)
        params = jax.device_put(params, p_shard)
        opt = jax.device_put(adamw.init(params), o_shard)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        step = jax.jit(make_train_step(cfg, ocfg),
                       in_shardings=(p_shard, o_shard, None),
                       out_shardings=(p_shard, o_shard, None))
        new_p, _, met = step(params, opt, jb)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jM.loss_fn(p, cfg, jb)), in_shardings=(p_shard,),
            out_shardings=(None, p_shard))(params)
    sharded = sum(len(a.sharding.device_set) > 1 and not
                  a.sharding.is_fully_replicated
                  for a in jax.tree.leaves(new_p))
    xs, es = zip(*(psum_inputs(r) for r in range(4)))
    pm = jax.make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,))

    def member(a, e):
        y, err = jcomp.compressed_psum(a[0], "pod", e[0])
        q, scale, _ = jcomp.quantize_int8(a[0] + e[0])
        q32 = jax.lax.psum(q.astype(jnp.int32), "pod")
        s = jax.lax.psum(scale, "pod")
        return y[None], err[None], q32[None], s[None]
    f = shard_map(member, mesh=pm, in_specs=(JP("pod"), JP("pod")),
                  out_specs=(JP("pod"),) * 4)
    y, err, q32, s = (np.asarray(t) for t in f(jnp.asarray(np.stack(xs)),
                                               jnp.asarray(np.stack(es))))
    with open(os.path.join(out, "reference.pkl"), "wb") as fh:
        pickle.dump(dict(params=host, batch=batch, loss=float(loss),
                         grads=jax.tree.leaves(jax.tree.map(np.asarray,
                                                            grads)),
                         new_params=jax.tree.leaves(jax.tree.map(
                             np.asarray, new_p)),
                         step_loss=float(met["loss"]),
                         grad_norm=float(met["grad_norm"]),
                         sharded_leaves=int(sharded),
                         psum=dict(y=y, err=err, q32=q32, s=s)), fh)


def _spawn(fn, world, *args):
    import torch.multiprocessing as mp
    mp.spawn(fn, args=args, nprocs=world)


# ------------------------------------------------------------------ #
# the tests                                                            #
# ------------------------------------------------------------------ #
def run(what, cmd, **env):
    """Run ``cmd`` from the repo root with ``src`` on the path and the
    hard deadline: at the deadline its whole process group (every rank
    it spawned) is killed.  Returns its standard output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env)
    env.pop("XLA_FLAGS", None)
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=ROOT, start_new_session=True)
    try:
        out, err = p.communicate(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"{what} passed its {DEADLINE} s deadline")
    assert p.returncode == 0, f"{what}: {err[-3000:]}"
    return out


def run_job(job, where):
    run(f"job {job}", [sys.executable, os.path.abspath(__file__), job,
                       str(where)])


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    return tmp_path_factory.mktemp("spmd")


@pytest.fixture(scope="module")
def world4(jobs):
    run_job("world4", jobs)
    return torch.load(jobs / "world4.pt")


@pytest.fixture(scope="module")
def placement(world4, jobs):
    return [json.load(open(jobs / f"placement{r}.json")) for r in range(4)]


@pytest.fixture(scope="module")
def elastic(world4, jobs):
    from repro_torch.launch import train as T
    # a one-process checkpoint of the same run, cut at CUT
    T.train(resume_cfg(), **RUN, device="cpu", ckpt_dir=str(jobs / "ck1"),
            run_steps=CUT, log_fn=lambda *_: None)
    for src, dst in (("ck4", "ck4w2"), ("ck1", "ck1w2")):
        import shutil
        shutil.copytree(jobs / src / f"step_{CUT:08d}",
                        jobs / dst / f"step_{CUT:08d}")
    run_job("elastic", jobs)
    return {w: torch.load(jobs / f"elastic{w}.pt") for w in (2, 1)}


@pytest.fixture(scope="module")
def reference(jobs):
    run_job("reference", jobs)
    run_job("refstep", jobs)
    with open(jobs / "reference.pkl", "rb") as f:
        ref = pickle.load(f)
    return ref, [torch.load(jobs / f"refstep{r}.pt", weights_only=False)
                 for r in range(4)]


_ONE = {}


def one_process(arch):
    """The one-process port on the same params and global batch: loss,
    grads, and one make_train_step."""
    if arch not in _ONE:
        from repro_torch import tree
        from repro_torch.launch import train as T
        from repro_torch.optim import adamw
        cfg, params = cfg_of(arch), init(arch)
        batch = global_batch(cfg)
        loss, grads = T.loss_and_grads(params, cfg, batch)
        new_p, new_o, met = T.make_train_step(cfg, opt_cfg())(
            params, adamw.init(params), batch)
        _ONE[arch] = dict(loss=float(loss), grads=tree.leaves(grads),
                          params=tree.leaves(new_p), m=tree.leaves(new_o.m),
                          grad_norm=float(met["grad_norm"]),
                          before=tree.leaves(params))
    return _ONE[arch]


def assert_close(what, got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale:.3g}"


def step_close(what, got, want, grads, steps=1):
    """Params after ``steps`` AdamW steps within PARAM_TOL x max|p|, but
    for elements that moved by at most 2 lr a step more (a normalised
    step of opposite sign), each where the gradient is within GRAD_TOL x
    max|g| + EPS_ZONE of zero (when ``grads`` is given), and no more than
    STEP_FLIPS of the leaf (+4).  Returns the count of such elements."""
    flips = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.double().numpy(), w.double().numpy()
        assert g.shape == w.shape, (what, i)
        tol = PARAM_TOL * float(np.abs(w).max())
        diff = np.abs(g - w)
        off = diff > tol
        if not off.any():
            continue
        assert diff.max() <= 2 * LR * steps + tol, \
            f"{what} leaf {i}: max err {diff.max():.3g}"
        if grads is not None:
            gr = grads[i].double().numpy()
            near = np.abs(gr) <= GRAD_TOL * float(np.abs(gr).max()) \
                + EPS_ZONE
            assert near[off].all(), \
                f"{what} leaf {i}: off elements with a gradient away from 0"
        n = int(off.sum())
        assert n <= STEP_FLIPS * w.size + 4, \
            f"{what} leaf {i}: {n} of {w.size} elements off"
        flips += n
    return flips


def bits_equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", PLACED)
@pytest.mark.parametrize("key", list(SHAPES))
def test_placement_is_named_sharding_blocks(placement, arch, key):
    for r, report in enumerate(placement):
        got = report[f"{arch}@{key}"]
        assert got["bad"] == [], f"rank {r}: {got['bad']}"
        # the rules shard something on every mesh with more than one rank
        # on a sharding axis
        assert got["cut"] > 0


def test_two_mesh_dims_on_one_tensor_dim(placement):
    for report in placement:
        assert report["pod_data"] == dict(local=True, whole=True)


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.runtime import sharding as shd
    dm = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert shd.placements(shd.P(("pod", "data"), "model"), dm) == (
        Shard(0), Shard(0), Shard(1))
    assert shd.placements(shd.P(None, "data"), dm) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements(shd.P(("data", "pod")), dm)
    with pytest.raises(ValueError, match="twice"):
        shd.placements(shd.P("data", "data"), dm)
    with pytest.raises(ValueError, match="not an axis"):
        shd.placements(shd.P("expert"), dm)


@pytest.mark.parametrize("arch,key", STEP_CASES,
                         ids=[f"{a}-{k}" for a, k in STEP_CASES])
def test_mesh_step_equals_one_process(world4, arch, key):
    got, want = world4[f"{arch}@{key}"], one_process(arch)
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * abs(want["loss"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert_close(f"{arch} {key} grad leaf {i}", g, w, GRAD_TOL)
    assert_close("grad_norm", got["grad_norm"], want["grad_norm"], LOSS_TOL)
    assert got["step"] == 1
    for i, (g, w) in enumerate(zip(got["m"], want["m"])):
        assert_close(f"{arch} {key} m leaf {i}", g, w, GRAD_TOL)
    step_close(f"{arch} {key} params", got["params"], want["params"],
               want["grads"])


@pytest.mark.parametrize("key", ["4x1", "2x2", "1x4"])
def test_train_first_step_equals_one_process(world4, key):
    from repro_torch import tree
    from repro_torch.launch import train as T
    got = world4[f"train@{key}"]
    if "train" not in _ONE:
        _ONE["train"] = T.train(resume_cfg(), **dict(RUN, steps=1),
                                device="cpu", log_fn=lambda *_: None)
    want = _ONE["train"]
    (lw,), (lg,) = want["losses"], got["losses"]
    assert abs(lg - lw) <= LOSS_TOL * abs(lw)
    step_close(f"train {key}", got["params"], tree.leaves(want["params"]),
               None)


def test_resume_bitwise_identical_at_world_4(world4):
    r = world4["resume"]
    assert r["cut_losses"] == r["ref_losses"][:CUT]
    assert r["res_losses"] == r["ref_losses"][CUT:]
    assert bits_equal(r["res_state"], r["ref_state"])
    assert r["resumed_logs"][0] == f"[resume] from step {CUT}"
    assert r["logs"][0].startswith("step     0 loss")


@pytest.mark.parametrize("world", [2, 1])
def test_world4_checkpoint_restores_elastically(world4, elastic, world):
    got = elastic[world]["world4"]
    assert got["step"] == CUT
    assert bits_equal(got["state"], world4["resume"]["cut_state"])
    assert got["placed_ok"]


def test_spmd_save_is_whole_and_fails_on_every_rank(world4, jobs):
    """``save`` of DTensor state (every rank gathers, rank 0 writes)
    reads back whole; a write that fails on rank 0 raises on all."""
    from repro_torch import tree
    from repro_torch.checkpoint import restore
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    params = M.init_params(torch.Generator().manual_seed(0), resume_cfg(),
                           "cpu")
    state, meta = restore(str(jobs / "ck4s"), (params, adamw.init(params)))
    assert meta["step"] == RUN["steps"]
    assert bits_equal(tree.leaves(state), world4["resume"]["res_state"])
    for r in range(4):
        failed = json.load(open(jobs / f"failed_save{r}.json"))
        assert failed in ("FileExistsError", "NotADirectoryError",
                          "OSError"), (r, failed)


def test_world4_checkpoint_restores_without_shardings(world4, jobs):
    from repro_torch import tree
    from repro_torch.checkpoint import restore
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    params = M.init_params(torch.Generator().manual_seed(0), resume_cfg(),
                           "cpu")
    template = (params, adamw.init(params))
    for step, want in ((CUT, "cut_state"), (None, "res_state")):
        state, meta = restore(str(jobs / "ck4"), template, step=step)
        assert meta["extra"]["data"]["step"] == (step or RUN["steps"])
        got = tree.leaves(state)
        assert not any(hasattr(t, "full_tensor") for t in got)
        assert bits_equal(got, world4["resume"][want])


@pytest.mark.parametrize("world", [2, 1])
def test_one_process_checkpoint_onto_a_mesh(elastic, jobs, world):
    from repro_torch import tree
    from repro_torch.checkpoint import restore
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    params = M.init_params(torch.Generator().manual_seed(0), resume_cfg(),
                           "cpu")
    plain, _ = restore(str(jobs / "ck1"), (params, adamw.init(params)))
    got = elastic[world]["one_process"]
    assert got["placed_ok"]
    assert bits_equal(got["state"], tree.leaves(plain))


def test_elastic_resume_at_world_2_continues(world4, elastic):
    ref = world4["resume"]
    for name in ("resumed", "resumed_one_process"):
        got = elastic[2][name]
        assert len(got["losses"]) == RUN["steps"] - CUT
        for a, b in zip(got["losses"], ref["ref_losses"][CUT:]):
            assert abs(a - b) <= LOSS_TOL * abs(b), name
        n_params = (len(ref["ref_state"]) - 1) // 3   # params, step, m, v
        step_close(name, got["state"][:n_params],
                   ref["ref_state"][:n_params], None,
                   steps=RUN["steps"] - CUT)


def test_mesh_step_equals_the_references_sharded_step(reference):
    ref, ranks = reference
    assert ref["sharded_leaves"] > 0       # the reference really shards
    got = ranks[0]
    assert abs(got["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    assert abs(got["loss"] - ref["step_loss"]) <= LOSS_TOL * abs(ref["loss"])
    assert_close("grad_norm", got["grad_norm"], ref["grad_norm"], LOSS_TOL)
    grads = [torch.from_numpy(np.asarray(g)) for g in ref["grads"]]
    assert len(got["grads"]) == len(grads)
    for i, (g, w) in enumerate(zip(got["grads"], grads)):
        assert_close(f"grad leaf {i}", g, w, GRAD_TOL)
    step_close("params vs reference", got["params"],
               [torch.from_numpy(np.asarray(p)) for p in ref["new_params"]],
               grads)


def test_compressed_psum_over_four_ranks_equals_reference(reference):
    """The int32 sums bit for bit; the scale sum bit for bit or within
    one float32 ulp (gloo's order of the four adds need not be XLA's);
    the output bit for bit where the scale sums are, else within one
    ulp of the mean scale per unit of |q32|; the error bit for bit."""
    ref, ranks = reference
    want = ref["psum"]
    for r, got in enumerate(ranks):
        g = got["psum"]
        np.testing.assert_array_equal(g["q32"], want["q32"][r])
        np.testing.assert_array_equal(g["err"].view(np.uint32),
                                      want["err"][r].view(np.uint32))
        s, ws = g["s"].astype(np.float32), want["s"][r]
        ulps = np.abs(s.view(np.int32).astype(np.int64)
                      - ws.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, f"rank {r}: scale sums {ulps.max()} ulp off"
        if ulps.max() == 0:
            np.testing.assert_array_equal(g["y"].view(np.uint32),
                                          want["y"][r].view(np.uint32))
        else:
            q = np.abs(g["q32"].reshape(-1)[:g["y"].size]).astype(np.float64)
            step = np.spacing(np.abs(ws / 4).max()) / 4
            assert np.all(np.abs(g["y"] - want["y"][r]) <= q * step * 2)


def test_make_process_mesh_and_train_refuse_without_a_card():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_process_mesh, rules_mesh
    if torch.cuda.is_available():
        pytest.skip("the refusals are those of a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_process_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_process_mesh(device="cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        dm = make_process_mesh(model=2, device="cpu")
        assert rules_mesh(dm).shape == {"data": 2, "model": 2}
        dm3 = make_process_mesh(model=2, pods=2, device="cpu")
        assert rules_mesh(dm3).shape == {"pod": 2, "data": 1, "model": 2}
        with pytest.raises(ValueError, match="do not split"):
            make_process_mesh(model=3, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_process_mesh(model=2)
        with pytest.raises(ValueError, match="device type"):
            T.train(resume_cfg(), steps=1, global_batch=4, seq_len=8,
                    mesh=dm, log_fn=lambda *_: None)
    finally:
        dist.destroy_process_group()



def test_cli_under_torch_distributed_run():
    """``main()`` under ``torch.distributed.run`` (2 gloo ranks on
    localhost): SPMD on ``make_process_mesh()``, rank 0 alone prints."""
    out = run("the CLI", [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch",
        "qwen1.5-0.5b", "--reduced", "--steps", "3", "--batch", "2", "--seq",
        "8", "--device", "cpu"], OMP_NUM_THREADS="1")
    lines = out.strip().splitlines()
    assert [ln.split()[:2] for ln in lines[:-1]] == [["step", "0"],
                                                     ["step", "2"]]
    assert lines[-1].startswith("loss ")

if __name__ == "__main__":
    job, where = sys.argv[1], sys.argv[2]
    if job == "reference":
        job_reference(where)
    elif job == "world4":
        _spawn(job_world4, 4, where)
    elif job == "refstep":
        _spawn(job_refstep, 4, where)
    elif job == "elastic":
        _spawn(job_elastic, 2, 2, where)
        _spawn(job_elastic, 1, 1, where)
    else:
        raise SystemExit(f"unknown job {job}")
    sys.exit(0)
