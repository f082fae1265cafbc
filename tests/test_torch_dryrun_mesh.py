"""The dry-run on the production meshes (``repro_torch.launch.dryrun``
with ``mesh="single"`` (16 x 16) and ``"multi"`` (2 x 16 x 16)), on
torch's fake process group (``launch.mesh.fake_world``), and packed
weights on a ``DeviceMesh`` (``runtime.sharding.MeshSharding``).

* (a) qwen1.5-0.5b's train_4k, prefill_32k and decode_32k baseline on
  both meshes, and decode_32k packed and ``tp_only_packed_kv8``: each
  record is ok with the reference's keys plus ``collectives_static``,
  ``mesh_shape`` and ``rank``; its per-device param bytes equal the sum
  of each leaf's ``param_specs`` block (``fsdp_axis="__off__"`` for
  ``tp_only*``), its moment and input bytes their blocks;
* (b) rank 0's count of a reduced qwen and a reduced mixtral train step
  on meta tensors over a fake (2, 2) world equals rank 0's count of the
  same step over 4 real gloo ranks on the CPU: flops, bytes,
  collectives by kind and peak, exactly;
* (c) on the mesh, the scaled count (a cycle as the difference of two
  cut depths, each placed anew) equals the full count at a reduced
  depth;
* (d) a device's dot flops times pod x data x model equal the one-card
  cell's (tensor-parallel compute over "model"); the train step's
  all-gather bytes are the FSDP gathers ``param_specs`` gives, none of
  a leaf over "model" where its layer computes on blocks; the
  collectives are priced by their operands;
* (e) a PackedArray distributed on (2, 2) and (2, 1, 2) gloo meshes
  holds ``NamedSharding.blocks`` of its words on every rank, and
  the words DTensor's ``full_tensor()`` gives the original words back
  bit for bit;
* (f) the CLI's ``--mesh both`` writes both records and exits 0;
* (g) ``fake_world`` refuses to open over an initialised process group.

The gloo ranks run as ``python tests/test_torch_dryrun_mesh.py mesh
<dir>`` through ``test_torch_spmd``'s job runner (a hard deadline, a
``file://`` store per job).

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun_mesh.py
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_spmd as spmd  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-0.5b"
RECORD_KEYS = {"arch", "shape", "mesh", "variant", "applicable", "memory",
               "cost", "cost2", "collectives", "collectives_static",
               "n_params", "n_params_active", "ok", "wall_s", "mesh_shape",
               "rank"}
CELLS = [(s, m, "baseline") for s in ("train_4k", "prefill_32k",
                                      "decode_32k")
         for m in ("single", "multi")] + \
    [("decode_32k", m, v) for v in ("packed", "tp_only_packed_kv8")
     for m in ("single", "multi")]
COUNTED = ("qwen1.5-0.5b", "mixtral-8x22b")     # (b)'s archs
PACKED_MESHES = {"2x2": (2, 2), "2x1x2": (2, 1, 2)}
RB, RS = 4, 16        # (b)'s global batch and sequence


def small_cfg(arch, **kw):
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch(arch)).replace(dtype="float32", remat="full",
                                           attn_q_chunk=8, attn_kv_chunk=8,
                                           **kw)


def small_shape(kind, batch=RB, seq=RS):
    from repro_torch.configs import ShapeConfig
    return ShapeConfig(f"small_{kind}", seq, batch, kind)


def whole_inputs(cfg, shape, seed=5):
    """A numpy-seeded batch (or decode caches and tokens) of the cell's
    input specs: random floats, integers in [0, 8)."""
    from repro_torch import tree
    from repro_torch.models import model as M
    rng = np.random.default_rng(seed)

    def leaf(t):
        if t.is_floating_point():
            a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
            return torch.from_numpy(a).to(t.dtype)
        a = rng.integers(0, 8, tuple(t.shape))
        return torch.from_numpy(a).to(t.dtype)
    return tree.map(leaf, M.input_specs(cfg, shape))


def process_mesh(shape):
    from repro_torch.launch.mesh import make_process_mesh
    if len(shape) == 3:
        return make_process_mesh(shape[2], pods=shape[0], device="cpu")
    return make_process_mesh(shape[1], device="cpu")


def counts(c):
    return dict(flops=c.cost.flops, bytes=c.cost.bytes,
                collectives=dict(c.cost.collectives), peak=c.peak_bytes)


# ------------------------------------------------------------------ #
# the gloo ranks                                                       #
# ------------------------------------------------------------------ #
def _packed_report(rank):
    """(e): every leaf of reduced qwen's packed tree distributed by
    ``param_specs`` on each mesh shape: the local words against
    ``NamedSharding.blocks``, the gathered words against the original."""
    from repro_torch import tree
    from repro_torch.kernels.packed import PackedArray
    from repro_torch.launch.mesh import Mesh, rules_mesh
    from repro_torch.launch.train import shardings
    from repro_torch.models import model as M
    from repro_torch.models.quantize import pack_model_params
    from repro_torch.runtime import sharding as shd
    params = pack_model_params(M.init_params(
        torch.Generator().manual_seed(0), small_cfg(ARCH), "cpu"))
    report = {}
    for key, shape in PACKED_MESHES.items():
        dm = process_mesh(shape)
        slots = Mesh(np.array([torch.device("cpu")] * dm.size(),
                              dtype=object).reshape(shape),
                     dm.mesh_dim_names)
        me = int(np.ravel_multi_index(dm.get_coordinate(), shape))
        p_shard, _ = shardings(params, dm)
        placed = shd.distribute(params, p_shard)
        specs = shd.param_specs(params, rules_mesh(dm),
                                stacked_prefixes=("decoder", "encoder"))
        bad, cut, packed = [], 0, 0
        for (path, w), d, spec in zip(
                tree.flatten_with_path(params)[0], tree.leaves(placed),
                tree.leaves(specs, is_leaf=lambda s: isinstance(s, shd.P))):
            if not isinstance(w, PackedArray):
                continue
            packed += 1
            block = shd.NamedSharding(slots, spec).blocks(
                w.words.shape)[me]
            want = w.words[tuple(slice(a, b) for a, b in block)]
            cut += want.numel() < w.words.numel()
            back = d.words.full_tensor()
            same = (isinstance(d, PackedArray)
                    and (d.length, d.axis, d.values)
                    == (w.length, w.axis, w.values)
                    and torch.equal(d.words.to_local(), want)
                    and back.dtype == w.words.dtype
                    and torch.equal(back, w.words))
            if not same:
                bad.append(path)
        report[key] = dict(bad=bad, cut=cut, packed=packed)
    return report


def _counted_steps():
    """(b): each COUNTED arch's reduced train step on the (2, 2) mesh,
    real params and rows, under the counter."""
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.runtime import op_cost
    dm = process_mesh((2, 2))
    out = {}
    for arch in COUNTED:
        cfg, shape = small_cfg(arch), small_shape("train")
        params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        fn, args = dryrun.place_cell(cfg, shape, "baseline", dm, params,
                                     whole_inputs(cfg, shape))
        with op_cost.Counter() as c:
            fn(*args)
        out[arch] = counts(c)
    return out


def job_mesh(rank, where):
    spmd._join(rank, 4, where, "dryrun_mesh")
    result = dict(packed=_packed_report(rank), counted=_counted_steps())
    with open(os.path.join(where, f"mesh{rank}.json"), "w") as f:
        json.dump(result, f)


# ------------------------------------------------------------------ #
# the tests                                                            #
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    where = tmp_path_factory.mktemp("dryrun_mesh")
    spmd.run("job mesh", [sys.executable, os.path.abspath(__file__), "mesh",
                          str(where)])
    return [json.load(open(where / f"mesh{r}.json")) for r in range(4)]


_RECORDS = {}


def record(shape, mesh, variant):
    from repro_torch.launch import dryrun
    key = (shape, mesh, variant)
    if key not in _RECORDS:
        _RECORDS[key] = dryrun.run_cell(ARCH, shape, mesh, variant)
    return _RECORDS[key]


def held_bytes(tree_, specs, mesh_shape):
    """Bytes a device holds of ``tree_`` under ``specs``: each leaf's
    (a PackedArray's words') bytes over the slots its spec splits it
    into."""
    from repro_torch import tree
    from repro_torch.kernels.packed import PackedArray
    from repro_torch.runtime.sharding import P
    held = 0
    for leaf, spec in zip(tree.leaves(tree_),
                          tree.leaves(specs,
                                      is_leaf=lambda s: isinstance(s, P))):
        t = leaf.words if isinstance(leaf, PackedArray) else leaf
        split = math.prod(mesh_shape[a] for e in spec if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
        assert t.numel() % split == 0
        held += t.numel() * t.element_size() // split
    return held


@pytest.mark.parametrize("shape,mesh,variant", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_mesh_record_keys_and_bytes(shape, mesh, variant):
    from repro_torch import tree
    from repro_torch.configs import get_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as M
    from repro_torch.models.quantize import pack_model_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    rec = record(shape, mesh, variant)
    assert rec["ok"], rec.get("traceback")
    assert RECORD_KEYS <= set(rec)
    rules = make_production_mesh(multi_pod=mesh == "multi")
    assert rec["mesh_shape"] == rules.shape and rec["rank"] == 0
    cfg = dryrun.cell_config(ARCH, shape, variant)
    params = M.abstract_params(cfg)
    if dryrun._packs(variant):
        params = pack_model_params(params)
    fsdp = "__off__" if variant.startswith("tp_only") else "data"
    specs = shd.param_specs(params, rules, ("decoder", "encoder"),
                            fsdp_axis=fsdp)
    want = {"params": held_bytes(params, specs, rules.shape)}
    if get_shape(shape).kind == "train":
        opt = adamw.init(params)
        want["opt_state"] = held_bytes(
            opt, adamw.OptState(shd.P(), specs, specs), rules.shape)
    inputs = M.input_specs(cfg, get_shape(shape))
    want["inputs"] = held_bytes(inputs, shd.batch_specs(inputs, rules),
                                rules.shape)
    mem = rec["memory"]
    assert mem["argument_split"] == want
    assert mem["argument_size_in_bytes"] == sum(want.values())
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    static, scaled = rec["collectives_static"], rec["collectives"]
    assert static["all-gather"] > 0          # the params are gathered
    assert static["total"] == sum(v for k, v in static.items()
                                  if k != "total")
    assert scaled["total"] == rec["cost2"]["collective_bytes"] \
        >= static["total"]
    if get_shape(shape).kind == "train":
        assert static["all-reduce"] > 0      # the grads are reduced
    assert (rec["n_params"], rec["n_params_active"]) == \
        (cfg.param_count(), cfg.param_count(active_only=True))
    if variant == "baseline" and mesh == "single":
        # chip_smoke.py phase 15d's bytes a device at (16, 16)
        assert want["params"] == 3_639_424
    assert len(tree.leaves(params)) > 0


def test_tp_only_keeps_the_params_off_data():
    """FSDP off: the tp_only cell holds more of each param than the
    packed cell it differs from by its specs."""
    tp = record("decode_32k", "single", "tp_only_packed_kv8")
    packed = record("decode_32k", "single", "packed")
    assert tp["memory"]["argument_split"]["params"] > \
        packed["memory"]["argument_split"]["params"]


@pytest.mark.parametrize("arch", COUNTED)
def test_fake_world_count_equals_gloo_ranks(gloo, arch):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.runtime import op_cost
    cfg, shape = small_cfg(arch), small_shape("train")
    with fake_world(4):
        _, fn, args = dryrun.build_cell(arch, shape.name, "baseline", cfg,
                                        shape, mesh=process_mesh((2, 2)))
        with op_cost.Counter() as c:
            fn(*args)
    want = gloo[0]["counted"][arch]
    assert counts(c) == want
    assert want["collectives"]["all-gather"] > 0
    assert want["collectives"]["all-reduce"] > 0


@pytest.mark.parametrize("arch,kind", [(ARCH, "train"), (ARCH, "decode"),
                                       ("mixtral-8x22b", "train")])
def test_scaled_count_equals_full_count_on_the_mesh(arch, kind):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.runtime import op_cost
    cfg, shape = small_cfg(arch, num_layers=4), small_shape(kind)
    with fake_world(4):
        dm = process_mesh((2, 2))
        res = dryrun.step_cost(arch, shape.name, "baseline", cfg, shape,
                               mesh=dm)
        _, fn, args = dryrun.build_cell(arch, shape.name, "baseline", cfg,
                                        shape, mesh=dm)
        with op_cost.Counter(scale_loops=True) as c:
            fn(*args)
    assert res["walked_cycles"] == {"decoder": 2}
    got = res["cost2"]
    assert (got.flops, got.bytes, got.collectives) == \
        (c.cost.flops, c.cost.bytes, c.cost.collectives)
    assert got.collectives["all-gather"] > res["cost"].collectives[
        "all-gather"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dot_flops_are_the_device_share(kind):
    """A device's mm / bmm flops x pod x data x model equal the one-card
    cell's at qwen's published widths (one cycle, a short sequence):
    every layer computes on its "model" block (16 heads, d_ff 2816 and
    the vocab divide 16).  The vocab chunk is the vocab block (9496
    rows), so that the one-card loss pads no chunk."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.runtime import op_cost
    cfg = dryrun.cut_depth(dryrun.cell_config(ARCH, "train_4k"),
                           {"decoder": 1})
    cfg = cfg.replace(logits_chunk=cfg.padded_vocab() // 16)
    shape = small_shape(kind, batch=32, seq=64)

    class Dots(op_cost.Counter):
        """The counter, with the flops of its dot-like ops apart."""
        dots = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = self.cost.flops
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if op_cost._base(func.overloadpacket.__name__) in op_cost.DOT:
                self.dots += self.cost.flops - before
            return out

    def dots(mesh):
        _, fn, args = dryrun.build_cell(ARCH, shape.name, "baseline", cfg,
                                        shape, mesh=mesh)
        with Dots(scale_loops=True) as c:
            fn(*args)
        return c.dots
    one = dots(None)
    assert one > 0
    for world, pods in ((256, 1), (512, 2)):
        with fake_world(world):
            per_device = dots(dryrun.production_mesh(
                "multi" if pods == 2 else "single"))
        assert per_device * 16 * 16 * pods == one, (world, per_device, one)


def _gathered_bytes(cfg, mesh_shape, whole):
    """The all-gather operand bytes of one train step, from
    ``param_specs`` alone: each leaf split over "data" is gathered from
    its block (every cycle of a stacked leaf twice, remat "full"
    recomputing it in the backward), and a leaf of a layer in ``whole``
    (a path pattern) split over "model" is gathered there too, from its
    block over "model"."""
    import re

    from repro_torch import tree
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime.sharding import P, param_specs
    rules = make_production_mesh()
    rules.shape.update(zip(("data", "model"), mesh_shape))
    params = M.abstract_params(cfg)
    specs = param_specs(params, rules, ("decoder", "encoder"))
    total = 0
    for (path, leaf), spec in zip(
            tree.flatten_with_path(params)[0],
            tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        axes = [a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        nbytes = leaf.numel() * leaf.element_size()
        times = 2 if path.startswith("decoder/layers") else 1
        if "data" in axes:
            total += times * nbytes // math.prod(
                rules.shape[a] for a in axes)
        if "model" in axes and re.search(whole, path):
            total += times * nbytes // rules.shape["model"]
    return total


@pytest.mark.parametrize("arch,whole", [(ARCH, r"$^"),
                                        ("falcon-mamba-7b", r"/ssm/in_proj")])
def test_train_step_gathers_no_block_leaf_over_model(arch, whole):
    """On a fake (2, 2) world the TP train step's all-gather operand
    bytes are the FSDP gathers over "data" that ``param_specs`` gives,
    plus, over "model", only the leaves computed whole (none of qwen's;
    the Mamba block's in_proj, whose x | z halves each rank reads its
    channels of)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.runtime import op_cost
    cfg, shape = small_cfg(arch), small_shape("train")
    with fake_world(4):
        _, fn, args = dryrun.build_cell(arch, shape.name, "baseline", cfg,
                                        shape, mesh=process_mesh((2, 2)))
        with op_cost.Counter() as c:
            fn(*args)
    got = c.cost.collectives
    assert got["all-gather"] == _gathered_bytes(cfg, (2, 2), whole)
    assert got["reduce-scatter"] > 0 and got["all-reduce"] > 0


def test_collectives_are_priced_by_their_operands():
    """On meta over a fake world: an all-gather is its block's bytes,
    a reduce-scatter its whole input's, an all-reduce (a TP sum, a max)
    its tensor's; ``wait_tensor`` of a functional one is free."""
    from repro_torch.launch.mesh import fake_world
    from repro_torch.runtime import op_cost
    from repro_torch.runtime import sharding as shd
    with fake_world(4):
        dm = process_mesh((2, 2))
        g = dm.get_group("model")
        x = torch.empty(6, 8, device="meta")
        with op_cost.Counter() as c:
            shd._all_gather(x, 1, g, 2)
        assert dict(c.cost.collectives) == {"all-gather": 6 * 8 * 4}
        with op_cost.Counter() as c:
            out = shd._reduce_scatter(x, 1, g, 2)
        assert tuple(out.shape) == (6, 4)
        assert dict(c.cost.collectives) == {"reduce-scatter": 6 * 8 * 4}
        with op_cost.Counter() as c:
            shd._all_reduce(x, g)
            shd._all_reduce(x, g, "max")
        assert dict(c.cost.collectives) == {"all-reduce": 2 * 6 * 8 * 4}


@pytest.mark.parametrize("key", list(PACKED_MESHES))
def test_packed_array_on_a_device_mesh(gloo, key):
    for r, report in enumerate(gloo):
        got = report["packed"][key]
        assert got["packed"] > 0
        assert got["bad"] == [], f"rank {r}: {got['bad']}"
        assert got["cut"] > 0, f"rank {r}: no packed leaf is split"


def test_distribute_keeps_a_packed_arrays_layout():
    """On a fake world, rank 1 (data 0, model 1) holds the words' block,
    split as words, with the PackedArray's length, axis and values; a
    leaf that is neither a tensor nor a PackedArray still raises."""
    from repro_torch.kernels.packed import PackedArray
    from repro_torch.launch.mesh import fake_world
    from repro_torch.runtime import sharding as shd
    words = torch.arange(8 * 6, dtype=torch.int32).reshape(8, 6)
    pa = PackedArray(words, length=250, axis=-2)
    with fake_world(4, rank=1):
        sh = shd.MeshSharding(process_mesh((2, 2)), shd.P("data", "model"))
        d = sh.distribute(pa)
        assert isinstance(d, PackedArray)
        assert (d.length, d.axis, d.values) == (250, -2, pa.values)
        assert torch.equal(d.words.to_local(), words[0:4, 3:6])
        assert tuple(d.words.shape) == (8, 6)
        with pytest.raises(TypeError, match="cannot distribute"):
            sh.distribute([words])


def test_cli_both_meshes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", "decode_32k", "--mesh", "both", "--variant", "packed",
         "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for mesh, shape in (("single", {"data": 16, "model": 16}),
                        ("multi", {"pod": 2, "data": 16, "model": 16})):
        assert f"[OK] {ARCH} x decode_32k x {mesh}" in proc.stdout
        rec = json.loads((tmp_path / f"{ARCH}__decode_32k__{mesh}__packed"
                          ".json").read_text())
        assert rec["ok"] and rec["mesh_shape"] == shape
        assert RECORD_KEYS <= set(rec)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_trip_counts_a_reused_storage_address_once(device):
    """The repair behind a repeatable peak: a storage freed inside a
    scaled trip and one kept by it at the same address (the allocator
    hands it on) were both counted as kept, so the trip's extra bytes
    went in twice and the peak moved with the allocator.  The kept
    output counts ``n`` times, once."""
    from repro_torch.runtime import op_cost
    reused = 0
    for _ in range(4):
        with op_cost.Counter() as c:
            with c.trips(5) as box:
                a = torch.ones(1000, device=device)
                first = a.untyped_storage()._cdata
                del a
                b = torch.ones(1000, device=device)
                reused += b.untyped_storage()._cdata == first
                box["keep"] = b
            assert (c.live_bytes, c.peak_bytes) == (5 * 4000, 5 * 4000)
            del b, box
            assert c.live_bytes == 0
    assert reused > 0, "the allocator never reused the address"


def test_mesh_prefill_peak_repeats():
    """The same mesh prefill cell counted three times in one process
    gives one peak (it moved by up to 0.53 GB with the trip fault)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    cfg = dryrun.cut_depth(dryrun.cell_config(ARCH, "prefill_32k"),
                           {"decoder": 2})
    peaks = []
    with fake_world(256):
        dm = dryrun.production_mesh("single")
        for _ in range(3):
            _, fn, args = dryrun.build_cell(ARCH, "prefill_32k",
                                            "baseline", cfg, mesh=dm)
            peaks.append(dryrun._measure(fn, args)["peak"])
    assert peaks[0] > 0 and peaks == peaks[:1] * 3, peaks


def test_fake_world_refuses_an_initialised_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world
    assert not dist.is_initialized()
    with fake_world(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_world(8):
                pass
        # the group it refused to replace is still the one in use
        assert dist.is_initialized() and dist.get_world_size() == 4
    assert not dist.is_initialized()


if __name__ == "__main__":
    job, where = sys.argv[1], sys.argv[2]
    if job != "mesh":
        raise SystemExit(f"unknown job {job}")
    spmd._spawn(job_mesh, 4, where)
    sys.exit(0)
