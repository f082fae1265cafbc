"""The port's mesh and sharding rules (``repro_torch.launch.mesh``,
``repro_torch.runtime.sharding``) against the reference's.

The reference's ``param_specs`` and ``batch_specs`` read only
``mesh.shape``, so its production meshes are stood in for by a
shape-only namespace, and the port's by its own shape-only ``Mesh``:

* ``fit_spec`` and ``spec_for_param`` (one path per ``_RULES`` pattern,
  stacked and not) equal the reference's entry for entry;
* ``param_specs`` of all ten archs at published widths (meta tensors in
  the port, ``abstract_params`` / ``eval_shape(pack_model_params)`` in
  the reference), baseline and packed, ``fsdp_axis`` "data" and
  "__off__", on meshes (16,16), (2,16,16), (2,2), (4,1) and None;
* ``batch_specs`` of every arch x shape's inputs;
* ``shard_act``: the nine sites see the reference's shapes and wants, and
  a reduced arch's logits inside a 2x2 mesh context equal those outside
  it bit for bit;
* ``NamedSharding`` cuts a tensor into its slots' blocks and puts them
  back.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharding.py
"""
import functools
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.quantize import \
    pack_model_params as jpack_model_params  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.kernels.packed import PackedArray  # noqa: E402
from repro_torch.launch.mesh import (Mesh, current_mesh,  # noqa: E402
                                     make_local_mesh, make_production_mesh)
from repro_torch.models.quantize import pack_model_params  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

ARCH_IDS = list(jconfigs.ARCHS)
MESHES = {
    "16x16": make_production_mesh(),
    "2x16x16": make_production_mesh(multi_pod=True),
    "2x2": Mesh(None, ("data", "model"), shape=(2, 2)),
    "4x1": Mesh(None, ("data", "model"), shape=(4, 1)),
    "none": None,
}


def _ref_mesh(mesh):
    """The reference's stand-in for a mesh: only its shape is read."""
    return None if mesh is None else types.SimpleNamespace(
        shape=dict(mesh.shape))


def _entries(spec):
    return tuple(spec)


def test_meshes():
    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert list(MESHES["2x16x16"].shape) == ["pod", "data", "model"]
    assert MESHES["2x16x16"].size == 512 and MESHES["2x16x16"].devices is None
    cpu = torch.device("cpu")
    mesh = make_local_mesh(model=2, devices=[cpu] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.devices.shape == (2, 2) and mesh.slots() == [cpu] * 4
    assert mesh.distinct_devices() == [cpu]
    with pytest.raises(ValueError):
        make_local_mesh(model=3, devices=[cpu] * 4)
    assert current_mesh() is None
    with mesh as m:
        assert m is mesh and current_mesh() is mesh
        with MESHES["2x2"]:
            assert current_mesh() is MESHES["2x2"]
        assert current_mesh() is mesh
    assert current_mesh() is None


# ------------------------------------------------------------------ #
# fit_spec and spec_for_param                                          #
# ------------------------------------------------------------------ #
FIT_CASES = [
    ((8, 128), (("pod", "data"), None)),
    ((6, 10, 64), (("pod", "data"), None, "model")),
    ((32, 4096), ("data", "model")),
    ((2, 3, 5), ("model", ("data", "model"), None)),
    ((512, 7), (("pod", "data", "model"), "model")),
    ((1, 1), ("data", "model")),
    ((64,), (None,)),
    ((256, 256, 8), (("data", "model"), None, ("pod",))),
]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fit_spec_equals_reference(mesh):
    for shape, want in FIT_CASES:
        got = shd.fit_spec(shape, want, MESHES[mesh])
        ref = jshd.fit_spec(shape, want, _ref_mesh(MESHES[mesh]))
        assert isinstance(got, shd.P)
        assert _entries(got) == _entries(ref), (shape, want)


# one path per rule, with a divisible and an odd core shape
RULE_CASES = [
    ("embed", [(151936, 1024), (51866, 1280)]),
    ("pos_emb", [(448, 1280), (7, 33)]),
    ("decoder/0/attn/wk_p/words", [(32, 1024), (5, 80)]),
    ("decoder/3/attn/bv", [(1024,), (80,)]),
    ("decoder/0/attn/wo", [(1024, 1024), (640, 2560)]),
    ("decoder/0/attn/wq_alpha", [(1024,), (10,)]),
    ("decoder/0/attn/bo", [(1024,), (3,)]),
    ("decoder/0/moe/router", [(6144, 8), (4096, 16)]),
    ("decoder/0/moe/w_up_p/words", [(8, 192, 16384), (16, 128, 6400)]),
    ("decoder/0/moe/w_down", [(8, 16384, 6144), (16, 6400, 4096)]),
    ("decoder/1/mlp/w_gate", [(1024, 2816), (2560, 7680)]),
    ("decoder/1/mlp/w_down_p/words", [(88, 1024), (240, 2560)]),
    ("decoder/1/mlp/b_up", [(2816,), (5,)]),
    ("decoder/1/mlp/b_down", [(1024,), (5,)]),
    ("decoder/0/ssm/in_proj", [(4096, 16384), (80, 160)]),
    ("decoder/0/ssm/conv_w", [(8192, 4), (9, 4)]),
    ("decoder/0/ssm/conv_b", [(8192,), (9,)]),
    ("decoder/0/ssm/x_proj", [(8192, 288), (9, 7)]),
    ("decoder/0/ssm/dt_proj", [(256, 8192), (7, 9)]),
    ("decoder/0/ssm/dt_bias", [(8192,), (9,)]),
    ("decoder/0/ssm/A_log", [(8192, 16), (9, 16)]),
    ("decoder/0/ssm/out_proj_p/words", [(256, 4096), (3, 80)]),
    ("decoder/2/lru/gate_proj", [(2560, 2560), (80, 80)]),
    ("decoder/2/lru/conv_w", [(2560, 4), (9, 4)]),
    ("decoder/2/lru/a_param", [(2560,), (9,)]),
    ("decoder/2/lru/out_proj", [(2560, 2560), (80, 80)]),
    ("final_norm/scale", [(1024,), (9,)]),
    ("decoder/0/attn/q_norm_bias", [(64,), (3,)]),
]


def _first_rule(path):
    return next(i for i, (pat, _) in enumerate(jshd._RULES)
                if re.search(pat, path))


def test_rules_are_the_references_and_every_rule_is_covered():
    assert shd._RULES == jshd._RULES
    hit = {_first_rule(p) for p, _ in RULE_CASES}
    assert hit == set(range(len(jshd._RULES)))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("path,shapes", RULE_CASES,
                         ids=[p for p, _ in RULE_CASES])
def test_spec_for_param_equals_reference(path, shapes, stacked):
    for shape in shapes:
        if stacked:
            shape = (4,) + shape
        for mesh in MESHES.values():
            for fsdp in ("data", "__off__", "pod"):
                got = shd.spec_for_param(path, shape, mesh, stacked, fsdp)
                ref = jshd.spec_for_param(path, shape, _ref_mesh(mesh),
                                          stacked, fsdp)
                assert _entries(got) == _entries(ref), (shape, mesh, fsdp)


# ------------------------------------------------------------------ #
# param_specs and batch_specs over the ten archs                       #
# ------------------------------------------------------------------ #
@functools.lru_cache(maxsize=None)
def _params(arch, packed):
    """(port meta tree, reference abstract tree) at published widths."""
    port = tmodels.abstract_params(tconfigs.get_arch(arch))
    ref = jM.abstract_params(jconfigs.get_arch(arch))
    if packed:
        port = pack_model_params(port)
        ref = jax.eval_shape(jpack_model_params, ref)
    return port, ref


def _port_pairs(tree, specs):
    """[(path, spec entries)] with the paths of ``tree``'s leaves."""
    paths = [p for p, _ in ttree.flatten_with_path(tree)[0]]
    leaves = ttree.leaves(specs, is_leaf=lambda s: isinstance(s, shd.P))
    assert len(paths) == len(leaves)
    assert all(isinstance(s, shd.P) for s in leaves)
    return [(p, _entries(s)) for p, s in zip(paths, leaves)]


def _ref_pairs(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, JP))[0]
    return [("/".join(jshd._key_str(k) for k in path), _entries(s))
            for path, s in flat]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    for packed in (False, True):
        port, ref = _params(arch, packed)
        for name, mesh in MESHES.items():
            for fsdp in ("data", "__off__"):
                for prefixes in (("decoder", "encoder"), ("layers",)):
                    got = _port_pairs(port, shd.param_specs(
                        port, mesh, prefixes, fsdp))
                    want = _ref_pairs(jshd.param_specs(
                        ref, _ref_mesh(mesh), prefixes, fsdp))
                    assert got == want, (arch, packed, name, fsdp, prefixes)


def test_param_specs_shard_the_production_mesh():
    """A rule that fires: qwen1.5-0.5b's embedding is vocab on "model",
    d_model on "data", and its stacked projections keep the cycle dim
    whole."""
    port, _ = _params("qwen1.5-0.5b", False)
    specs = shd.param_specs(port, MESHES["16x16"], ("decoder",))
    assert specs["embed"] == shd.P("model", "data")
    wq = ttree.flatten_with_path(specs["decoder"],
                                 is_leaf=lambda s: isinstance(s, shd.P))[0]
    assert any(p.endswith("attn/wq") and s[0] is None for p, s in wq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_reference(arch):
    for shape_name in sorted(tconfigs.SHAPES):
        for kv in ("bf16", "int8"):
            cfg_t = tconfigs.get_arch(arch)
            cfg_j = jconfigs.get_arch(arch)
            if kv == "int8":
                cfg_t = cfg_t.replace(kv_cache_dtype="int8")
                cfg_j = cfg_j.replace(kv_cache_dtype="int8")
            port = tmodels.input_specs(cfg_t, tconfigs.get_shape(shape_name))
            ref = jM.input_specs(cfg_j, jconfigs.get_shape(shape_name))
            for name, mesh in MESHES.items():
                got = _port_pairs(port, shd.batch_specs(port, mesh))
                want = _ref_pairs(jshd.batch_specs(ref, _ref_mesh(mesh)))
                assert got == want, (arch, shape_name, kv, name)


# ------------------------------------------------------------------ #
# shard_act                                                            #
# ------------------------------------------------------------------ #
SITE_MODULES = ("model", "layers", "moe", "ssm", "attention", "rglru",
                "transformer")
ACT_CASES = [("qwen1.5-0.5b", "dense"), ("mixtral-8x22b", "dense"),
             ("mixtral-8x22b", "capacity"), ("mixtral-8x22b", "gather"),
             ("falcon-mamba-7b", "dense"), ("recurrentgemma-2b", "dense")]


def _reference_sites(monkeypatch, cfg, tokens):
    """(shape, want) of every shard_act call the reference's forward
    makes while it is traced."""
    import importlib
    seen = set()

    def record(x, want):
        seen.add((tuple(x.shape), tuple(want)))
        return x
    for name in SITE_MODULES:
        monkeypatch.setattr(importlib.import_module(f"repro.models.{name}"),
                            "shard_act", record)
    params = jM.abstract_params(cfg)
    jax.eval_shape(lambda p, t: jM.forward(p, cfg, t), params, tokens)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("arch,impl", ACT_CASES)
def test_shard_act_sites_and_values(arch, impl, monkeypatch):
    """Inside a 2x2 mesh the port's forward records one spec per site
    the reference constrains (its shapes, its wants through fit_spec)
    and gives the same logits, bit for bit, as outside any mesh."""
    cfg_t = tconfigs.reduced(tconfigs.get_arch(arch)).replace(
        dtype="float32", moe_impl=impl)
    cfg_j = jconfigs.reduced(jconfigs.get_arch(arch)).replace(
        dtype="float32", moe_impl=impl)
    tokens = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (4, 8))
    want_sites = _reference_sites(
        monkeypatch, cfg_j, jax.ShapeDtypeStruct(tokens.shape, np.int32))
    mesh = make_local_mesh(model=2, devices=[torch.device("cpu")] * 4)
    ns = _ref_mesh(mesh)
    want = {(shape, _entries(jshd.fit_spec(shape, w, ns)))
            for shape, w in want_sites}
    params = tmodels.init_params(torch.Generator().manual_seed(0), cfg_t,
                                 device="cpu")
    t = torch.from_numpy(tokens).to(torch.int32)
    outside, _, _ = tmodels.forward(params, cfg_t, t)
    assert len(mesh.constraints) == 0
    with mesh:
        inside, _, _ = tmodels.forward(params, cfg_t, t)
    assert torch.equal(inside, outside)
    got = {(shape, _entries(spec)) for shape, spec in mesh.constraints}
    assert got == want
    assert any(spec != (None,) * len(spec) for _, spec in got)


# ------------------------------------------------------------------ #
# NamedSharding                                                        #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("spec", [shd.P("data", None), shd.P(None, "model"),
                                  shd.P(("data", "model"), None),
                                  shd.P("model", "data"), shd.P()])
def test_named_sharding_shard_and_gather(spec):
    mesh = make_local_mesh(model=2, devices=[torch.device("cpu")] * 4)
    t = torch.arange(8 * 6, dtype=torch.int32).reshape(8, 6)
    sh = shd.named({"w": spec}, mesh)["w"]
    pieces = sh.shard(t)
    assert len(pieces) == 4
    counts = {a: mesh.shape[a] for a in mesh.axis_names}
    for d, entry in enumerate(tuple(spec) + (None,) * (2 - len(spec))):
        axes = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        split = int(np.prod([counts[a] for a in axes]))
        assert all(p.shape[d] == t.shape[d] // split for p in pieces)
    assert torch.equal(sh.gather(pieces), t)
    packed = PackedArray(t.clone(), 6 * 32)
    got = sh.gather(sh.shard(packed))
    assert isinstance(got, PackedArray) and torch.equal(got.words, t)
    with pytest.raises(ValueError, match="split"):
        shd.NamedSharding(mesh, shd.P("data", None)).shard(t[:3])
