"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

* ``cell_config`` gives the reference ``build_cell``'s config for every
  arch x shape x variant (the reference is stopped right after its
  config rules, at its first ``abstract_params`` call, so nothing is
  traced);
* ``build_cell``'s meta params (packed where the variant packs) and
  inputs (decode caches included, int8 where the variant says) match
  ``jax.eval_shape`` of the reference's, leaf for leaf in shape and
  dtype, at full size;
* the memory tracker's peak equals between a meta run and a real CPU
  run of the same reduced cell (train, prefill, decode);
* ``run_cell``'s record has the reference's keys, skips with the
  reference's reason, and one full-size cell runs through the CLI;
* ``cut_depth`` refuses a cut that would change a stack's cycle.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.quantize import \
    pack_model_params as jpack_model_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.kernels.packed import PackedArray  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import op_cost  # noqa: E402

from test_torch_models import _shape_tree  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH_IDS = list(jconfigs.ARCHS)
RECORD_KEYS = {"arch", "shape", "mesh", "variant", "applicable", "memory",
               "cost", "cost2", "collectives", "n_params",
               "n_params_active", "ok", "wall_s"}


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without its import-time
    ``XLA_FLAGS`` (512 host devices) leaking into this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


class _Config(Exception):
    def __init__(self, cfg):
        super().__init__("config")
        self.cfg = cfg


def _reference_config(jdry, monkeypatch, arch, shape, variant):
    """The config the reference's build_cell compiles a cell with."""
    stub = type("M", (), {"abstract_params": staticmethod(
        lambda cfg: (_ for _ in ()).throw(_Config(cfg)))})
    monkeypatch.setattr(jdry, "M", stub)
    try:
        jdry.build_cell(arch, shape, None, variant)
    except _Config as got:
        return got.cfg
    raise AssertionError("the reference's build_cell never reached its "
                         "params")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_config_equals_the_reference(arch, monkeypatch):
    jdry = _reference_dryrun()
    for shape in sorted(tconfigs.SHAPES):
        for variant in dryrun.VARIANTS:
            want = _reference_config(jdry, monkeypatch, arch, shape,
                                     variant)
            got = dryrun.cell_config(arch, shape, variant)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (arch, shape, variant)


def _shapes(tree):
    """{path: (shape, dtype)} with a PackedArray as its words."""
    def unpack(t):
        if isinstance(t, PackedArray):
            return {"words": t.words}
        if isinstance(t, dict):
            return {k: unpack(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(unpack(v) for v in t)
        return t

    def ref_words(t):
        from repro.kernels.packed import PackedArray as JPacked
        if isinstance(t, JPacked):
            return {"words": t.words}
        if isinstance(t, dict):
            return {k: ref_words(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(ref_words(v) for v in t)
        return t
    out = _shape_tree(ref_words(unpack(tree)))
    # the port carries uint32 words as int32 (the same bits)
    return {k: (s, "uint32" if d == "int32" and k.endswith("/words")
                else d) for k, (s, d) in out.items()}


# the variants that change params or inputs
ARG_VARIANTS = ("baseline", "packed", "kv_int8", "tp_only_packed_kv8")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_args_match_the_reference(arch, monkeypatch):
    """Full size: the cell's meta params (packed trees through
    pack_model_params) and inputs (caches included) against
    jax.eval_shape of the reference's, leaf for leaf."""
    jdry = _reference_dryrun()
    for variant in ARG_VARIANTS:
        params_done = False
        for shape in ("decode_32k", "train_4k", "prefill_32k"):
            cfg_j = _reference_config(jdry, monkeypatch, arch, shape,
                                      variant)
            monkeypatch.undo()
            cfg, fn, args = dryrun.build_cell(arch, shape, variant)
            if not params_done:
                want = jM.abstract_params(cfg_j)
                if dryrun._packs(variant):
                    want = jax.eval_shape(jpack_model_params, want)
                assert _shapes(args[0]) == _shapes(want), (arch, variant)
                assert all(t.device.type == "meta"
                           for t in ttree.leaves(args[0])
                           if isinstance(t, torch.Tensor))
                params_done = True
            want_in = jM.input_specs(cfg_j, jconfigs.get_shape(shape))
            assert _shapes(args[-1]) == _shapes(want_in), \
                (arch, variant, shape)


SMALL = {"train": tconfigs.ShapeConfig("t", 16, 2, "train"),
         "prefill": tconfigs.ShapeConfig("p", 16, 2, "prefill"),
         "decode": tconfigs.ShapeConfig("d", 16, 2, "decode")}


def _real(tree, gen):
    """A meta tree as real CPU tensors (random floats, zero ints)."""
    def leaf(t):
        if isinstance(t, PackedArray):
            return t.with_words(torch.zeros(t.words.shape,
                                            dtype=t.words.dtype))
        if t.is_floating_point():
            return torch.randn(t.shape, generator=gen).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    return ttree.map(leaf, tree)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x22b",
                                  "falcon-mamba-7b"])
@pytest.mark.parametrize("kind", list(SMALL))
def test_memory_tracker_meta_equals_cpu(arch, kind):
    """The same reduced cell on meta tensors and on real CPU tensors:
    the tracker's peak and live bytes and the cost are equal."""
    cfg = tconfigs.reduced(tconfigs.get_arch(arch)).replace(
        dtype="float32", remat="full", attn_q_chunk=8, attn_kv_chunk=8)
    shape = SMALL[kind]
    _, fn, meta_args = dryrun.build_cell(arch, shape.name, "baseline",
                                         cfg, shape)
    with op_cost.Counter() as on_meta:
        fn(*meta_args)
    gen = torch.Generator().manual_seed(0)
    params = tmodels.init_params(gen, cfg, device="cpu")
    inputs = _real(meta_args[-1], gen)
    if kind == "train":
        cpu_args = (params, adamw.init(params), inputs)
    else:
        cpu_args = (params, inputs)
    with op_cost.Counter() as on_cpu:
        fn(*cpu_args)
    assert on_meta.peak_bytes > 0
    assert on_cpu.peak_bytes == on_meta.peak_bytes, (arch, kind)
    assert (on_cpu.cost.flops, on_cpu.cost.bytes) == \
        (on_meta.cost.flops, on_meta.cost.bytes)


def test_run_cell_record_and_skip_reason():
    rec = dryrun.run_cell("qwen1.5-0.5b", "long_500k")
    ok, why = jconfigs.shape_applicable(jconfigs.get_arch("qwen1.5-0.5b"),
                                        jconfigs.get_shape("long_500k"))
    assert (rec["applicable"], rec["skip_reason"]) == (False, why)
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k",
                          variant="kv_int8")
    assert rec["ok"], rec.get("traceback")
    assert RECORD_KEYS <= set(rec)
    cfg = tconfigs.get_arch("qwen1.5-0.5b")
    assert (rec["n_params"], rec["n_params_active"]) == \
        (cfg.param_count(), cfg.param_count(active_only=True))
    mem = rec["memory"]
    caches = dryrun._nbytes(tmodels.input_specs(
        cfg.replace(kv_cache_dtype="int8"),
        tconfigs.get_shape("decode_32k")))
    params = dryrun._nbytes(tmodels.abstract_params(cfg))
    assert mem["argument_size_in_bytes"] == caches + params
    # the step returns new caches: the output holds them
    assert mem["output_size_in_bytes"] >= caches
    assert rec["cost2"]["flops"] >= rec["cost"]["flops"] > 0
    with pytest.raises(ValueError, match="one card"):
        dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "multi")


def test_cut_depth_keeps_the_cycle():
    cfg = tconfigs.get_arch("recurrentgemma-2b")     # 26 = 8 x 3 + 2
    with pytest.raises(ValueError, match="changes its cycle"):
        dryrun.cut_depth(cfg, {"decoder": 1})
    cut = dryrun.cut_depth(cfg, {"decoder": 2})
    assert cut.num_layers == 8
    assert dryrun._base_cut(cfg, {"decoder": 8}) == {"decoder": 2}
    assert dryrun._base_cut(tconfigs.get_arch("qwen1.5-0.5b"),
                            {"decoder": 24}) == {"decoder": 1}


def test_cli_runs_one_full_size_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mixtral-8x22b", "--shape", "prefill_32k", "--variant", "packed",
         "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[OK] mixtral-8x22b x prefill_32k x one_card" in proc.stdout
    rec = json.loads((tmp_path / "mixtral-8x22b__prefill_32k__one_card__"
                      "packed.json").read_text())
    assert RECORD_KEYS <= set(rec) and rec["ok"]
    assert rec["cost2"]["collective_bytes"] == 0.0


@pytest.mark.parametrize("impl", ["dense", "capacity", "gather"])
def test_moe_reads_nothing_back_from_the_device(impl):
    """The repair behind the meta == CPU count: ``F.one_hot`` checked its
    indices with two host reads a call on the CPU (and dispatched other
    ops on meta); ``moe.one_hot`` is a compare with an iota, the same
    values, no read, the same ops on every device."""
    from repro_torch.models import moe
    cfg = tconfigs.reduced(tconfigs.get_arch("mixtral-8x22b")).replace(
        dtype="float32", moe_impl=impl)
    params = tmodels.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    with op_cost.Counter() as c:
        tmodels.forward(params, cfg, tokens)
    assert not any("_local_scalar_dense" in op for op in c.by_op)
    idx = torch.randint(0, 8, (3, 5, 2))
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        assert torch.equal(moe.one_hot(idx, 8, dt),
                           torch.nn.functional.one_hot(idx, 8).to(dt))
