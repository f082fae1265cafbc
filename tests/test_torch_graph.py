"""The port's compiled BNN end to end against the JAX reference.

Pins (1) a small spec (integer entry, binarize, two binary convs with
a pool, a thresholded dense pair and a head) through both packages with
the reference's params carried across by params_from_numpy: the port's
logits on the CPU equal repro.graph.compile(spec, backend="xla").apply
exactly, on both port backends; (2) full-width BinaryNet CIFAR-10 at
batch 2, the same way; (3) the float entry conv split: to a tolerance
on normal inputs, then exact from the binarize step on when both
packages are fed the reference's conv output; (4) the plan: 8 kernel
launches, shared memory and not VMEM in describe(); (5) the port's
rules: no jax and no repro import anywhere in src/repro_torch or
chip_smoke.py, and compile() without a device raises on a host with no
CUDA.  Images are integer-valued in [-3, 3], so the float entry conv
sums exactly in any order and logits compare with assert_array_equal.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import graph as jgraph  # noqa: E402
from repro.core.bnn_layers import binary_weight_conv as jentry  # noqa: E402
from repro.core.workloads import alexnet_imagenet as jalexnet  # noqa: E402
from repro.core.workloads import binarynet_cifar10 as jbinarynet  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.bnn_layers import binary_weight_conv  # noqa: E402
from repro_torch.core.workloads import (alexnet_imagenet,  # noqa: E402
                                        binarynet_cifar10)
from repro_torch.kernels import packed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def np_tree(tree):
    """The reference params with every leaf as numpy — the form
    params_from_numpy takes."""
    if isinstance(tree, JPacked):
        return {"words": np.asarray(tree.words), "length": tree.length,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(np_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


def _small_nodes(g, entry=True):
    nodes = [g.IntegerEntry("conv1", 3, 3, 3, 32, 8, 8, 8, 8, 1, 1)] \
        if entry else []
    return nodes + [
        g.Binarize("binarize@conv2"),
        g.BinaryConv("conv2", 3, 3, 32, 64, 8, 8, 8, 8, 1, 1),
        g.BNThreshold("conv2.bn", 64),
        g.MaxPool("pool@conv2", 2, 2),
        g.BinaryConv("conv3", 3, 3, 64, 32, 4, 4, 4, 4, 1, 1),
        g.BNThreshold("conv3.bn", 32),
        g.BinaryDense("fc1", 512, 48), g.BNThreshold("fc1.bn", 48),
        g.BinaryDense("fc2", 48, 40), g.BNThreshold("fc2.bn", 40),
        g.BinaryDense("fc3", 40, 10), g.Logits("logits", 10)]


def _small_spec(g, entry=True):
    shape = (8, 8, 3) if entry else (8, 8, 32)
    spec = g.BNNSpec("small", shape, tuple(_small_nodes(g, entry)))
    spec.validate()
    return spec


def _images(n, h=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, size=(n, h, h, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def small_ref():
    """The reference's small net, its params and logits on 5 images
    (shared: tracing the reference dominates these tests' time)."""
    ref = jgraph.compile(_small_spec(jgraph), backend="xla")
    jparams = ref.init(jax.random.PRNGKey(0))
    x = _images(5)
    return jparams, x, np.asarray(ref.apply(jparams, x))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_small_spec_logits_equal_reference(small_ref, backend):
    jparams, x, want = small_ref
    cb = tgraph.compile(_small_spec(tgraph), backend=backend, device="cpu",
                        batch=5)
    params = params_from_numpy(np_tree(jparams), "cpu")
    got = cb.apply(params, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (5, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    # valid_rows keeps the first rows, bit-identically
    np.testing.assert_array_equal(
        cb.apply(params, torch.from_numpy(x), valid_rows=3).numpy(),
        want[:3])
    kinds = [s.kind for s in cb.plan]
    assert kinds.count("fused_stack") == 1 and cb.launch_count() == 5


def test_binarynet_full_width_logits_equal_reference():
    ref = jgraph.compile(jbinarynet(), backend="xla")
    jparams = ref.init(jax.random.PRNGKey(1))
    x = _images(2, h=32, seed=1)
    want = np.asarray(ref.apply(jparams, x))
    cb = tgraph.compile(binarynet_cifar10(), device="cpu", batch=2)
    got = cb.apply(params_from_numpy(np_tree(jparams), "cpu"),
                   torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_alexnet_full_width_logits_equal_reference():
    """XNOR-AlexNet at full width, batch 1: two float entry convs
    (conv1, conv2) with float pools, then 6 launches on the port's plan
    (pack, 3 packed_conv2d, fc6+fc7 fused, fc8) where the reference
    chains layer by layer; only the logits must match, and they do
    exactly."""
    ref = jgraph.compile(jalexnet(), backend="xla")
    jparams = ref.init(jax.random.PRNGKey(0))
    x = _images(1, h=227, seed=3)
    want = np.asarray(ref.apply(jparams, x))
    cb = tgraph.compile(alexnet_imagenet(), device="cpu", batch=1)
    assert cb.launch_count() == 6
    got = cb.apply(params_from_numpy(np_tree(jparams), "cpu"),
                   torch.from_numpy(x))
    assert got.shape == (1, 1000) and want.shape == (1, 1000)
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_conv_within_tolerance_then_exact_from_binarize(small_ref):
    """Normal inputs: the float entry conv's summation order differs
    (rtol 1e-5, atol 1e-4); from the binarize step on, fed the
    reference's conv output, the port is exact."""
    jparams = small_ref[0]
    params = params_from_numpy(np_tree(jparams), "cpu")
    x = np.random.default_rng(2).standard_normal((4, 8, 8, 3)
                                                 ).astype(np.float32)
    p0 = jparams["conv"][0]
    h_ref = np.array(jentry(x, p0["w"], padding=1, alpha=p0["alpha"]))
    h_port = binary_weight_conv(torch.from_numpy(x), params["conv"][0]["w"],
                                padding=1, alpha=params["conv"][0]["alpha"])
    np.testing.assert_allclose(h_port.numpy(), h_ref, rtol=1e-5, atol=1e-4)

    jtail = jgraph.compile(_small_spec(jgraph, entry=False), backend="xla")
    jtail_params = {"conv": jparams["conv"][1:], "fc": jparams["fc"]}
    want = np.asarray(jtail.apply(jtail_params, h_ref))
    ttail = tgraph.compile(_small_spec(tgraph, entry=False), device="cpu")
    got = ttail.apply({"conv": params["conv"][1:], "fc": params["fc"]},
                      torch.from_numpy(h_ref))
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_at_binarize_composes_to_apply(small_ref):
    """head then tail is apply, and the head ends in float activations:
    the cut the card-vs-CPU check of the float entry layers uses."""
    jparams, x, want = small_ref
    cb = tgraph.compile(_small_spec(tgraph), device="cpu", batch=5)
    params = params_from_numpy(np_tree(jparams), "cpu")
    head, tail = cb.split("binarize@conv2")
    assert [s.kind for s in head.plan] == ["integer_conv"]
    assert tail.plan[0].kind == "binarize"
    assert head.launch_count() + tail.launch_count() == cb.launch_count()
    h = head.apply(params, torch.from_numpy(x))
    assert h.dtype == torch.float32 and h.shape == (5, 8, 8, 32)
    np.testing.assert_array_equal(tail.apply(params, h).numpy(), want)
    with pytest.raises(ValueError, match="no plan step"):
        cb.split("conv9")


def test_split_head_keeps_the_alpha_multiply(small_ref):
    """A head cut off before binarize@conv2 has no pack to hand conv1's
    alpha to: it returns the scaled float activations, equal to the
    reference's entry conv (integer images: exact)."""
    jparams, x, _ = small_ref
    cb = tgraph.compile(_small_spec(tgraph), device="cpu", batch=5)
    head, _ = cb.split("binarize@conv2")
    assert head.plan[0].args["epilogue"] == "alpha"
    assert cb.plan[0].args["epilogue"] != "alpha"
    h = head.apply(params_from_numpy(np_tree(jparams), "cpu"),
                   torch.from_numpy(x))
    p0 = jparams["conv"][0]
    np.testing.assert_array_equal(
        h.numpy(), np.asarray(jentry(x, p0["w"], padding=1,
                                     alpha=p0["alpha"])))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_apply_hands_the_entry_alpha_to_the_pack(small_ref, monkeypatch,
                                                 backend):
    """conv1 followed by binarize@conv2: apply leaves the alpha multiply
    to the pack (binary_weight_conv, the scaled entry conv, is not
    called), and the logits equal the reference's.  On "torch"
    binarize_pack gets conv1's alpha as its scale; on "cuda" the
    entry_conv op takes it and packs in its epilogue, so binarize_pack
    gets no alpha."""
    jparams, x, want = small_ref
    import importlib
    tcompile = importlib.import_module("repro_torch.graph.compile")
    from repro_torch.kernels import entry_conv as tentry
    from repro_torch.kernels import ops as tops
    seen, fused = [], []
    real = tops.binarize_pack
    real_fused = tentry.entry_conv

    def recording(h, backend=None, scale=None):
        seen.append(scale)
        return real(h, backend=backend, scale=scale)

    def recording_fused(h, w, alpha, stride=1, padding="same"):
        fused.append(alpha)
        return real_fused(h, w, alpha, stride=stride, padding=padding)

    monkeypatch.setattr(tops, "binarize_pack", recording)
    monkeypatch.setattr(tentry, "entry_conv", recording_fused)
    monkeypatch.setattr(tcompile, "binary_weight_conv", None)
    cb = tgraph.compile(_small_spec(tgraph), backend=backend, device="cpu",
                        batch=5)
    params = params_from_numpy(np_tree(jparams), "cpu")
    got = cb.apply(params, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    alpha = params["conv"][0]["alpha"]
    if backend == "cuda":
        assert len(fused) == 1 and fused[0] is alpha
    else:
        # the "torch" backend's binary layers pack their outputs through
        # binarize_pack too, with no scale
        assert not fused and seen[0] is alpha
        seen = seen[1:]
    assert all(scale is None for scale in seen)


def test_which_entry_convs_leave_their_alpha_to_the_pack():
    """Decided in the plan, with no step kind of its own: BinaryNet's
    conv1 (a binarize follows) leaves it; AlexNet's conv1 and conv2 (a
    float pool follows each) keep theirs; kinds, names and launch
    counts are unchanged."""
    for workload, want, launches in ((binarynet_cifar10(), [True], 8),
                                     (alexnet_imagenet(), [False, False],
                                      6)):
        cb = tgraph.compile(workload, device="cpu")
        got = [s.args["epilogue"] != "alpha" for s in cb.plan
               if s.kind == "integer_conv"]
        assert got == want and cb.launch_count() == launches
        assert "integer_conv" in [s.kind for s in cb.plan]


def test_binarynet_plan_and_describe():
    cb = tgraph.compile(binarynet_cifar10(), device="cpu", batch=256)
    assert cb.launch_count() == 8 and cb.legacy_launch_count() == 9
    kinds = [s.kind for s in cb.plan]
    assert kinds.count("binary_conv") == 5
    assert kinds.count("fused_stack") == 1 and kinds.count("dense") == 1
    text = cb.describe()
    assert "shared memory" in text and "VMEM" not in text
    assert all(s.args.get("impl", "direct") == "direct" for s in cb.plan)
    forced = tgraph.compile(binarynet_cifar10(), device="cpu",
                            conv_impl="im2col")
    assert {s.args["impl"] for s in forced.plan
            if s.kind == "binary_conv"} == {"im2col"}
    t = cb.traffic(batch=1)
    assert t["ratio_bf16_over_packed"] > 1


def test_init_tree_and_shapes_match_reference(small_ref):
    jp = np_tree(small_ref[0])
    cb = tgraph.compile(_small_spec(tgraph), device="cpu")
    tp = cb.init(torch.Generator().manual_seed(0))
    assert len(tp["conv"]) == len(jp["conv"])
    assert len(tp["fc"]) == len(jp["fc"])
    for a, b in zip(tp["conv"] + tp["fc"], jp["conv"] + jp["fc"]):
        assert set(a) == set(b)
        for key in a:
            if isinstance(a[key], packed.PackedArray):
                assert tuple(a[key].words.shape) == b[key]["words"].shape
                assert (a[key].length, a[key].axis) == \
                    (b[key]["length"], b[key]["axis"])
            else:
                assert tuple(a[key].shape) == b[key].shape
    again = cb.init(torch.Generator().manual_seed(0))
    assert torch.equal(again["fc"][0]["wp"].words, tp["fc"][0]["wp"].words)


def test_params_from_numpy_keeps_bit_patterns():
    words = np.array([[0, 1, 2 ** 31, 2 ** 32 - 1]], np.uint32)
    tree = params_from_numpy({"fc": [{"wp": {"words": words, "length": 100,
                                             "axis": -1},
                                      "t": np.arange(3, dtype=np.int32)}]},
                             "cpu")
    wp = tree["fc"][0]["wp"]
    assert isinstance(wp, packed.PackedArray) and wp.length == 100
    np.testing.assert_array_equal(packed.as_uint32(wp.words), words)
    assert tree["fc"][0]["t"].dtype == torch.int32
    with pytest.raises(TypeError):
        params_from_numpy({"x": 3}, "cpu")


def test_compile_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tgraph.compile(binarynet_cifar10())
    with pytest.raises(RuntimeError):
        tgraph.compile(binarynet_cifar10(), device="cuda")
    assert tgraph.compile(binarynet_cifar10(), device="cpu").device.type \
        == "cpu"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 10
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    for module in ("graph/replay.py", "serving/server.py",
                   "serving/placement.py", "serving/bucketing.py",
                   "serving/errors.py", "runtime/straggler.py",
                   "robustness/chaos.py", "core/binarize.py",
                   "data/images.py", "data/pipeline.py", "tree.py",
                   "optim/adamw.py", "checkpoint/checkpointer.py",
                   "train/models.py", "train/loop.py", "train/export.py",
                   "core/isa.py", "core/threshold.py", "core/schedules.py",
                   "core/adder_tree.py", "core/tulip_pe.py",
                   "core/mapping.py", "core/energy.py", "sim/__init__.py",
                   "sim/mesh.py", "sim/simulator.py", "sim/dse.py",
                   "configs/base.py", "configs/registry.py",
                   "configs/qwen15_05b.py", "models/layers.py",
                   "models/attention.py", "models/moe.py", "models/ssm.py",
                   "models/rglru.py", "models/transformer.py",
                   "models/quantize.py", "models/model.py",
                   "launch/serve.py", "robustness/inject.py",
                   "kernels/autotune.py", "graph/tuning.py",
                   "analysis/lint.py", "analysis/audit.py",
                   "analysis/rules/layering.py", "runtime/op_cost.py",
                   "launch/dryrun.py", "launch/mesh.py",
                   "runtime/sharding.py", "launch/train.py",
                   "runtime/compression.py"):
        assert f"src/repro_torch/{module}" in scanned, module
    for twin in ("quickstart", "serve_bnn", "train_bnn_lm",
                 "tulip_asic_sim"):
        assert f"examples/torch_{twin}.py" in scanned, twin
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    # torch's fake process group is a test utility: only the mesh module
    # (``fake_world``) imports it
    fake = sorted(f.relative_to(ROOT).as_posix() for f in files
                  if any("fake_pg" in m for m in _imports(f)))
    assert fake == ["src/repro_torch/launch/mesh.py"], fake
