"""The port's data faults (``repro_torch.robustness.inject``) against the
reference's ``repro.robustness.inject``.

The draws are numpy in both packages, so one seed must fault the same
bits: ``flip_bits`` gives the reference's words at 0, 1, 4 and 64
flips on odd-length leaves along every pack axis, with every pad bit 0;
``flip_params`` and ``perturb_thresholds`` give the reference's trees on
BinaryNet's params converted from ``repro.graph.compile(...).init``
(the port cannot repeat jax's draws, ROADMAP hazard 5); ``seu_curve``
and ``threshold_curve`` give the reference's rows exactly on integer
images, the reference on ``"xla"``, the port on both backends on the
CPU.  Also: a FoldedThreshold ``t`` is left alone (the reference
raises there, ROADMAP hazard 13), the words stay on their device, and
the gpu-marked case holds the curves on the card to the CPU's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_inject.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import graph as jgraph  # noqa: E402
from repro.core.bnn_layers import FoldedThreshold as JFolded  # noqa: E402
from repro.core.workloads import binarynet_cifar10 as jbinarynet  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro.robustness import inject as jinject  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch import robustness  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.bnn_layers import FoldedThreshold  # noqa: E402
from repro_torch.core.workloads import binarynet_cifar10  # noqa: E402
from repro_torch.kernels.packed import (PackedArray, as_uint32,  # noqa: E402
                                        unpack_words)
from repro_torch.robustness import inject  # noqa: E402

FLIPS = (0, 1, 4, 64)
# odd logical lengths on every pack axis: (shape, axis)
LEAVES = (((37, 50), -1), ((5, 33, 7), -2), ((3, 3, 45, 9), 2),
          ((1, 1000), -1))


def np_tree(tree):
    """The reference params with every leaf as numpy."""
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


def _pair(shape, axis, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jp = JPacked.pack(jnp.asarray(x), axis=axis)
    tp = PackedArray.pack(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(as_uint32(tp.words), np.asarray(jp.words))
    return jp, tp


def _pad_bits_zero(pa):
    """Every bit at positions >= length on the pack axis is 0."""
    ax = pa.words.ndim + pa.axis
    bits = unpack_words(pa.words, axis=ax, dtype=torch.int32, values="01")
    pad = torch.narrow(bits, ax, pa.length, bits.shape[ax] - pa.length)
    return int(pad.sum()) == 0


@pytest.mark.parametrize("n", FLIPS)
@pytest.mark.parametrize("shape,axis", LEAVES)
def test_flip_bits_words_equal_reference(shape, axis, n):
    jp, tp = _pair(shape, axis)
    want = jinject.flip_bits(jp, n, seed=7)
    got = inject.flip_bits(tp, n, seed=7)
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))
    assert (got.length, got.axis, got.values) == \
        (tp.length, tp.axis, tp.values)
    assert got.words.dtype == torch.int32 and got.words.device == \
        tp.words.device
    assert _pad_bits_zero(got)
    changed = int((got.unpack() != tp.unpack()).sum())
    assert changed == min(n, int(np.prod(shape)))
    if n == 0:
        assert got is tp


def test_flip_bits_clamps_and_rejects_negative():
    _, tp = _pair((3, 5), -1)
    assert int((inject.flip_bits(tp, 10_000).unpack() !=
                tp.unpack()).sum()) == 15
    with pytest.raises(ValueError, match=">= 0"):
        inject.flip_bits(tp, -1)


@pytest.fixture(scope="module")
def binarynet_params():
    """BinaryNet's reference params and their conversion (CPU)."""
    jparams = jgraph.compile(jbinarynet(), backend="xla").init(
        jax.random.PRNGKey(3))
    return jparams, params_from_numpy(np_tree(jparams), "cpu")


def _same_tree(got, want):
    """Leaf by leaf, the port's tree equals the reference's."""
    if isinstance(want, JPacked):
        assert isinstance(got, PackedArray)
        assert (got.length, got.axis) == (want.length, want.axis)
        np.testing.assert_array_equal(as_uint32(got.words),
                                      np.asarray(want.words))
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [0, 1, 16, 4096])
def test_flip_params_equal_reference(binarynet_params, n):
    jparams, params = binarynet_params
    want = jinject.flip_params(jparams, n, seed=11)
    got = inject.flip_params(params, n, seed=11)
    _same_tree(got, want)
    flipped = sum(int((a.unpack() != b.unpack()).sum())
                  for a, b in zip(_packed(got), _packed(params)))
    assert flipped == n


def _packed(tree):
    from repro_torch import tree as ttree
    return [leaf for leaf in ttree.leaves(tree)
            if isinstance(leaf, PackedArray)]


def test_flip_params_needs_packed_leaves():
    with pytest.raises(ValueError, match="no PackedArray"):
        inject.flip_params({"w": torch.zeros(3)}, 1)


@pytest.mark.parametrize("sigma", [0.0, 0.5, 2.0])
def test_perturb_thresholds_equal_reference(binarynet_params, sigma):
    jparams, params = binarynet_params
    want = jinject.perturb_thresholds(jparams, sigma, seed=5)
    got = inject.perturb_thresholds(params, sigma, seed=5)
    _same_tree(got, want)
    ts = [p["t"] for p in got["conv"][1:] + got["fc"][:2]]
    assert all(t.dtype == torch.int32 for t in ts)
    if sigma == 0.0:
        _same_tree(got, jparams)


def test_perturb_thresholds_leaves_folded_threshold_alone():
    """A FoldedThreshold ``t`` is rewritten at bind time, not perturbed.
    The reference raises here (its walk hands a NamedTuple's fields to
    the constructor as one generator); the port keeps the node as its
    docstring says."""
    fold = FoldedThreshold(T=torch.tensor([1, -2, 3], dtype=torch.int32),
                           flip=torch.tensor([True, False, True]))
    tree = {"fc": [{"t": fold, "u": torch.tensor([4], dtype=torch.int32)}]}
    got = inject.perturb_thresholds(tree, 3.0, seed=0)
    out = got["fc"][0]["t"]
    assert isinstance(out, FoldedThreshold)
    assert torch.equal(out.T, fold.T) and torch.equal(out.flip, fold.flip)
    jfold = JFolded(T=jnp.asarray([1, -2, 3], jnp.int32),
                    flip=jnp.asarray([True, False, True]))
    with pytest.raises(TypeError):
        jinject.perturb_thresholds({"fc": [{"t": jfold}]}, 3.0, seed=0)


# ------------------------------------------------------------------ #
# the curves                                                           #
# ------------------------------------------------------------------ #
def _small_spec(g):
    nodes = (g.IntegerEntry("conv1", 3, 3, 3, 32, 8, 8, 8, 8, 1, 1),
             g.Binarize("binarize@conv2"),
             g.BinaryConv("conv2", 3, 3, 32, 64, 8, 8, 8, 8, 1, 1),
             g.BNThreshold("conv2.bn", 64),
             g.MaxPool("pool@conv2", 2, 2),
             g.BinaryDense("fc1", 1024, 48), g.BNThreshold("fc1.bn", 48),
             g.BinaryDense("fc2", 48, 40), g.BNThreshold("fc2.bn", 40),
             g.BinaryDense("fc3", 40, 10), g.Logits("logits", 10))
    spec = g.BNNSpec("small", (8, 8, 3), nodes)
    spec.validate()
    return spec


def _images(n, h, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, size=(n, h, h, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def small_curves():
    ref = jgraph.compile(_small_spec(jgraph), backend="xla")
    jparams = ref.init(jax.random.PRNGKey(0))
    x = _images(16, 8)
    flips, sigmas = (0, 1, 16, 256), (0.0, 0.5, 1.0, 4.0)
    want = (jinject.seu_curve(ref, jparams, jnp.asarray(x), flips, seed=3),
            jinject.threshold_curve(ref, jparams, jnp.asarray(x), sigmas,
                                    seed=3))
    return jparams, x, flips, sigmas, want


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_curves_equal_reference_rows(small_curves, backend):
    jparams, x, flips, sigmas, (seu, thr) = small_curves
    cb = tgraph.compile(_small_spec(tgraph), backend=backend, device="cpu",
                        batch=len(x))
    params = params_from_numpy(np_tree(jparams), "cpu")
    xt = torch.from_numpy(x)
    assert robustness.seu_curve(cb, params, xt, flips, seed=3) == seu
    assert robustness.threshold_curve(cb, params, xt, sigmas, seed=3) == thr
    assert seu[0]["argmax_match"] == 1.0 and thr[0]["max_abs_logit_delta"] \
        == 0.0
    # a baseline given is used as is
    base = cb.apply(params, xt).numpy()
    assert robustness.seu_curve(cb, params, xt, flips[:2], seed=3,
                                baseline=base) == seu[:2]


def test_binarynet_curves_equal_reference_rows(binarynet_params):
    jparams, params = binarynet_params
    ref = jgraph.compile(jbinarynet(), backend="xla")
    x = _images(2, 32, seed=1)
    flips, sigmas = (0, 64, 4096), (0.0, 2.0)
    cb = tgraph.compile(binarynet_cifar10(), device="cpu", batch=2)
    xt = torch.from_numpy(x)
    assert robustness.seu_curve(cb, params, xt, flips, seed=1) == \
        jinject.seu_curve(ref, jparams, jnp.asarray(x), flips, seed=1)
    assert robustness.threshold_curve(cb, params, xt, sigmas, seed=1) == \
        jinject.threshold_curve(ref, jparams, jnp.asarray(x), sigmas,
                                seed=1)


def test_curves_refuse_a_packed_output():
    cb = tgraph.compile_dense_stack(64, [32], [True], device="cpu")
    params = cb.init(torch.Generator().manual_seed(0))
    xp = PackedArray.pack(torch.randn(3, 64))
    with pytest.raises(ValueError, match="float logits"):
        robustness.seu_curve(cb, params, xp, [1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_curves_equal_the_cpu(cuda):
    spec = _small_spec(tgraph)
    cpu = tgraph.compile(spec, backend="torch", device="cpu", batch=16)
    card = tgraph.compile(spec, device="cuda", batch=16)
    params = cpu.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(16, 8))
    dparams = params_from_numpy(np_tree_torch(params), "cuda")
    for fn, pts in ((robustness.seu_curve, (0, 1, 16, 256)),
                    (robustness.threshold_curve, (0.0, 0.5, 4.0))):
        assert fn(card, dparams, x.cuda(), pts, seed=2) == \
            fn(cpu, params, x, pts, seed=2)
    flipped = inject.flip_params(dparams, 64, seed=1)
    assert all(p.words.is_cuda for p in _packed(flipped))


def np_tree_torch(tree):
    """A port params tree as the numpy form params_from_numpy takes."""
    if isinstance(tree, PackedArray):
        return {"words": as_uint32(tree.words), "length": tree.length,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: np_tree_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree_torch(v) for v in tree)
    return tree.cpu().numpy()
