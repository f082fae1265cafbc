"""Folded batch norm carried from the reference into the port.

The reference's serving params hold a ``FoldedThreshold(T, flip)``
under ``"t"`` (``quantize_for_serving`` / ``quantize_conv_for_serving``:
gamma < 0 flips the comparison).  Pins (1) that ``params_from_numpy``
turns it into the port's ``FoldedThreshold`` with int32 T and bool
flip; (2) that a small spec with two binary convs and a fused dense
stack of two layers, whose folds include gamma < 0 and gamma == 0
channels at odd K (conv3: 9 * 33 bits; fc2: 47 bits), gives logits on
the port equal to ``repro.graph.compile(spec, backend="xla").apply`` on
the same params.  On the CPU both port backends take the plain
versions; the fold is rewritten at bind time into negated weight rows
and T' = 1 - T, which the fused stack's kernel takes as per-channel
thresholds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import graph as jgraph  # noqa: E402
from repro.core.bnn_layers import (quantize_conv_for_serving,  # noqa: E402
                                   quantize_for_serving)
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.bnn_layers import FoldedThreshold  # noqa: E402
from test_torch_graph import _images, np_tree  # noqa: E402


def _fold_spec(g):
    """conv2 -> 33 channels makes conv3's K = 9 * 33 odd; fc1 -> 47 makes
    fc2's K odd; fc1 + fc2 form one fused stack, fc3 the head."""
    spec = g.BNNSpec("fold", (8, 8, 3), (
        g.IntegerEntry("conv1", 3, 3, 3, 32, 8, 8, 8, 8, 1, 1),
        g.Binarize("binarize@conv2"),
        g.BinaryConv("conv2", 3, 3, 32, 33, 8, 8, 8, 8, 1, 1),
        g.BNThreshold("conv2.bn", 33),
        g.MaxPool("pool@conv2", 2, 2),
        g.BinaryConv("conv3", 3, 3, 33, 32, 4, 4, 4, 4, 1, 1),
        g.BNThreshold("conv3.bn", 32),
        g.BinaryDense("fc1", 512, 47), g.BNThreshold("fc1.bn", 47),
        g.BinaryDense("fc2", 47, 41), g.BNThreshold("fc2.bn", 41),
        g.BinaryDense("fc3", 41, 10), g.Logits("logits", 10)))
    spec.validate()
    return spec


def _bn(rng, n, k):
    """BN statistics of n channels after a K-bit dot: gamma < 0 on about
    a third of them, gamma == 0 on two (one with beta == 0, whose
    threshold stays finite, one with beta != 0, whose folded threshold
    saturates)."""
    mu = rng.normal(0, np.sqrt(k), n).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, n).astype(np.float32) * np.sqrt(k)
    gamma = rng.normal(0, 1, n).astype(np.float32)
    gamma[::3] = -np.abs(gamma[::3])
    beta = rng.normal(0, 1, n).astype(np.float32)
    gamma[1], gamma[4] = 0.0, 0.0
    beta[1] = 0.0
    return mu, sigma, gamma, beta


def _folded_params(spec, seed=0):
    """The reference's params with every binary conv and thresholded
    dense layer replaced by its quantized serving form (a PackedArray
    and a FoldedThreshold)."""
    ref = jgraph.compile(spec, backend="xla")
    params = ref.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    convs = [nd for nd in spec.conv_nodes]
    for i, nd in enumerate(convs):
        if i == 0:                       # the float entry conv
            continue
        w = rng.normal(0, 1, (nd.kh, nd.kw, nd.c_in, nd.c_out))
        wf, fold = quantize_conv_for_serving(
            jnp.asarray(w, jnp.float32),
            *_bn(rng, nd.c_out, nd.kh * nd.kw * nd.c_in))
        params["conv"][i] = {"wf": wf, "t": fold}
    for j, nd in enumerate(spec.dense_nodes):
        if not spec.thresholded(nd):
            continue
        w = rng.normal(0, 1, (nd.n_out, nd.n_in))
        wp, fold = quantize_for_serving(jnp.asarray(w, jnp.float32),
                                        *_bn(rng, nd.n_out, nd.n_in))
        params["fc"][j] = {"wp": wp, "t": fold}
    return ref, params


def test_params_from_numpy_carries_a_folded_threshold():
    spec = _fold_spec(jgraph)
    _, jparams = _folded_params(spec)
    tree = params_from_numpy(np_tree(jparams), "cpu")
    for p in tree["conv"][1:] + tree["fc"][:2]:
        fold = p["t"]
        assert type(fold) is FoldedThreshold
        assert fold.T.dtype == torch.int32 and fold.flip.dtype == torch.bool
    jfold = jparams["fc"][1]["t"]
    np.testing.assert_array_equal(tree["fc"][1]["t"].T.numpy(),
                                  np.asarray(jfold.T))
    np.testing.assert_array_equal(tree["fc"][1]["t"].flip.numpy(),
                                  np.asarray(jfold.flip))
    # the folds flip some channels and keep others
    flips = np.concatenate([np.asarray(p["t"].flip) for p in
                            jparams["conv"][1:] + jparams["fc"][:2]])
    assert flips.any() and not flips.all()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_folded_logits_equal_reference(backend):
    spec = _fold_spec(jgraph)
    ref, jparams = _folded_params(spec)
    x = _images(5, seed=4)
    want = np.asarray(ref.apply(jparams, x))
    cb = tgraph.compile(_fold_spec(tgraph), backend=backend, device="cpu",
                        batch=5)
    assert [s.kind for s in cb.plan].count("fused_stack") == 1
    got = cb.apply(params_from_numpy(np_tree(jparams), "cpu"),
                   torch.from_numpy(x))
    assert got.shape == (5, 10)
    np.testing.assert_array_equal(got.numpy(), want)
