"""The port's training-side binarized layers against the reference's.

``repro_torch.core.binarize`` and the training/export half of
``repro_torch.core.bnn_layers`` on the same numpy inputs as
``repro.core.binarize`` / ``repro.core.bnn_layers``:

* ``ste_sign``: forward and gradient exactly equal, at x = 0, |x| = 1
  and the floats either side of them;
* ``binarize_weights``, ``pack_bits`` / ``unpack_bits``,
  ``xnor_popcount_dot`` (odd K, mismatched word counts) and
  ``sign_dot_reference``: exact;
* ``fold_bn_threshold``, ``quantize_for_serving`` and
  ``quantize_conv_for_serving``: T, flip and the packed words exactly
  equal at odd K, with gamma < 0 channels and gamma == 0 channels (one
  with beta == 0, one whose threshold saturates the int32 range);
* ``apply_folded``, ``bnn_dense_serve_folded`` and the
  ``bnn_mlp_serve_folded`` shim over ``graph.serve_folded_stack``:
  exact; ``bn_reference`` and ``bnn_dense_train`` (values and
  gradients) within rtol 1e-6, atol 1e-6 (float32 sums in another
  order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import binarize as jb  # noqa: E402
from repro.core import bnn_layers as jl  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro_torch.core import binarize as tb  # noqa: E402
from repro_torch.core import bnn_layers as tl  # noqa: E402
from repro_torch.kernels.packed import PackedArray, as_uint32  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq_fold(got, want):
    np.testing.assert_array_equal(got.T.numpy(), np.asarray(want.T))
    np.testing.assert_array_equal(got.flip.numpy(), np.asarray(want.flip))
    assert got.T.dtype == torch.int32 and got.flip.dtype == torch.bool


def _eq_packed(got: PackedArray, want: JPacked):
    assert (got.length, got.axis) == (want.length, want.axis)
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))


def test_ste_sign_forward_and_gradient_exact():
    one = np.float32(1.0)
    x = np.array([0.0, -0.0, 1.0, -1.0, np.nextafter(one, np.float32(2)),
                  -np.nextafter(one, np.float32(2)),
                  np.nextafter(one, np.float32(0)), 1e-30, -1e-30, 0.5,
                  -3.0, 7.0], np.float32)
    g = np.arange(1, x.size + 1, dtype=np.float32)
    jy, vjp = jax.vjp(jb.ste_sign, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    ty = tb.ste_sign(xt)
    (tg,) = torch.autograd.grad(ty, xt, _t(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # x >= 0 -> +1 (-0.0 included); |x| <= 1 passes the gradient
    assert ty[0] == 1 and ty[1] == 1 and tg[2] == 3 and tg[4] == 0


@pytest.mark.parametrize("axis", [0, 1])
def test_binarize_weights_equal(axis):
    w = np.random.default_rng(0).normal(size=(6, 37)).astype(np.float32)
    jwb, ja = jb.binarize_weights(jnp.asarray(w), axis=axis)
    twb, ta = tb.binarize_weights(_t(w).requires_grad_(True), axis=axis)
    np.testing.assert_array_equal(twb.detach().numpy(), np.asarray(jwb))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    assert not ta.requires_grad and twb.requires_grad
    _, ja1 = jb.binarize_weights(jnp.asarray(w), per_channel_scale=False)
    _, ta1 = tb.binarize_weights(_t(w), per_channel_scale=False)
    np.testing.assert_allclose(ta1.numpy(), np.asarray(ja1), **TOL)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 97])
def test_pack_and_packed_dot_equal(k):
    rng = np.random.default_rng(k)
    x = rng.choice([-1.0, 1.0], size=(3, 5, k)).astype(np.float32)
    w = rng.choice([-1.0, 1.0], size=(7, k)).astype(np.float32)
    tw = tb.pack_bits(_t(x))
    np.testing.assert_array_equal(as_uint32(tw), np.asarray(jb.pack_bits(x)))
    np.testing.assert_array_equal(
        tb.unpack_bits(tw, dtype=torch.float32)[..., :k].numpy(), x)
    xp = PackedArray.pack(_t(x))
    wp = PackedArray.pack(_t(w))
    want = np.asarray(jb.xnor_popcount_dot(JPacked.pack(jnp.asarray(x)),
                                           JPacked.pack(jnp.asarray(w))))
    got = tb.xnor_popcount_dot(xp, wp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tb.sign_dot_reference(_t(x), _t(w)).numpy(),
        np.asarray(jb.sign_dot_reference(x, w)))
    # raw words with an explicit n, one operand padded by a word
    wide = torch.nn.functional.pad(wp.words, (0, 1))
    np.testing.assert_array_equal(
        tb.xnor_popcount_dot(xp.words, wide, n=k).numpy(), want)
    with pytest.raises(ValueError, match="mismatch"):
        tb.xnor_popcount_dot(xp, wp, n=k + 1)
    with pytest.raises(ValueError, match="n is required"):
        tb.xnor_popcount_dot(xp.words, wp.words)


def _bn(rng, n, k):
    """BN statistics of n channels after a K-bit dot: gamma < 0 on a
    third, gamma == 0 on two channels (beta == 0: a finite threshold;
    beta != 0: the threshold saturates)."""
    mu = rng.normal(0, np.sqrt(k), n).astype(np.float32)
    sigma = rng.uniform(0.5, 2.0, n).astype(np.float32) * np.sqrt(k)
    gamma = rng.normal(0, 1, n).astype(np.float32)
    gamma[::3] = -np.abs(gamma[::3])
    beta = rng.normal(0, 1, n).astype(np.float32)
    gamma[1], gamma[4] = 0.0, 0.0
    beta[1] = 0.0
    return mu, sigma, gamma, beta


@pytest.mark.parametrize("k", [33, 97, 128])
def test_fold_bn_threshold_and_apply_equal(k):
    rng = np.random.default_rng(k)
    mu, sigma, gamma, beta = _bn(rng, 24, k)
    want = jl.fold_bn_threshold(mu, sigma, gamma, beta, k)
    got = tl.fold_bn_threshold(_t(mu), _t(sigma), _t(gamma), _t(beta), k)
    _eq_fold(got, want)
    assert int(got.T[4]) in (2 ** 31 - 1, -2 ** 31)    # saturated
    s = rng.integers(-k, k + 1, size=(5, 24)).astype(np.int32)
    np.testing.assert_array_equal(tl.apply_folded(_t(s), got).numpy(),
                                  np.asarray(jl.apply_folded(s, want)))
    sf = s.astype(np.float32)
    np.testing.assert_allclose(
        tl.bn_reference(_t(sf), _t(mu), _t(sigma), _t(gamma),
                        _t(beta)).numpy(),
        np.asarray(jl.bn_reference(sf, mu, sigma, gamma, beta)), **TOL)


@pytest.mark.parametrize("k", [47, 64, 99])
def test_quantize_for_serving_equal(k):
    rng = np.random.default_rng(k)
    n = 21
    w = rng.normal(size=(n, k)).astype(np.float32)
    w[3] = 0.0                                  # alpha == 0
    stats = _bn(rng, n, k)
    jwp, jfold = jl.quantize_for_serving(w, *stats)
    twp, tfold = tl.quantize_for_serving(_t(w), *map(_t, stats))
    _eq_packed(twp, jwp)
    _eq_fold(tfold, jfold)
    # the folded serve path of one layer on packed +-1 rows
    x = rng.choice([-1.0, 1.0], size=(6, k)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.bnn_dense_serve_folded(PackedArray.pack(_t(x)), twp,
                                  tfold).numpy(),
        np.asarray(jl.bnn_dense_serve_folded(JPacked.pack(jnp.asarray(x)),
                                             jwp, jfold)))


@pytest.mark.parametrize("c_in", [8, 33])
def test_quantize_conv_for_serving_equal(c_in):
    rng = np.random.default_rng(c_in)
    f = 19
    w = rng.normal(size=(3, 3, c_in, f)).astype(np.float32)
    stats = _bn(rng, f, 9 * c_in)
    jwf, jfold = jl.quantize_conv_for_serving(w, *stats)
    twf, tfold = tl.quantize_conv_for_serving(_t(w), *map(_t, stats))
    _eq_packed(twf, jwf)
    _eq_fold(tfold, jfold)


def test_mlp_serve_folded_shim_equal():
    """Two quantized layers (odd K = 47 for the second) through the
    deprecated shim: the port compiles a dense stack on the input's
    device (the CPU here) and its packed output equals the
    reference's."""
    rng = np.random.default_rng(5)
    k0, ns = 70, [47, 33]
    jlayers, tlayers, k = [], [], k0
    for n in ns:
        w = rng.normal(size=(n, k)).astype(np.float32)
        stats = _bn(rng, n, k)
        jlayers.append(jl.quantize_for_serving(w, *stats))
        tlayers.append(tl.quantize_for_serving(_t(w), *map(_t, stats)))
        k = n
    x = rng.choice([-1.0, 1.0], size=(9, k0)).astype(np.float32)
    want = jl.bnn_mlp_serve_folded(JPacked.pack(jnp.asarray(x)), jlayers,
                                   backend="xla")
    got = tl.bnn_mlp_serve_folded(PackedArray.pack(_t(x)), tlayers)
    _eq_packed(got, want)
    with pytest.raises(ValueError, match="PackedArray"):
        tl.bnn_mlp_serve_folded(_t(x), tlayers)


def test_bnn_dense_train_values_and_grads_close():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 40)).astype(np.float32)
    w = rng.normal(size=(12, 40)).astype(np.float32) * 0.5
    mu, sigma = rng.normal(size=12).astype(np.float32), \
        rng.uniform(1, 3, 12).astype(np.float32)
    gamma, beta = rng.normal(size=12).astype(np.float32), \
        rng.normal(size=12).astype(np.float32)
    up = rng.normal(size=(5, 12)).astype(np.float32)

    def jf(x, w, gamma, beta):
        y = jl.bnn_dense_train(x, w, mu, sigma, gamma, beta)
        return jnp.sum(y * up), y

    (_, jy), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                     has_aux=True)(x, w, gamma, beta)
    ts = [_t(a).requires_grad_(True) for a in (x, w, gamma, beta)]
    ty = tl.bnn_dense_train(ts[0], ts[1], _t(mu), _t(sigma), ts[2], ts[3])
    tg = torch.autograd.grad(torch.sum(ty * _t(up)), ts)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
