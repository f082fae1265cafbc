"""The port's binary conv, OR-pool, folding and float entry conv against
the JAX reference.

Pins (1) packed_conv2d's plain version bit for bit against the Pallas
packed_conv2d kernel in interpret mode over odd C/F, stride 2, valid
padding, scalar and per-channel thresholds and valid_f masking; (2)
binary_conv2d, direct and im2col, on both port backends against the
reference's "xla" dispatch on the cases of tests/test_conv.py; (3)
im2col_words and pad_words_spatial word for word; (4) the OR-pool;
(5) BN folding: the negated words and T' = 1 - T equal the
reference's; (6) the float entry conv to a stated tolerance (the
summation order differs); (7) the tensor-core kernel's arithmetic,
written here in torch (im2col words zero-padded to the b1 MMA depth,
K_p - pc_x - pc_w + 2*popc(x & w), the closed form), bit for bit against the plain version and the Pallas
kernel, and its launch plan (the kernel itself runs on the card:
tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import bnn_layers as jbl  # noqa: E402
from repro.kernels import packed_conv as jpc  # noqa: E402
from repro.kernels.ops import binary_conv2d as jconv  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro_torch import conv_tiles  # noqa: E402
from repro_torch.core import bnn_layers as tbl  # noqa: E402
from repro_torch.kernels import packed_conv as tpc  # noqa: E402
from repro_torch.kernels.ops import binary_conv2d  # noqa: E402
from repro_torch.kernels.packed import (PackedArray, as_uint32,  # noqa: E402
                                        from_uint32, popcount_u32)
from repro_torch.kernels.popcount_gemm import (  # noqa: E402
    apply_threshold_plain)


def _pm1(rng, *shape):
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


def _port(jp: JPacked) -> PackedArray:
    return PackedArray(from_uint32(np.asarray(jp.words)), jp.length,
                       jp.axis)


def _pack_io(rng, nb, h, w, c, f, k):
    jx = JPacked.pack(jnp.asarray(_pm1(rng, nb, h, w, c)), axis=-1)
    jw = JPacked.pack(jnp.asarray(_pm1(rng, k, k, c, f)), axis=2)
    return jx, jw, _port(jx), _port(jw)


@pytest.mark.parametrize("nb,h,w,c,f,k,s,pad,thr,pack_out,valid_f", [
    (2, 8, 8, 33, 20, 3, 1, "same", None, False, 20),     # odd C and F
    (1, 9, 9, 64, 32, 3, 2, "same", "scalar", True, 32),  # stride 2
    (1, 7, 7, 16, 10, 5, 1, "valid", "vector", False, 10),
    (2, 6, 6, 3, 64, 3, 1, "same", "vector", True, 40),   # valid_f mask
])
def test_packed_conv2d_plain_matches_pallas_interpret(
        nb, h, w, c, f, k, s, pad, thr, pack_out, valid_f):
    rng = np.random.default_rng(nb * 11 + c * 3 + f + k + s)
    jx, jw, _, _ = _pack_io(rng, nb, h, w, c, f, k)
    p = (k - 1) // 2 if pad == "same" else 0
    ho, wo = jpc.out_size(h, k, s, p), jpc.out_size(w, k, s, p)
    c32 = jx.n_words
    jxw = jpc.pad_words_spatial(jx.words, p, p)
    jww = jw.words.reshape(k * k * c32, f)
    tv = rng.integers(-4, 4, size=f).astype(np.int32)
    kw = dict(kh=k, kw=k, c=c, stride=s, ho=ho, wo=wo,
              threshold=2 if thr == "scalar" else None, pack_out=pack_out,
              valid_f=valid_f)
    want = jpc.packed_conv2d(
        jxw, jww, threshold_vec=jnp.asarray(tv) if thr == "vector"
        else None, interpret=True, **kw)
    txw = tpc.pad_words_spatial(from_uint32(np.asarray(jx.words)), p, p)
    np.testing.assert_array_equal(as_uint32(txw), np.asarray(jxw))
    got = tpc.packed_conv2d(
        txw, from_uint32(np.asarray(jww)),
        threshold_vec=torch.from_numpy(tv) if thr == "vector" else None,
        **kw)
    got_np = as_uint32(got) if pack_out else got.numpy()
    np.testing.assert_array_equal(got_np, np.asarray(want))


def test_im2col_words_matches_reference():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 32, size=(2, 9, 9, 3), dtype=np.uint32)
    want = jpc.im2col_words(jnp.asarray(words), 3, 3, 2, 4, 4)
    got = tpc.im2col_words(from_uint32(words), 3, 3, 2, 4, 4)
    np.testing.assert_array_equal(as_uint32(got), np.asarray(want))


@pytest.mark.parametrize("nb,h,w,c,f,k,s,pad", [
    (2, 8, 8, 33, 20, 3, 1, "same"),
    (1, 9, 9, 64, 32, 3, 2, "same"),
    (1, 7, 7, 16, 10, 5, 1, "valid"),
    (2, 6, 6, 3, 40, 3, 1, "same"),
])
@pytest.mark.parametrize("impl", ["direct", "im2col"])
def test_binary_conv2d_matches_reference(nb, h, w, c, f, k, s, pad, impl):
    rng = np.random.default_rng(nb * 11 + c * 3 + f + k + s)
    jx, jw, tx, tw = _pack_io(rng, nb, h, w, c, f, k)
    want = jconv(jx, jw, stride=s, padding=pad, backend="xla")
    for backend in ("cuda", "torch"):
        got = binary_conv2d(tx, tw, stride=s, padding=pad, backend=backend,
                            impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("thr", ["scalar", "vector"])
@pytest.mark.parametrize("impl", ["direct", "im2col"])
def test_binary_conv2d_pack_out_matches_reference(thr, impl):
    rng = np.random.default_rng(77)
    jx, jw, tx, tw = _pack_io(rng, 2, 6, 6, 50, 33, 3)
    tv = rng.integers(-4, 4, size=33).astype(np.int32)
    jt = 2 if thr == "scalar" else jnp.asarray(tv)
    tt = 2 if thr == "scalar" else torch.from_numpy(tv)
    want = jconv(jx, jw, threshold=jt, pack_out=True, backend="xla")
    for backend in ("cuda", "torch"):
        got = binary_conv2d(tx, tw, threshold=tt, pack_out=True,
                            backend=backend, impl=impl)
        assert isinstance(got, PackedArray) and got.length == 33
        np.testing.assert_array_equal(as_uint32(got.words),
                                      np.asarray(want.words))
        pm = binary_conv2d(tx, tw, threshold=tt, backend=backend, impl=impl)
        np.testing.assert_array_equal(
            pm.numpy(), np.asarray(jconv(jx, jw, threshold=jt,
                                         backend="xla")))


def test_binary_conv2d_validates_operands():
    rng = np.random.default_rng(0)
    _, _, tx, tw = _pack_io(rng, 1, 5, 5, 8, 4, 3)
    with pytest.raises(ValueError):
        binary_conv2d(tx, tw, pack_out=True)
    with pytest.raises(ValueError):
        binary_conv2d(tx, tw, impl="winograd")
    with pytest.raises(ValueError):
        binary_conv2d(tw, tw)
    with pytest.raises(ValueError):
        tpc.packed_conv2d(tx.words, torch.zeros(5, 4, dtype=torch.int32),
                          kh=3, kw=3, c=8, stride=1, ho=3, wo=3)


@pytest.mark.parametrize("win,stride,h", [(2, 2, 8), (3, 2, 9), (2, 1, 5)])
def test_maxpool_packed_matches_reference(win, stride, h):
    rng = np.random.default_rng(win + h)
    jx = JPacked.pack(jnp.asarray(_pm1(rng, 2, h, h, 40)), axis=-1)
    want = jbl.maxpool_packed(jx, win, stride)
    got = tbl.maxpool_packed(_port(jx), win, stride)
    assert got.length == 40
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))


def _fold(rng, n):
    T = rng.integers(-6, 6, size=n).astype(np.int32)
    flip = rng.random(n) < 0.5
    return (jbl.FoldedThreshold(T=jnp.asarray(T), flip=jnp.asarray(flip)),
            tbl.FoldedThreshold(T=torch.from_numpy(T),
                                flip=torch.from_numpy(flip)))


@pytest.mark.parametrize("k", [50, 64, 97])
def test_fold_to_channel_thresholds_matches_reference(k):
    rng = np.random.default_rng(k)
    jw = JPacked.pack(jnp.asarray(_pm1(rng, 12, k)))
    jf, tf = _fold(rng, 12)
    jw2, jt = jbl.fold_to_channel_thresholds(jw, jf)
    tw2, tt = tbl.fold_to_channel_thresholds(_port(jw), tf)
    np.testing.assert_array_equal(as_uint32(tw2.words),
                                  np.asarray(jw2.words))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tw2.length == k


def test_fold_conv_to_channel_thresholds_matches_reference():
    rng = np.random.default_rng(9)
    jw = JPacked.pack(jnp.asarray(_pm1(rng, 3, 3, 40, 10)), axis=2)
    jf, tf = _fold(rng, 10)
    jw2, jt = jbl.fold_conv_to_channel_thresholds(jw, jf)
    tw2, tt = tbl.fold_conv_to_channel_thresholds(_port(jw), tf)
    np.testing.assert_array_equal(as_uint32(tw2.words),
                                  np.asarray(jw2.words))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the folded conv equals the reference's folded conv, end to end
    jx = JPacked.pack(jnp.asarray(_pm1(rng, 1, 6, 6, 40)), axis=-1)
    want = jbl.binary_conv(jx, jw, jf, pack_out=True, backend="xla")
    got = tbl.binary_conv(_port(jx), _port(jw), tf, pack_out=True)
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))


def test_binary_weight_conv_matches_reference():
    """Normal inputs: the summation order differs between XLA and torch,
    so float32 rounding differs — rtol 1e-5 / atol 1e-4 on values of
    order 10.  Integer-valued inputs sum exactly in any order: equal,
    given the same alpha (a param of the compiled net; its own mean
    would differ in the last bit between the two packages)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 3, 16)).astype(np.float32)
    alpha = np.abs(w).mean(axis=(0, 1, 2)).astype(np.float32)
    for x, exact in ((rng.standard_normal((2, 8, 8, 3)), False),
                     (rng.integers(-3, 4, size=(2, 8, 8, 3)), True)):
        x = x.astype(np.float32)
        want = np.asarray(jbl.binary_weight_conv(
            jnp.asarray(x), jnp.asarray(w), alpha=jnp.asarray(alpha)))
        got = tbl.binary_weight_conv(
            torch.from_numpy(x), torch.from_numpy(w),
            alpha=torch.from_numpy(alpha)).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# (N, H=W, C, F, K, stride, padding): the edge shapes of the kernel's
# checks on the card (C32 = 1, 2, 3; F = 10, 20, 33, 40; stride 2; a 5x5
# VALID window) and C = 384 (C32 = 12, AlexNet conv4's 108 words, no
# multiple of the MMA depth) at a small batch
MMA_CASES = [(2, 8, 33, 20, 3, 1, "same"), (1, 9, 64, 32, 3, 2, "same"),
             (1, 7, 16, 10, 5, 1, "valid"), (2, 6, 3, 40, 3, 1, "same"),
             (2, 6, 50, 33, 3, 1, "same"), (1, 5, 384, 40, 3, 1, "same")]
# the main paths' binary convs: (H=W, C, F)
MAIN_CONVS = [(h, c, f) for _, h, c, f in conv_tiles.MAIN_CONVS]


def _mma_dot(xw, ww, kh, kw, c, stride, ho, wo):
    """The kernel's arithmetic: the im2col words zero-padded to the MMA
    depth (8 words) on both operands, the XNOR count K_p - pc_x - pc_w +
    2*popc(x & w), then the closed form."""
    kw_words = ww.shape[0]
    k_words = tpc.tile_plan(1, 1, kw_words)["k_words"]
    assert k_words % tpc.MMA_WORDS == 0 and k_words - kw_words < 8
    a = tpc.im2col_words(xw, kh, kw, stride, ho, wo)
    a = torch.nn.functional.pad(a, (0, k_words - kw_words))
    b = torch.nn.functional.pad(ww, (0, 0, 0, k_words - kw_words))
    pc_x = popcount_u32(a).sum(1, dtype=torch.int64)
    pc_w = popcount_u32(b).sum(0, dtype=torch.int64)
    both = torch.zeros(a.shape[0], b.shape[1], dtype=torch.int64)
    for t in range(k_words):
        both += popcount_u32(a[:, t, None] & b[None, t])
    xnor = 32 * k_words - pc_x[:, None] - pc_w[None, :] + 2 * both
    k, k_p = kh * kw * c, 32 * k_words
    return (2 * (xnor - (k_p - k)) - k).to(torch.int32)


@pytest.mark.parametrize("cut", [0, 3])
@pytest.mark.parametrize("nb,h,c,f,k,s,pad", MMA_CASES)
def test_mma_arithmetic_matches_plain_and_pallas(nb, h, c, f, k, s, pad,
                                                 cut):
    """``cut``: the packed decisions keep the first F - cut filters
    (valid_f), the rest of the last word zero."""
    rng = np.random.default_rng(nb * 7 + h + c + f + k + s)
    jx, jw, _, _ = _pack_io(rng, nb, h, h, c, f, k)
    p = (k - 1) // 2 if pad == "same" else 0
    ho = jpc.out_size(h, k, s, p)
    c32 = jx.n_words
    jxw = jpc.pad_words_spatial(jx.words, p, p)
    jww = jw.words.reshape(k * k * c32, f)
    txw, tww = from_uint32(np.asarray(jxw)), from_uint32(np.asarray(jww))
    geo = dict(kh=k, kw=k, c=c, stride=s, ho=ho, wo=ho)
    dot = _mma_dot(txw, tww, k, k, c, s, ho, ho)
    plain = tpc.packed_conv2d_plain(txw, tww, **geo)
    np.testing.assert_array_equal(dot.reshape(plain.shape).numpy(),
                                  plain.numpy())
    np.testing.assert_array_equal(
        dot.reshape(plain.shape).numpy(),
        np.asarray(jpc.packed_conv2d(jxw, jww, interpret=True, **geo)))
    # the thresholds on those sums: +-1 as the Pallas kernel gives it,
    # and the main path's packed decisions (bits at filters >= valid_f
    # zero) as the plain version gives them
    tv = rng.integers(-4, 4, size=f).astype(np.int32)
    pm1 = apply_threshold_plain(dot, None, torch.from_numpy(tv), False, f)
    np.testing.assert_array_equal(
        pm1.reshape(plain.shape).numpy(),
        np.asarray(jpc.packed_conv2d(jxw, jww, interpret=True,
                                     threshold_vec=jnp.asarray(tv), **geo)))
    valid_f = f - cut
    packed = apply_threshold_plain(dot, None, torch.from_numpy(tv), True,
                                   valid_f)
    want = tpc.packed_conv2d_plain(txw, tww, threshold_vec=torch.from_numpy(
        tv), pack_out=True, valid_f=valid_f, **geo)
    np.testing.assert_array_equal(packed.reshape(want.shape).numpy(),
                                  want.numpy())


@pytest.mark.parametrize("batch", [1, 32, 256])
@pytest.mark.parametrize("shape", MAIN_CONVS + [
    (h, c, f) for _, h, c, f, *_ in MMA_CASES])
def test_conv_tile_plan_covers_the_product(shape, batch):
    """Every main-path conv shape and edge shape: the plan's tile is one
    the kernel has, its grid covers M and F, K is padded to whole MMA
    depths, and the tile is the largest whose grid has at least half as
    many blocks as SMs, or the smallest where none has."""
    h, c, f = shape
    m, k32 = batch * h * h, 9 * -(-c // 32)
    p = tpc.tile_plan(m, f, k32)
    tile = (p["bm"], p["bn"])
    assert tile in tpc.TILES
    gm, gn = p["grid"]
    assert gm * p["bm"] >= m > (gm - 1) * p["bm"]
    assert gn * p["bn"] >= f > (gn - 1) * p["bn"]
    assert p["blocks"] == gm * gn
    assert p["k_words"] % tpc.MMA_WORDS == 0
    assert 0 <= p["k_words"] - k32 < tpc.MMA_WORDS
    fills = [2 * -(-m // bm) * -(-f // bn) >= tpc.H100_SMS
             for bm, bn in tpc.TILES]
    assert tile == (tpc.TILES[fills.index(True)] if any(fills)
                    else tpc.TILES[-1])
