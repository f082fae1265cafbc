"""The port's binary-weight GEMM (binary_dense, xnor_gemm) against the
reference.

The same seeded numpy inputs go to the port's ``binary_dense`` on both
backends with CPU tensors (``"cuda"`` takes ``xnor_gemm_plain`` for a
CPU tensor, ``"torch"`` the ``xnor_gemm_ref`` oracle) and to
``repro.kernels.ops.binary_dense(backend="xla")``; a few small shapes
also go through the Pallas ``xnor_gemm`` in interpret mode.  Float
outputs are held to the reference's own tolerances
(tests/test_kernels.py: rtol 1e-5 for float32, 2e-2 for bf16, atol
rtol * max|y|).  Where equality must be exact — thresholds and packed
words — x is integer-valued in [-3, 3] and alpha in {0.5, 1, 2}, so
every sum is exact in float32 in any order.  Also pins the
ValueErrors of binary_dense's contract, plan_dense_launch for the
xnor_gemm op, and params_from_numpy on bfloat16 leaves.  The Hopper
kernel's own arithmetic is held here too: its exact three-way bf16 split
of float32 x (a torch copy of the bit operations), the three products
summed against the oracle, and its launch plan (tiles, parts of K).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro.kernels.xnor_gemm import xnor_gemm as jxnor  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.packed import (PackedArray, as_uint32,  # noqa: E402
                                        from_uint32)
from repro_torch.kernels.ref import xnor_gemm_ref  # noqa: E402
from repro_torch.kernels.xnor_gemm import (H100_SMS,  # noqa: E402
                                           MAX_SPLITS, MIN_SPLIT_WORDS,
                                           TILES, _launch, tile_plan,
                                           xnor_gemm, xnor_gemm_plain)

BACKENDS = ["cuda", "torch"]
SHAPES = [(128, 128, 128), (256, 512, 128), (128, 1024, 256),
          (384, 256, 384)]


def _weights(rng, k, n):
    """+-1 [K, N] packed over K for both packages (words [K/32, N])."""
    w = rng.choice([-1.0, 1.0], size=(k, n)).astype(np.float32)
    jw = JPacked.pack(jnp.asarray(w), axis=0)
    return jw, PackedArray(from_uint32(np.asarray(jw.words)), jw.length,
                           axis=-2)


def _x(rng, shape, dtype, integer=False):
    """The same activations for both packages (bf16 values taken from
    the reference's rounding, widened exactly to float32)."""
    x = (rng.integers(-3, 4, size=shape) if integer
         else rng.normal(size=shape)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    return jx, tx.to(torch.bfloat16 if dtype == jnp.bfloat16
                     else torch.float32)


def _alpha(rng, n, exact=False):
    a = (rng.choice([0.5, 1.0, 2.0], size=n) if exact
         else rng.uniform(0.5, 2.0, size=n)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_binary_dense_sweep_matches_reference(m, k, n, dtype, backend):
    rng = np.random.default_rng(m + k + n)
    jx, tx = _x(rng, (m, k), dtype)
    jw, tw = _weights(rng, k, n)
    ja, ta = _alpha(rng, n)
    want = jops.binary_dense(jx, jw, ja, backend="xla")
    got = ops.binary_dense(tx, tw, ta, backend=backend)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    rtol = 2e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                               atol=rtol * np.abs(_f32(want)).max())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("thr", [None, "scalar", "vector"])
def test_binary_dense_exact_on_integer_inputs(dtype, thr):
    """Exact sums: float, +-1 and packed outputs equal the reference's
    bit for bit on both backends."""
    rng = np.random.default_rng(3)
    m, k, n = 37, 160, 72
    jx, tx = _x(rng, (m, k), dtype, integer=True)
    jw, tw = _weights(rng, k, n)
    ja, ta = _alpha(rng, n, exact=True)
    t = {None: None, "scalar": 0.5,
         "vector": rng.integers(-6, 7, size=n).astype(np.float32)}[thr]
    want = jops.binary_dense(jx, jw, ja, threshold=t, backend="xla")
    for backend in BACKENDS:
        got = ops.binary_dense(tx, tw, ta, threshold=t, backend=backend)
        np.testing.assert_array_equal(_f32(got), _f32(want))
    if t is not None:
        wantp = jops.binary_dense(jx, jw, ja, threshold=t, pack_out=True,
                                  backend="xla")
        for backend in BACKENDS:
            got = ops.binary_dense(tx, tw, ta, threshold=t, pack_out=True,
                                   backend=backend)
            assert got.length == wantp.length == n
            np.testing.assert_array_equal(as_uint32(got.words),
                                          np.asarray(wantp.words))


@pytest.mark.parametrize("backend", BACKENDS)
def test_threshold_epilogue_matches_reference(backend):
    """tests/test_kernels.py's threshold case: 0.0 on normal inputs."""
    rng = np.random.default_rng(7)
    jx, tx = _x(rng, (128, 256), jnp.float32)
    jw, tw = _weights(rng, 256, 128)
    ja, ta = _alpha(rng, 128)
    want = jops.binary_dense(jx, jw, ja, threshold=0.0, backend="xla")
    got = ops.binary_dense(tx, tw, ta, threshold=0.0, backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("thr", [0.0, "vector"])
def test_pack_out_odd_n_matches_reference(backend, thr):
    """tests/test_fused.py's float->binary boundary layer (37, 96, 40),
    and a per-channel float threshold on odd N."""
    rng = np.random.default_rng(11)
    m, k, n = (37, 96, 40) if thr == 0.0 else (29, 96, 45)
    jx, tx = _x(rng, (m, k), jnp.float32)
    jw, tw = _weights(rng, k, n)
    ja, ta = _alpha(rng, n)
    t = thr if thr == 0.0 else \
        rng.normal(scale=2.0, size=n).astype(np.float32)
    want = jops.binary_dense(jx, jw, ja, threshold=t, pack_out=True,
                             backend="xla")
    got = ops.binary_dense(tx, tw, ta, threshold=t, pack_out=True,
                           backend=backend)
    assert isinstance(got, PackedArray) and got.length == want.length == n
    assert got.axis == -1
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))


@pytest.mark.parametrize("backend", BACKENDS)
def test_leading_dims_and_padding_match_reference(backend):
    """tests/test_kernels.py's wrapper case: x [3, 37, 544] (K = 17
    words) x [544, 200]."""
    rng = np.random.default_rng(11)
    jx, tx = _x(rng, (3, 37, 544), jnp.float32)
    jw, tw = _weights(rng, 544, 200)
    ja, ta = jnp.ones((200,), jnp.float32), torch.ones(200)
    want = jops.binary_dense(jx, jw, ja, backend="xla")
    got = ops.binary_dense(tx, tw, ta, backend=backend)
    assert got.shape == (3, 37, 200)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ragged_k_pads_x_with_zeros(backend):
    """K = 40: the last weight word holds 24 pad rows (bit 0, i.e. -1),
    so x must be zero there."""
    rng = np.random.default_rng(40)
    jx, tx = _x(rng, (9, 40), jnp.float32, integer=True)
    jw, tw = _weights(rng, 40, 33)
    assert tw.words.shape == (2, 33) and tw.padded_length == 64
    ja, ta = _alpha(rng, 33, exact=True)
    want = jops.binary_dense(jx, jw, ja, backend="xla")
    got = ops.binary_dense(tx, tw, ta, backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dense = tx.numpy() @ tw.unpack().numpy() * ta.numpy()
    np.testing.assert_array_equal(got.numpy(), dense)


@pytest.mark.parametrize("backend", BACKENDS)
def test_legacy_raw_words(backend):
    """Raw [K/32, N] words are adopted with length = x.shape[-1]."""
    rng = np.random.default_rng(23)
    m, k, n = 16, 96, 8
    jx, tx = _x(rng, (m, k), jnp.float32, integer=True)
    jw, tw = _weights(rng, k, n)
    ja, ta = jnp.ones((n,), jnp.float32), torch.ones(n)
    want = jops.binary_dense(jx, jw.words, ja, backend="xla")
    got = ops.binary_dense(tx, tw.words, ta, backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  tx.numpy() @ tw.unpack().numpy())


@pytest.mark.parametrize("m,k,n,dtype,thr,pack_out", [
    (64, 128, 64, jnp.float32, None, False),
    (48, 256, 96, jnp.bfloat16, "vector", False),
    (40, 96, 64, jnp.float32, "scalar", True),
])
def test_plain_matches_pallas_interpret(m, k, n, dtype, thr, pack_out):
    """xnor_gemm_plain against the Pallas kernel itself (interpret
    mode), exact on integer inputs; pack_out masks columns >= 50."""
    rng = np.random.default_rng(m + n)
    jx, tx = _x(rng, (m, k), dtype, integer=True)
    jw, tw = _weights(rng, k, n)
    ja, ta = _alpha(rng, n, exact=True)
    tv = rng.integers(-6, 7, size=n).astype(np.float32)
    valid_n = 50 if pack_out else n
    want = jxnor(jx, jw.words, ja,
                 threshold=0.5 if thr == "scalar" else None,
                 threshold_vec=jnp.asarray(tv) if thr == "vector" else None,
                 pack_out=pack_out, valid_n=valid_n, interpret=True)
    got = xnor_gemm(tx, tw.words, ta,
                    threshold=0.5 if thr == "scalar" else None,
                    threshold_vec=torch.from_numpy(tv)
                    if thr == "vector" else None,
                    pack_out=pack_out, valid_n=valid_n)
    assert torch.equal(got, xnor_gemm_plain(
        tx, tw.words, ta, threshold=0.5 if thr == "scalar" else None,
        threshold_vec=torch.from_numpy(tv) if thr == "vector" else None,
        pack_out=pack_out, valid_n=valid_n))
    if pack_out:
        np.testing.assert_array_equal(as_uint32(got), np.asarray(want))
    else:
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(_f32(got), _f32(want))


def test_xnor_gemm_ref_is_the_dense_product():
    rng = np.random.default_rng(5)
    _, tx = _x(rng, (6, 64), jnp.float32)
    _, tw = _weights(rng, 64, 10)
    _, ta = _alpha(rng, 10)
    y = xnor_gemm_ref(tx, tw.words, ta)
    np.testing.assert_allclose(
        y.numpy(), tx.numpy() @ tw.unpack().numpy() * ta.numpy(),
        rtol=1e-6, atol=1e-5)
    t = xnor_gemm_ref(tx, tw.words, ta, threshold=0.25)
    np.testing.assert_array_equal(t.numpy(),
                                  np.where(y.numpy() >= 0.25, 1.0, -1.0))


def test_binary_dense_contract_errors():
    rng = np.random.default_rng(1)
    _, tx = _x(rng, (4, 64), jnp.float32)
    _, tw = _weights(rng, 64, 8)
    a = torch.ones(8)
    with pytest.raises(ValueError, match="K"):          # K mismatch
        ops.binary_dense(tx[:, :32], tw, a)
    with pytest.raises(ValueError, match="axis"):       # [N, K] rows
        ops.binary_dense(tx, tw.move_pack_axis_last(), a)
    with pytest.raises(ValueError, match="pack_out"):
        ops.binary_dense(tx, tw, a, pack_out=True)
    with pytest.raises(ValueError, match="entries"):    # threshold width
        ops.binary_dense(tx, tw, a, threshold=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="32x"):
        xnor_gemm(tx[:, :48], tw.words, a)
    with pytest.raises(TypeError):
        xnor_gemm(tx.to(torch.float64), tw.words, a)
    with pytest.raises(ValueError, match="float32"):    # int32 vector
        xnor_gemm(tx, tw.words, a,
                  threshold_vec=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="either"):
        xnor_gemm(tx, tw.words, a, threshold=0.0,
                  threshold_vec=torch.zeros(8))


def test_float_threshold_is_not_rounded_to_an_integer():
    """A fractional threshold is compared with the float y as it is
    (the popcount path's integer rounding would move the decision)."""
    x = torch.tensor([[0.75, 0.5] + [0.0] * 30])
    wp = PackedArray.pack(torch.ones(32, 2), axis=0)
    y = ops.binary_dense(x, wp, torch.ones(2), backend="cuda")
    assert torch.equal(y, torch.full((1, 2), 1.25))
    for backend in BACKENDS:
        t = ops.binary_dense(x, wp, torch.ones(2), threshold=1.3,
                             backend=backend)
        assert torch.equal(t, torch.full((1, 2), -1.0))
        tv = ops.binary_dense(x, wp, torch.ones(2),
                              threshold=np.array([1.2, 1.3]),
                              backend=backend)
        assert torch.equal(tv, torch.tensor([[1.0, -1.0]]))


@pytest.mark.parametrize("backend", BACKENDS + [None])
def test_plan_dense_launch_for_xnor_gemm(backend):
    """The static twin names the xnor_gemm launch; oracle backends plan
    under "cuda"."""
    d = ops.plan_dense_launch(128, 4096, 4096, backend=backend,
                              op="xnor_gemm")
    assert d["op"] == "xnor_gemm" and d["backend"] == "cuda"
    assert (d["m"], d["n"], d["k32"]) == (128, 4096, 128)
    p = ops.plan_dense_launch(37, 40, 96, backend=backend, op="xnor_gemm",
                              pack_out=True)
    assert p["op"] == "xnor_gemm+pack" and p["k32"] == 3
    assert p["key"] == ("xnor_gemm+pack", "cuda", 37, 40, 3)


def test_params_from_numpy_carries_bfloat16_bit_for_bit():
    """A bf16 alpha and [K32, N] weights packed over K (axis -2) — the
    reference's packed-weight tree — round-trip exactly, and
    binary_dense on the carried tree equals the reference's."""
    rng = np.random.default_rng(12)
    k, n = 96, 40
    jw, _ = _weights(rng, k, n)
    ja = jnp.asarray(rng.uniform(0.5, 2.0, size=n), jnp.bfloat16)
    tree = {"wp": {"words": np.asarray(jw.words), "length": jw.length,
                   "axis": jw.axis},
            "alpha": np.asarray(ja)}
    assert tree["alpha"].dtype.name == "bfloat16"
    got = params_from_numpy(tree, "cpu")
    assert got["alpha"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["alpha"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(ja).view(np.uint16))
    wp = got["wp"]
    assert isinstance(wp, PackedArray) and (wp.length, wp.axis) == (k, -2)
    np.testing.assert_array_equal(as_uint32(wp.words),
                                  np.asarray(jw.words))
    jx, tx = _x(rng, (5, k), jnp.bfloat16, integer=True)
    want = jops.binary_dense(jx, jw, ja, backend="xla")
    for backend in BACKENDS:
        y = ops.binary_dense(tx, wp, got["alpha"], backend=backend)
        assert y.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(y), _f32(want))


# ------------------------------------------------------------------ #
# the tensor-core kernel's arithmetic and launch plan, on the CPU      #
# ------------------------------------------------------------------ #
def _split3(x: torch.Tensor):
    """The kernel's three-way split of float32 x (csrc/xnor_gemm.cu,
    ``split3``) with the same bit operations: hi = the top 16 bits of x,
    r = x - hi, mid = the top 16 bits of r, lo = r - mid; inf and NaN go
    whole into hi.  Returns the three pieces as float32 tensors."""
    top = torch.tensor(-65536, dtype=torch.int32)          # 0xFFFF0000
    hi = (x.view(torch.int32) & top).view(torch.float32)
    r = x - hi
    mid = (r.view(torch.int32) & top).view(torch.float32)
    lo = r - mid
    finite = torch.isfinite(x)
    zero = torch.zeros_like(x)
    return (torch.where(finite, hi, x), torch.where(finite, mid, zero),
            torch.where(finite, lo, zero))


def _finite_samples(rng, n=4000):
    """+-0, +-FLT_MAX, values above bf16's largest finite, and random
    finite x with |x| in [2^-100, FLT_MAX) over every exponent."""
    f32 = np.finfo(np.float32)
    bf16_max = float(torch.finfo(torch.bfloat16).max)
    mant = rng.uniform(1.0, 2.0, size=n)
    expo = rng.integers(-100, 128, size=n)
    x = (rng.choice([-1.0, 1.0], size=n) * mant * 2.0 ** expo)
    x = np.clip(x, -float(f32.max), float(f32.max)).astype(np.float32)
    above = np.linspace(bf16_max, float(f32.max), 50).astype(np.float32)
    special = np.array([0.0, -0.0, f32.max, -f32.max, 2.0 ** -100,
                        -(2.0 ** -100)], np.float32)
    return torch.from_numpy(np.concatenate([x, above, -above, special]))


def _in_bf16(t: torch.Tensor) -> bool:
    return torch.equal(t.to(torch.bfloat16).to(torch.float32), t)


def test_split3_is_exact_in_float32_and_float64():
    """hi + mid + lo == x exactly, summed in float32 and in float64, each
    piece a bf16 value with the sign of x (or zero), for +-0 and every
    finite |x| >= 2^-100, including values above bf16's largest finite
    and +-FLT_MAX (truncation never rounds hi up to inf)."""
    x = _finite_samples(np.random.default_rng(0))
    hi, mid, lo = _split3(x)
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    for piece in (hi, mid, lo):
        assert _in_bf16(piece) and torch.isfinite(piece).all()
        assert ((piece == 0) | (torch.sign(piece) == torch.sign(x))).all()


def test_split3_non_finite_goes_whole_into_hi():
    x = torch.tensor([float("inf"), float("-inf"), float("nan")])
    hi, mid, lo = _split3(x)
    assert hi[0] == float("inf") and hi[1] == float("-inf")
    assert torch.isnan(hi[2])
    assert torch.equal(mid, torch.zeros(3)) and torch.equal(lo, torch.zeros(3))


def test_split3_below_2_to_the_minus_100_within_tolerance():
    """Below 2^-100 mid and lo fall into bf16's subnormal range, which
    the tensor cores may flush to zero, so there the split is held only
    to the kernel's float tolerance, 1e-5 * max|y|: with every subnormal
    piece flushed, the three products still sum to xnor_gemm_ref's y
    within it."""
    rng = np.random.default_rng(1)
    m, k, n = 6, 256, 24
    x = rng.normal(size=(m, k)).astype(np.float32)
    tiny = rng.uniform(-1, 1, size=(m, k)) * 2.0 ** rng.integers(
        -149, -100, size=(m, k))
    x[::2] = tiny[::2].astype(np.float32)              # half the rows tiny
    tx = torch.from_numpy(x)
    _, tw = _weights(rng, k, n)
    ta = torch.ones(n)
    w = tw.unpack(torch.float32)

    def flush(t):
        return torch.where(t.abs() < 2.0 ** -126, torch.zeros_like(t), t)

    hi, mid, lo = _split3(tx)
    assert torch.equal(hi + mid + lo, tx)
    y = flush(hi) @ w + flush(mid) @ w + flush(lo) @ w
    want = xnor_gemm_ref(tx, tw.words, ta)
    tol = 1e-5 * float(want.abs().max())
    assert float((y - want).abs().max()) <= tol


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m,k,n", [(37, 544, 200), (1, 2048, 97),
                                   (65, 1024, 130)])
def test_three_bf16_products_match_the_oracle(m, k, n, integer):
    """The kernel's float32 path: three bf16 products against the same
    +-1 weights, summed in float32, times alpha, equal xnor_gemm_ref
    within 1e-5 * max|y| on normal x, and exactly on integer x (mid and
    lo are 0 there and every sum is exact)."""
    rng = np.random.default_rng(m + k + n)
    _, tx = _x(rng, (m, k), jnp.float32, integer=integer)
    _, tw = _weights(rng, k, n)
    _, ta = _alpha(rng, n, exact=integer)
    w = tw.unpack(torch.float32)
    planes = _split3(tx)
    assert all(_in_bf16(p) for p in planes)
    y = (planes[0] @ w + planes[1] @ w + planes[2] @ w) * ta
    want = xnor_gemm_ref(tx, tw.words, ta)
    if integer:
        assert torch.equal(y, want)
    else:
        tol = 1e-5 * float(want.abs().max())
        assert float((y - want).abs().max()) <= tol


PLAN_SHAPES = [(128, 4096, 4096), (128, 12288, 12288), (1, 8192, 8192),
               (37, 96, 40), (111, 544, 200), (5, 1024, 65),
               (1, 2048, 97), (16, 544, 97), (17, 544, 97),
               (65, 1024, 130), (150, 544, 200), (384, 256, 384),
               (1024, 4096, 4096)]


def _split_words(k32, splits):
    """The kernel's parts of K (csrc/xnor_gemm.cu): part z takes words
    [min(k32, z*w), min(k32, z*w + w)) with w = ceil(k32 / splits)."""
    w = -(-k32 // splits)
    return [(min(k32, z * w), min(k32, min(k32, z * w) + w))
            for z in range(splits)]


@pytest.mark.parametrize("planes", [1, 3])
@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_tile_plan_covers_the_output_and_k_once(m, k, n, planes):
    """BM is 16 up to M = 16 and 64 above; the grid covers every row,
    column and word of K exactly once; blocks and waves follow."""
    k32 = k // 32
    p = tile_plan(m, n, k32, planes=planes)
    bm, bn, s = p["bm"], p["bn"], p["splits"]
    assert (bm, bn) in TILES and bm == (16 if m <= 16 else 64)
    assert 1 <= s <= MAX_SPLITS
    assert s == 1 or -(-k32 // s) >= MIN_SPLIT_WORDS
    gm, gn, gz = p["grid"]
    assert gz == s and p["blocks"] == gm * gn * s
    assert p["waves"] == -(-p["blocks"] // H100_SMS)
    rows = np.zeros(m, int)
    for i in range(gm):
        rows[i * bm:min(m, (i + 1) * bm)] += 1
    cols = np.zeros(n, int)
    for j in range(gn):
        cols[j * bn:min(n, (j + 1) * bn)] += 1
    words = np.zeros(k32, int)
    for lo, hi in _split_words(k32, s):
        words[lo:hi] += 1
    assert (rows == 1).all() and (cols == 1).all() and (words == 1).all()
    assert (gm - 1) * bm < m and (gn - 1) * bn < n


@pytest.mark.parametrize("m,k,n,planes,want", [
    (128, 4096, 4096, 1, (64, 128, 2)), (128, 4096, 4096, 3, (64, 128, 2)),
    (128, 12288, 12288, 1, (64, 128, 2)),
    (128, 12288, 12288, 3, (64, 128, 2)),
    (1, 8192, 8192, 1, (16, 64, 1)), (1, 8192, 8192, 3, (16, 128, 2))])
def test_tile_plan_at_the_decode_shapes(m, k, n, planes, want):
    """The plans the chip runs measured best (PERF.md): at M = 128 two
    parts of K over 64 x 128 tiles (384 blocks at N = 12288: three
    rounds of the 132 SMs, evenly filled); at M = 1 one 16 x 64 tile per
    SM for bf16, two parts of K over 16 x 128 tiles for float32."""
    p = tile_plan(m, n, k // 32, planes=planes)
    assert (p["bm"], p["bn"], p["splits"]) == want


def test_plan_dense_launch_reports_the_tile_plan():
    for m, k, n in PLAN_SHAPES:
        d = ops.plan_dense_launch(m, n, k, op="xnor_gemm")
        assert d["tiles"] == tile_plan(m, n, k // 32)
    assert "tiles" not in ops.plan_dense_launch(128, 64, 256)


def test_tile_argument_is_checked_and_cpu_takes_the_plain_version():
    """The entry point takes no tile: a CPU tensor takes the plain
    version.  The private launch helper, which the checks on the card
    use to force each tile, refuses a tile that is no kernel variant
    before anything else, and CPU tensors after that."""
    rng = np.random.default_rng(2)
    _, tx = _x(rng, (5, 96), jnp.float32, integer=True)
    _, tw = _weights(rng, 96, 40)
    a = torch.ones(40)
    assert torch.equal(xnor_gemm(tx, tw.words, a),
                       xnor_gemm_plain(tx, tw.words, a))
    with pytest.raises(TypeError):
        xnor_gemm(tx, tw.words, a, tile=(16, 64, 1))
    for bad in [(32, 64, 1), (64, 128), (16, 64, 0), (16, 64, MAX_SPLITS + 1)]:
        with pytest.raises(ValueError, match="tile"):
            _launch(tx, tw.words, a, bad)
    with pytest.raises(ValueError, match="CUDA"):
        _launch(tx, tw.words, a, (16, 64, 1))
