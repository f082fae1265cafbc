"""The port's packed layout and pack kernel against the JAX reference.

Pins (1) pack_words / unpack_words / popcount_u32 bit for bit against
repro.kernels.packed on odd lengths and every axis, with the int32 word
carrier holding the uint32 pattern; (2) PackedArray metadata; (3) the
port's own backend registry; (4) the pack kernel's plain version against
the Pallas pack kernel in interpret mode and the ref oracle, NaN and
-0.0 included; (5) the pack with a scale (an entry conv's alpha taken in
the pack's load) against the reference's pack of the same float32
product, and the kernel's path rule.  Inputs are made with numpy and
handed to both.  Every comparison is exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import packed as jpacked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.pack import pack as jpack_kernel  # noqa: E402
from repro_torch.kernels import ops, packed  # noqa: E402
from repro_torch.kernels.pack import pack, pack_path, pack_plain  # noqa
from repro_torch.kernels.packed import (PackedArray, as_uint32,  # noqa: E402
                                        from_uint32)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,axis", [((5, 50), -1), ((3, 97), 1),
                                        ((70, 4), 0), ((2, 33, 3), 1),
                                        ((2, 3, 288), -1)])
def test_pack_words_matches_reference(shape, axis):
    x = _normal(np.random.default_rng(sum(shape)), *shape)
    want = np.asarray(jpacked.pack_words(jnp.asarray(x), axis=axis))
    got = packed.pack_words(torch.from_numpy(x), axis=axis)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(as_uint32(got), want)


@pytest.mark.parametrize("k", [32, 50, 97])
@pytest.mark.parametrize("values", [packed.PM1, packed.ZERO_ONE])
def test_unpack_words_matches_reference(k, values):
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2 ** 32, size=(4, (k + 31) // 32),
                         dtype=np.uint32)
    want = jpacked.unpack_words(jnp.asarray(words), dtype=jnp.float32,
                                values=values, length=k)
    got = packed.unpack_words(from_uint32(words), values=values, length=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_popcount_matches_reference_on_every_bit_pattern_class():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        rng.integers(0, 2 ** 32, size=500, dtype=np.uint32),
        np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 0x80000001, 0x7FFFFFFF],
                 np.uint32)])
    want = np.asarray(jpacked.popcount_u32(jnp.asarray(words)))
    got = packed.popcount_u32(from_uint32(words))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [32, 50, 97, 288])
def test_roundtrip_pm1_equals_sign(k):
    x = _normal(np.random.default_rng(k), 3, k)
    pa = PackedArray.pack(torch.from_numpy(x))
    assert pa.length == k and pa.n_words == (k + 31) // 32
    assert pa.shape == (3, k)
    np.testing.assert_array_equal(pa.unpack().numpy(),
                                  np.where(x > 0, 1.0, -1.0))


def test_packedarray_metadata_and_padding():
    x = torch.from_numpy(_normal(np.random.default_rng(1), 40, 6))
    pa = PackedArray.pack(x, axis=0)
    assert pa.axis == -2 and pa.n_words == 2 and pa.shape == (40, 6)
    wide = pa.pad_to(128)
    assert wide.n_words == 4 and wide.length == 40
    assert torch.equal(wide.words[:2], pa.words)
    assert not wide.words[2:].any()
    last = pa.move_pack_axis_last()
    assert last.axis == -1 and torch.equal(last.words, pa.words.t())
    with pytest.raises(TypeError):
        PackedArray(torch.zeros(2, 2, dtype=torch.int64), length=64)


def test_backend_registry_is_the_ports_own():
    assert packed.get_backend().name == "cuda"
    assert packed.get_backend("cuda").uses_kernels
    assert not packed.get_backend("torch").uses_kernels
    with pytest.raises(ValueError):
        packed.get_backend("pallas")
    # the reference registry stays untouched by the port
    with pytest.raises(ValueError):
        jpacked.get_backend("cuda")
    # no TPU block multiples: the kernels mask their own ragged edges
    assert packed.get_backend("cuda").pad_k(50) == 64


@pytest.mark.parametrize("m,k", [(8, 64), (37, 128), (5, 96)])
def test_pack_plain_matches_pallas_interpret(m, k):
    x = _normal(np.random.default_rng(m + k), m, k)
    x[0, :4] = [np.nan, -0.0, 0.0, 1.0]
    want = np.asarray(jpack_kernel(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(as_uint32(pack(torch.from_numpy(x))),
                                  want)
    np.testing.assert_array_equal(
        as_uint32(pack_plain(torch.from_numpy(x))),
        np.asarray(jref.pack_ref(jnp.asarray(x))))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_binarize_pack_odd_length(backend):
    x = _normal(np.random.default_rng(7), 2, 3, 50)
    got = ops.binarize_pack(torch.from_numpy(x), backend=backend)
    want = jpacked.PackedArray.pack(jnp.asarray(x))
    assert got.length == 50 and got.words.shape == (2, 3, 2)
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))


def test_pack_wrapper_refuses_bad_operands():
    with pytest.raises(ValueError):
        pack(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        pack(torch.zeros(2, 32, device="meta"))
    x = torch.zeros(2, 32)
    for scale in (torch.ones(31), torch.ones(32, dtype=torch.float64),
                  torch.ones(64)[::2], torch.ones(1, 32)):
        with pytest.raises(ValueError, match="scale"):
            pack(x, scale)


def _scaled_operands(m, k, seed):
    """Normal x and scale with NaN, -0.0 and 0.0 in x, a zero and
    negative entries in scale, and products that round to 0 (1e-30 *
    1e-30 and 3e-23 * -2e-23 lie below half the smallest denormal)."""
    rng = np.random.default_rng(seed)
    x = _normal(rng, m, k)
    scale = _normal(rng, k)
    x[0, :3] = [np.nan, -0.0, 0.0]
    scale[3] = 0.0
    x[1, 4:6] = [1e-30, 3e-23]
    scale[4:6] = [1e-30, -2e-23]
    assert (scale < 0).any() and ((x * scale)[1, 4:6] == 0).all()
    return x, scale


@pytest.mark.parametrize("m,k", [(8, 64), (37, 128), (5, 256)])
def test_pack_plain_with_scale_matches_pallas_interpret(m, k):
    """K % 32 == 0: the reference's Pallas pack (interpret mode) of the
    float32 product x * scale, formed in numpy."""
    x, scale = _scaled_operands(m, k, m + k)
    want = np.asarray(jpack_kernel(jnp.asarray(x * scale), interpret=True))
    got = pack_plain(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_array_equal(as_uint32(got), want)
    np.testing.assert_array_equal(
        as_uint32(pack(torch.from_numpy(x), torch.from_numpy(scale))), want)


@pytest.mark.parametrize("m,k", [(6, 100), (3, 33)])
def test_pack_plain_with_scale_ragged_k_matches_ref(m, k):
    """K % 32 != 0 (the Pallas pack takes whole words only): the
    reference's pack_ref of the same product; pad bits 0."""
    x, scale = _scaled_operands(m, k, m + k)
    want = np.asarray(jref.pack_ref(jnp.asarray(x * scale)))
    got = pack_plain(torch.from_numpy(x), torch.from_numpy(scale))
    assert got.shape == (m, (k + 31) // 32)
    np.testing.assert_array_equal(as_uint32(got), want)


def test_pack_scale_keeps_a_denormal_product():
    """1e-20 * 1e-20 is denormal in float32: torch's multiply keeps it,
    so its bit is 1 (the kernel is built without flush-to-zero to give
    the same).  The reference on the CPU flushes denormals (XLA), so
    the bits are held here against the IEEE sign formed in numpy and
    packed by the reference's pack_ref."""
    x = np.full((2, 32), 1e-20, np.float32)
    scale = np.full(32, 1e-20, np.float32)
    scale[1] = -1e-20
    p = x * scale
    assert 0 < p[0, 0] < np.finfo(np.float32).tiny
    want = np.asarray(jref.pack_ref(jnp.asarray(np.where(p > 0, 1.0, -1.0)
                                                 .astype(np.float32))))
    got = pack_plain(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_array_equal(as_uint32(got), want)
    assert as_uint32(got)[0, 0] == 0xFFFFFFFD


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_binarize_pack_with_scale(backend):
    """An NHWC activation and a per-channel scale: both backends give the
    reference's PackedArray of the product, any C."""
    for c in (50, 128):
        x, scale = _scaled_operands(2 * 3, c, c)
        x = x.reshape(2, 3, c)
        want = jpacked.PackedArray.pack(jnp.asarray(x * scale))
        got = ops.binarize_pack(torch.from_numpy(x), backend=backend,
                                scale=torch.from_numpy(scale))
        assert got.length == c and got.words.shape == (2, 3, (c + 31) // 32)
        np.testing.assert_array_equal(as_uint32(got.words),
                                      np.asarray(want.words))


def test_pack_path_rule():
    """The kernel's path: 16-byte loads over the flat array where K % 32
    == 0 and x and the scale are 16-byte aligned, 4-byte loads a word
    otherwise."""
    assert pack_path(128, 256) == "flat"
    assert pack_path(128, 256, 512) == "flat"
    assert pack_path(256, 4096, None) == "flat"
    assert pack_path(100, 256) == "rows"
    assert pack_path(68, 256, 16) == "rows"
    assert pack_path(33, 256) == "rows"
    assert pack_path(1, 256) == "rows"
    assert pack_path(128, 260) == "rows"
    assert pack_path(128, 256, 4) == "rows"
    assert pack_path(100, 8, 16) == "rows"


def test_mask_rows():
    x = torch.arange(12).reshape(4, 3)
    assert torch.equal(ops.mask_rows(x, 2), x[:2])
    pa = PackedArray(torch.zeros(4, 1, dtype=torch.int32), length=20)
    assert ops.mask_rows(pa, 3).words.shape == (3, 1)
    with pytest.raises(ValueError):
        ops.mask_rows(x, 0)
