"""The port's popcount GEMM and fused binary MLP against the reference.

Pins (1) popcount_gemm's plain version bit for bit against the Pallas
popcount_gemm kernel in interpret mode and the ref oracle — dot, +-1 and
packed outputs, scalar and per-channel thresholds, valid_n masking, odd
M/K/N; (2) binary_binary_dense on both port backends against the
reference's "xla" dispatch on the odd shapes of tests/test_fused.py;
(3) fused_mlp_words and fused_binary_mlp against the Pallas fused_mlp
kernel in interpret mode and the chained path; (4) the Hopper
residency rule of stack_plan."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_mlp import fused_binary_mlp as jfused  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro.kernels.popcount_gemm import popcount_gemm as jgemm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fused_mlp import (fused_binary_mlp,  # noqa: E402
                                           fused_mlp_words, stack_plan)
from repro_torch.kernels.packed import (PackedArray, as_uint32,  # noqa: E402
                                        from_uint32)
from repro_torch.kernels.popcount_gemm import (popcount_gemm,  # noqa: E402
                                               popcount_gemm_plain)
from repro_torch.kernels.ref import popcount_gemm_ref  # noqa: E402


def _pm1(rng, *shape):
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


def _both(x: np.ndarray):
    """The same packed rows for both packages."""
    jp = JPacked.pack(jnp.asarray(x))
    return jp, PackedArray(from_uint32(np.asarray(jp.words)), jp.length)


@pytest.mark.parametrize("m,k,n,thr,pack_out", [
    (37, 50, 20, None, False),
    (5, 97, 64, "vector", True),
    (64, 128, 96, "scalar", False),
    (3, 33, 65, "vector", False),
    (9, 200, 32, "scalar", True),
])
def test_popcount_gemm_plain_matches_pallas_interpret(m, k, n, thr,
                                                      pack_out):
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    jx, tx = _both(_pm1(rng, m, k))
    jw, tw = _both(_pm1(rng, n, k))
    tv = rng.integers(-5, 5, size=n).astype(np.int32)
    valid_n = n - 7 if pack_out else n       # mask inside the last word
    jkw = dict(threshold=2 if thr == "scalar" else None,
               threshold_vec=jnp.asarray(tv) if thr == "vector" else None,
               pack_out=pack_out, valid_n=valid_n)
    want = np.asarray(jgemm(jx.words, jw.words, k, interpret=True, **jkw))
    tkw = dict(jkw, threshold_vec=torch.from_numpy(tv)
               if thr == "vector" else None)
    got = popcount_gemm(tx.words, tw.words, k, **tkw)
    got_np = as_uint32(got) if pack_out else got.numpy()
    np.testing.assert_array_equal(got_np, want)
    if thr is None:
        np.testing.assert_array_equal(
            popcount_gemm_ref(tx.words, tw.words, k).numpy(),
            np.asarray(jref.popcount_gemm_ref(jx.words, jw.words, k)))


@pytest.mark.parametrize("m,k,n", [(37, 50, 20), (5, 97, 33), (64, 128, 96),
                                   (3, 33, 65)])
@pytest.mark.parametrize("thr", ["scalar", "vector"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_binary_binary_dense_matches_reference(m, k, n, thr, backend):
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    jx, tx = _both(_pm1(rng, m, k))
    jw, tw = _both(_pm1(rng, n, k))
    tv = rng.integers(-5, 5, size=n).astype(np.int32)
    jt = 2 if thr == "scalar" else jnp.asarray(tv)
    tt = 2 if thr == "scalar" else torch.from_numpy(tv)
    for pack_out in (False, True):
        want = jops.binary_binary_dense(jx, jw, threshold=jt,
                                        pack_out=pack_out, backend="xla")
        got = ops.binary_binary_dense(tx, tw, threshold=tt,
                                      pack_out=pack_out, backend=backend)
        if pack_out:
            assert got.length == want.length == n
            np.testing.assert_array_equal(as_uint32(got.words),
                                          np.asarray(want.words))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dot = ops.binary_binary_dense(tx, tw, backend=backend)
    np.testing.assert_array_equal(
        dot.numpy(), np.asarray(jops.binary_binary_dense(jx, jw,
                                                         backend="xla")))


def test_float_scalar_threshold_is_ceiled_for_the_kernel():
    rng = np.random.default_rng(3)
    jx, tx = _both(_pm1(rng, 6, 40))
    jw, tw = _both(_pm1(rng, 9, 40))
    want = jops.binary_binary_dense(jx, jw, threshold=1.5, backend="xla")
    for backend in ("cuda", "torch"):
        got = ops.binary_binary_dense(tx, tw, threshold=1.5,
                                      backend=backend)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stack(rng, m, k0, ns, per_channel):
    x = _pm1(rng, m, k0)
    jx, tx = _both(x)
    jws, tws, jts, tts, k = [], [], [], [], k0
    for n, pc in zip(ns, per_channel):
        jw, tw = _both(_pm1(rng, n, k))
        jws.append(jw)
        tws.append(tw)
        if pc:
            tv = rng.integers(-4, 4, size=n).astype(np.int32)
            jts.append(jnp.asarray(tv))
            tts.append(torch.from_numpy(tv))
        else:
            jts.append(1)
            tts.append(1)
        k = n
    return jx, tx, jws, tws, jts, tts


@pytest.mark.parametrize("m,k0,ns,per_channel", [
    (37, 50, [20, 33], [False, True]),
    (70, 97, [300, 65, 40], [True, False, True]),
    (4, 64, [32], [True]),
])
def test_fused_mlp_matches_pallas_interpret(m, k0, ns, per_channel):
    rng = np.random.default_rng(m + k0)
    jx, tx, jws, tws, jts, tts = _stack(rng, m, k0, ns, per_channel)
    want = jfused(jx, jws, jts, backend="interpret")
    for backend in ("cuda", "torch"):
        got = fused_binary_mlp(tx, tws, tts, backend=backend)
        assert got.length == ns[-1]
        np.testing.assert_array_equal(as_uint32(got.words),
                                      np.asarray(want.words))
    # the kernel-level entry on the raw words
    ks = [k0] + ns[:-1]
    got = fused_mlp_words(tx.words, [w.words for w in tws], ks, tts)
    np.testing.assert_array_equal(as_uint32(got), np.asarray(want.words))


def test_fused_mlp_validates_chain():
    rng = np.random.default_rng(0)
    _, tx, _, tws, _, tts = _stack(rng, 4, 64, [32, 16], [True, True])
    with pytest.raises(ValueError):
        fused_binary_mlp(tx, tws[::-1], tts)
    with pytest.raises(ValueError):
        fused_binary_mlp(tx, tws, [None, 1])
    with pytest.raises(ValueError):
        fused_mlp_words(tx.words, [tws[1].words], [64], [1])


def test_stack_plan_hopper_residency_rule():
    # BinaryNet fc1+fc2 at batch 256: 2 rows per block, 128 blocks
    sp = stack_plan(256, 8192, [1024, 1024])
    assert sp["fits"] and sp["bm"] == 2 and sp["buf_words"] == 256
    assert sp["smem_bytes"] == 8 * 2 * 256 + 4 * 32 * 257
    # large M caps the row tile at 32
    assert stack_plan(100000, 8192, [1024])["bm"] == 32
    # a very wide input shrinks the row tile until the buffers fit
    wide = stack_plan(100000, 32 * 20000, [64])
    assert wide["fits"] and wide["bm"] < 32
    assert wide["smem_bytes"] <= 232448
    # one launch takes at most 8 layers; too wide for even 1 row: no fit
    assert not stack_plan(4, 64, [64] * 9)["fits"]
    assert not stack_plan(4, 32 * 40000, [64])["fits"]


def test_wrappers_refuse_bad_operands():
    xp = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        popcount_gemm(xp, torch.zeros(3, 3, dtype=torch.int32), 64)
    with pytest.raises(ValueError):
        popcount_gemm(xp, xp, 64, pack_out=True)
    with pytest.raises(ValueError):
        popcount_gemm(xp, xp, 64, threshold=1,
                      threshold_vec=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        popcount_gemm(xp, xp, 65)
    with pytest.raises(ValueError):
        popcount_gemm(xp.to("meta"), xp.to("meta"), 64)
    assert popcount_gemm_plain(xp, xp, 64).shape == (4, 4)
