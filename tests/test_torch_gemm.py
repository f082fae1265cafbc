"""The port's popcount GEMM and fused binary MLP against the reference.

Pins (1) popcount_gemm's plain version bit for bit against the Pallas
popcount_gemm kernel in interpret mode and the ref oracle — dot, +-1 and
packed outputs, scalar and per-channel thresholds, valid_n masking, odd
M/K/N; (2) binary_binary_dense on both port backends against the
reference's "xla" dispatch on the odd shapes of tests/test_fused.py;
(3) fused_mlp_words and fused_binary_mlp against the Pallas fused_mlp
kernel in interpret mode and the chained path; (4) the Hopper
rule of stack_plan (row tile, cluster size, shared memory, fit) and the
cluster's block slices; (5) the cluster kernel's arithmetic, emulated in
torch, against the Pallas fused_mlp kernel; (6) the b1 popcount_gemm
kernel's arithmetic per tile, emulated in torch, against the Pallas
popcount_gemm kernel in every epilogue, and its tile rule.  Every
comparison is exact."""
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
from repro_torch.kernels.fused_mlp import (_launch,  # noqa: E402
                                           block_slices, fused_binary_mlp,
                                           fused_mlp_words, stack_plan)
from repro_torch.kernels.packed import (PackedArray, as_uint32,  # noqa: E402
                                        from_uint32, pack_words,
                                        popcount_u32)
from repro_torch.kernels.popcount_gemm import TILES as GEMM_TILES  # noqa
from repro_torch.kernels.popcount_gemm import _launch as _gemm_launch  # noqa
from repro_torch.kernels.popcount_gemm import (popcount_gemm,  # noqa: E402
                                               popcount_gemm_plain,
                                               tile_plan)
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
    """The rule of the cluster kernel: it splits N over a cluster, so
    the plan picks a row tile of 16, 32 or 64 and a cluster of 16 or 8
    blocks by the waves of clusters the card runs at once."""
    main = ((8192, [1024, 1024]), (9216, [4096, 4096]))
    # the six main shapes on an H100 (7 clusters of 16 or 15 of 8 at
    # once): batches 1 and 32 fit one wave of clusters of 16 at BM = 16;
    # batch 256 needs 2 waves of 16 (8 tiles of 32) but 1 of 8
    for k0, ns in main:
        for m, bm, cs in ((1, 16, 16), (32, 16, 16), (256, 32, 8)):
            sp = stack_plan(m, k0, ns)
            assert (sp["bm"], sp["cs"], sp["waves"]) == (bm, cs, 1)
            assert sp["blocks"] == -(-m // bm) * cs and sp["fits"]
            assert sp["ring"] == 4
        # 128 rows: 8 tiles of 16 take 2 waves, 4 tiles of 32 one
        assert (stack_plan(128, k0, ns)["bm"],
                stack_plan(128, k0, ns)["cs"]) == (32, 16)
        # a card that runs 8 clusters of 16 keeps them at batch 256
        assert stack_plan(256, k0, ns, clusters={16: 8, 8: 16})["cs"] == 16
        # one that cannot schedule 16 takes 8
        assert stack_plan(1, k0, ns, clusters={16: 0, 8: 15})["cs"] == 8
    # AlexNet's buffers: rows of 288 + 4 words beside a 4 x 36 KB ring
    # and the rows' popcounts
    sp = stack_plan(256, 9216, [4096, 4096])
    assert sp["buf_words"] == 288
    assert sp["smem_bytes"] == 4 * 36864 + 2 * 4 * 32 * 292 + 4 * 32
    # within one block's shared memory whatever M, and both stacks fit
    for k0, ns in main:
        for m in (1, 7, 32, 33, 255, 256, 1000, 100000):
            sp = stack_plan(m, k0, ns)
            assert sp["smem_bytes"] <= 232448 and sp["fits"]
            tiles = -(-m // sp["bm"])
            assert sp["waves"] == -(-tiles // {16: 7, 8: 15}[sp["cs"]])
    # BM = 64 only where its buffers fit: a narrow stack takes it, the
    # wide ones stop at 32
    assert stack_plan(100000, 97, [300, 65])["bm"] == 64
    assert stack_plan(100000, 9216, [4096, 4096])["bm"] == 32
    assert (stack_plan(256, 97, [300, 65])["bm"],
            stack_plan(256, 97, [300, 65])["cs"]) == (64, 16)
    # one launch takes at most 8 layers, and inputs up to 656 words
    # (BM = 16: 2 x 16 x (656 + 4) x 4 B and the popcounts beside the ring)
    assert stack_plan(4, 64, [64] * 8)["fits"]
    assert not stack_plan(4, 64, [64] * 9)["fits"]
    assert stack_plan(1, 32 * 656, [64])["fits"]
    assert not stack_plan(1, 32 * 657, [64])["fits"]
    assert not stack_plan(4, 32 * 40000, [64])["fits"]
    with pytest.raises(ValueError):
        stack_plan(4, 64, [64], clusters={16: 0, 8: 0})


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("n", [1, 20, 32, 33, 300, 1000, 1024, 4096])
def test_block_slices_cover_every_word_once(n, cs):
    """Block r of a cluster owns the words [r*nw/CS, (r+1)*nw/CS): whole
    words, every one owned once, sizes within one of each other; with
    fewer words than blocks (N = 1, 20, 32, 33, 300 at CS = 16) some
    blocks own none (and still join every cluster barrier)."""
    nw = -(-n // 32)
    slices = block_slices(n, cs)
    assert len(slices) == cs
    assert [w for lo, hi in slices for w in range(lo, hi)] == list(range(nw))
    sizes = [hi - lo for lo, hi in slices]
    assert max(sizes) - min(sizes) <= 1
    assert (0 in sizes) == (nw < cs)


def _cluster_emulation(x, ws, ks, ts, cs):
    """csrc/fused_mlp.cu's arithmetic in torch: K zero-padded to whole
    MMA depths of 8 words; each block of a cluster of ``cs`` computes its
    slice of the output words as dot = K - 2*(pc_x + pc_w) + 4*popc(x &
    w), tested as 4*and - 2*pc_x - 2*pc_w >= T - K with the right side
    clamped to int32 (a saturated folded threshold); columns past N
    never pass."""
    h = x
    for w, k, t in zip(ws, ks, ts):
        n, kw = w.shape
        pad = -(-kw // 8) * 8 - kw
        hp = torch.nn.functional.pad(h, (0, pad))
        wp = torch.nn.functional.pad(w, (0, pad))
        pcx = popcount_u32(hp).sum(1, dtype=torch.int64)
        bits = torch.zeros(h.shape[0], 32 * (-(-n // 32)), dtype=torch.bool)
        for lo, hi in block_slices(n, cs):
            for col in range(32 * lo, min(32 * hi, n)):
                both = popcount_u32(hp & wp[col]).sum(1, dtype=torch.int64)
                pcw = int(popcount_u32(wp[col]).sum())
                thr = int(t[col]) if isinstance(t, torch.Tensor) else t
                tk = min(max(thr - k, -2 ** 31), 2 ** 31 - 1)
                bits[:, col] = 4 * both - 2 * pcx - 2 * pcw >= tk
        h = pack_words(torch.where(bits[:, :n], 1.0, -1.0), -1)
    return h


@pytest.mark.parametrize("cs", [16, 8])
@pytest.mark.parametrize("m,k0,ns,per_channel", [
    (37, 50, [20, 33], [False, True]),
    (9, 97, [300, 65, 40], [True, False, True]),
    (4, 64, [32], [True]),
])
def test_cluster_arithmetic_matches_pallas_interpret(m, k0, ns, per_channel,
                                                     cs):
    """The kernel's closed form and threshold fold, per block slice,
    against the Pallas fused_mlp kernel in interpret mode; the first
    per-channel layer holds the int32 extremes of a saturated fold."""
    rng = np.random.default_rng(m + k0 + cs)
    jx, tx, jws, tws, jts, tts = _stack(rng, m, k0, ns, per_channel)
    li = per_channel.index(True)
    tv = np.asarray(jts[li]).copy()
    tv[:2] = [-2 ** 31, 2 ** 31 - 1]
    jts[li], tts[li] = jnp.asarray(tv), torch.from_numpy(tv)
    want = jfused(jx, jws, jts, backend="interpret")
    got = _cluster_emulation(tx.words, [w.words for w in tws],
                             [k0] + ns[:-1], tts, cs)
    np.testing.assert_array_equal(as_uint32(got), np.asarray(want.words))


def test_launch_refuses_bad_configs_and_cpu_tensors():
    rng = np.random.default_rng(5)
    _, tx, _, tws, _, tts = _stack(rng, 4, 64, [32, 16], [True, False])
    ws = [w.words for w in tws]
    for config in ((8, 16), (16, 4), (128, 8)):
        with pytest.raises(ValueError, match="config"):
            _launch(tx.words, ws, [64, 32], tts, config)
    with pytest.raises(ValueError, match="CUDA"):
        _launch(tx.words, ws, [64, 32], tts, (16, 16))


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


def _b1_gemm_emulation(xw, ww, k, tile, threshold=None, threshold_vec=None,
                       pack_out=False, valid_n=None):
    """csrc/popcount_gemm.cu's arithmetic in torch, block by block: a
    (BM, BN) tile of zero-filled rows and columns, K zero-filled to
    whole stages of 8*WK words, part kk of K = MMA depth kk of every
    stage summed as popc(x & w), the parts added; pc_x and pc_w over
    the same words; dot = K - 2*(pc_x + pc_w) + 4*and, thresholds held
    as 4*and - 2*pc_x >= T - K + 2*pc_w in 64 bits, columns >= N (packed:
    >= valid_n) never passing; a warp's 32 columns one packed word."""
    bm, bn, wk = tile
    m, k32 = xw.shape
    n = ww.shape[0]
    valid_n = n if valid_n is None else valid_n
    stage = 8 * wk
    kp = -(-k32 // stage) * stage
    mp, np_ = -(-m // bm) * bm, -(-n // bn) * bn
    xp = torch.nn.functional.pad(xw, (0, kp - k32, 0, mp - m))
    wp = torch.nn.functional.pad(ww, (0, kp - k32, 0, np_ - n))
    col = torch.arange(np_)
    live = (col < n) & ((col < valid_n) if pack_out else True)
    if threshold_vec is not None:
        thr = torch.nn.functional.pad(threshold_vec.to(torch.int64),
                                      (0, np_ - n))
    else:
        thr = torch.full((np_,), 0 if threshold is None else threshold,
                         dtype=torch.int64)
    out = torch.zeros(mp, np_, dtype=torch.int64)
    for r0 in range(0, mp, bm):
        for c0 in range(0, np_, bn):
            xb, wb = xp[r0:r0 + bm], wp[c0:c0 + bn]
            parts = [torch.zeros(bm, bn, dtype=torch.int64)
                     for _ in range(wk)]
            for st in range(kp // stage):
                for kk in range(wk):
                    lo = st * stage + 8 * kk
                    both = xb[:, None, lo:lo + 8] & wb[None, :, lo:lo + 8]
                    parts[kk] += popcount_u32(both).sum(-1)
            both = sum(parts)
            pcx = popcount_u32(xb).sum(1, dtype=torch.int64)[:, None]
            pcw = popcount_u32(wb).sum(1, dtype=torch.int64)[None, :]
            y = 4 * both - 2 * pcx
            cols = slice(c0, c0 + bn)
            if threshold is None and threshold_vec is None:
                out[r0:r0 + bm, cols] = k + y - 2 * pcw
            else:
                tc = torch.where(live[cols], thr[cols] - k + 2 * pcw[0],
                                 torch.iinfo(torch.int64).max)
                out[r0:r0 + bm, cols] = y >= tc
    out = out[:m]
    if threshold is None and threshold_vec is None:
        return out[:, :n].to(torch.int32)
    if not pack_out:
        return torch.where(out[:, :n] == 1, 1, -1).to(torch.int32)
    return pack_words(torch.where(out == 1, 1.0, -1.0), -1)[:, :-(-n // 32)]


@pytest.mark.parametrize("tile", list(GEMM_TILES))
@pytest.mark.parametrize("m,k,n", [(1, 300, 20), (17, 97, 65),
                                   (33, 1061, 10), (5, 33, 40)])
def test_b1_gemm_arithmetic_matches_pallas_interpret(m, k, n, tile):
    """Every tile's arithmetic against the Pallas popcount_gemm kernel in
    interpret mode, in every epilogue: the dot, a scalar threshold, a
    per-channel one holding the int32 extremes, and packed decisions with
    valid_n = N - 3 (the 8-column tile does not pack).  The reference
    packs only N % 32 == 0, so it gets zero weight rows to a whole word
    and the same valid_n."""
    rng = np.random.default_rng(m + k + n + sum(tile))
    jx, tx = _both(_pm1(rng, m, k))
    jw, tw = _both(_pm1(rng, n, k))
    tv = rng.integers(-30, 31, size=n).astype(np.int32)
    tv[:2] = [-2 ** 31, 2 ** 31 - 1]
    n32 = -(-n // 32) * 32
    jw32 = jnp.pad(jw.words, ((0, n32 - n), (0, 0)))
    tv32 = np.pad(tv, (0, n32 - n))
    for kw in (dict(), dict(threshold=-3),
               dict(threshold_vec=tv),
               dict(threshold_vec=tv, pack_out=True, valid_n=n - 3)):
        if kw.get("pack_out"):
            if tile[1] < 32:
                continue
            want = jgemm(jx.words, jw32, k, interpret=True,
                         threshold_vec=jnp.asarray(tv32), pack_out=True,
                         valid_n=n - 3)
        else:
            jkw = dict(kw)
            if "threshold_vec" in jkw:
                jkw["threshold_vec"] = jnp.asarray(tv)
            want = jgemm(jx.words, jw.words, k, interpret=True, **jkw)
        tkw = dict(kw)
        if "threshold_vec" in tkw:
            tkw["threshold_vec"] = torch.from_numpy(tv)
        got = _b1_gemm_emulation(tx.words, tw.words, k, tile, **tkw)
        got_np = as_uint32(got) if kw.get("pack_out") else got.numpy()
        np.testing.assert_array_equal(got_np, np.asarray(want), str(kw))
        # and the port's plain version, which the kernel is held to
        np.testing.assert_array_equal(
            got, popcount_gemm_plain(tx.words, tw.words, k, **tkw))


def test_gemm_tile_plan_main_shapes():
    """The main paths' heads on an H100 (132 SMs).  AlexNet's fc8 (N =
    1000, K32 = 128) at batch 1 runs every n8 column tile in a block of
    its own, 125 blocks: one block on 125 of the 132 SMs, the most any
    tile gives; at batch 32 250, at batch 256 64 x 32 tiles with K in 2
    parts, 128 blocks.  BinaryNet's fc3 (N = 10) has 2 column tiles, so
    the narrowest tile at every batch."""
    fc8 = {b: tile_plan(b, 1000, 128, 132) for b in (1, 32, 256)}
    assert [(p["bm"], p["bn"], p["wk"], p["blocks"])
            for p in fc8.values()] == [(16, 8, 4, 125), (16, 8, 4, 250),
                                       (64, 32, 2, 128)]
    assert fc8[1]["grid"] == (1, 125) and fc8[1]["k_words"] == 128
    assert max(-(-1000 // bn) for _, bn, _ in GEMM_TILES) == 125
    fc3 = [tile_plan(b, 10, 32, 132) for b in (1, 32, 256)]
    assert [(p["bm"], p["bn"], p["wk"], p["blocks"]) for p in fc3] == \
        [(16, 8, 4, 2), (16, 8, 4, 4), (16, 8, 4, 32)]
    # the chained route packs: 32-column warps, BM = 16 at M = 1
    assert (tile_plan(1, 4096, 288, 132, pack_out=True)["bm"],
            tile_plan(1, 4096, 288, 132, pack_out=True)["bn"]) == (16, 32)
    assert tile_plan(256, 4096, 288, 132, pack_out=True)["bn"] == 64


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("pack_out", [False, True])
def test_gemm_tile_plan_is_legal_everywhere(sms, pack_out):
    """At every (m, n, k32) swept: a tile of TILES, no taller than M
    rounded up to 16 rows (unless none is), 32-column warps where
    packing, a grid that covers M and N, K zero-filled to whole stages
    (less than a stage of padding), and either half a block per SM or
    the most blocks any candidate gives."""
    for m in (1, 2, 15, 16, 17, 63, 64, 65, 300, 4096, 262144):
        for n in (1, 8, 10, 33, 65, 1000, 4096):
            for k32 in (1, 2, 4, 33, 128, 288):
                p = tile_plan(m, n, k32, sms, pack_out)
                tile = (p["bm"], p["bn"], p["wk"])
                assert tile in GEMM_TILES
                assert p["bm"] <= max(16, -(-m // 16) * 16)
                assert not pack_out or p["bn"] >= 32
                assert p["grid"] == (-(-m // p["bm"]), -(-n // p["bn"]))
                assert p["blocks"] == p["grid"][0] * p["grid"][1]
                stage = 8 * p["wk"]
                assert p["k_words"] % stage == 0
                assert k32 <= p["k_words"] < k32 + stage
                cands = [t for t in GEMM_TILES
                         if t[0] <= max(16, -(-m // 16) * 16)
                         and (not pack_out or t[1] >= 32)]
                most = max(-(-m // bm) * -(-n // bn) for bm, bn, _ in cands)
                assert 2 * p["blocks"] >= sms or p["blocks"] == most


def test_gemm_launch_refuses_bad_tiles_and_cpu_tensors():
    xp = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile"):
        _gemm_launch(xp, xp, 64, (32, 32, 1))
    with pytest.raises(ValueError, match="pack_out"):
        _gemm_launch(xp, xp, 64, (16, 8, 4), threshold=0, pack_out=True)
    with pytest.raises(ValueError, match="CUDA"):
        _gemm_launch(xp, xp, 64, (16, 8, 4))
