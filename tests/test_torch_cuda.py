"""The Hopper kernels on the card: each against its plain version, bit
for bit, and the BinaryNet and AlexNet forwards' launch counts.

Every test here is marked ``gpu`` and skips, inside the ``cuda``
fixture, on a host without a CUDA device (the decision is never taken
at import or collection time, so every worker collects the same tests).
Run them on a GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

from repro_torch import graph  # noqa: E402
from repro_torch.core.workloads import (alexnet_imagenet,  # noqa: E402
                                        binarynet_cifar10)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import fused_mlp  # noqa: E402
from repro_torch.kernels.fused_mlp import CLUSTERS as FUSED_CLUSTERS  # noqa
from repro_torch.kernels.fused_mlp import ROW_TILES as FUSED_ROW_TILES  # noqa
from repro_torch.kernels.fused_mlp import _launch as _fused_launch  # noqa
from repro_torch.kernels.fused_mlp import (fused_mlp_words,  # noqa: E402
                                           fused_mlp_words_plain, stack_plan)
from repro_torch.kernels.fused_mlp import \
    smem_bytes as fused_smem_bytes  # noqa: E402
from repro_torch.kernels.pack import PATHS as PACK_PATHS  # noqa: E402
from repro_torch.kernels.pack import _launch as _pack_launch  # noqa: E402
from repro_torch.kernels.pack import pack, pack_path, pack_plain  # noqa
from repro_torch.kernels.packed import PackedArray, pack_words  # noqa: E402
from repro_torch.kernels.packed_conv import TILES as CONV_TILES  # noqa: E402
from repro_torch.kernels.packed_conv import _launch as _conv_launch  # noqa
from repro_torch.kernels.packed_conv import (packed_conv2d,  # noqa: E402
                                             packed_conv2d_plain,
                                             pad_words_spatial)
from repro_torch.kernels.popcount_gemm import TILES as GEMM_TILES  # noqa
from repro_torch.kernels.popcount_gemm import _launch as _gemm_launch  # noqa
from repro_torch.kernels.popcount_gemm import (popcount_gemm,  # noqa: E402
                                               popcount_gemm_plain)
from repro_torch.kernels.xnor_gemm import (TILES, _launch,  # noqa: E402
                                           tile_plan, xnor_gemm,
                                           xnor_gemm_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _pm1(rng, *shape, device):
    x = rng.choice([-1.0, 1.0], size=shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def _words(rng, m, k, device):
    return pack_words(_pm1(rng, m, k, device=device), -1).contiguous()


@pytest.mark.parametrize("m,k", [(37, 100), (1024, 128), (3, 32)])
def test_pack_kernel(cuda, m, k):
    x = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (m, k)).astype(np.float32)).to(cuda)
    x[0, :4] = torch.tensor([float("nan"), -0.0, 0.0, 1.0])
    assert torch.equal(pack(x), pack_plain(x))


def _pack_operands(rng, m, k, device):
    """Normal x with NaN, -0.0 and 0.0 in row 0, and a scale [K] with
    negative entries, a zero and (columns 4-7) values that make the
    products of row 1 denormal or round them to 0."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    scale = rng.standard_normal(k).astype(np.float32)
    x[0, :3] = [np.nan, -0.0, 0.0][:k]
    scale[3:4] = 0.0
    if m > 1 and k > 7:
        x[1, 4:8] = [1e-20, -1e-20, 1e-30, 3e-23]
        scale[4:8] = [1e-20, 1e-20, 1e-30, -2e-23]
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(scale).to(device))


def _pack_paths(k):
    """The kernel paths an aligned [M, K] operand allows."""
    return [p for p in PACK_PATHS if p == "rows" or k % 32 == 0]


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("m,k", [(37, 100), (1024, 128), (5, 33), (3, 32),
                                 (300, 256), (9, 1), (70, 68)])
def test_pack_every_path(cuda, m, k, scaled):
    """The plan's path and every path the operands allow (K % 32 != 0:
    rows only; else flat as well), with and
    without the scale, bit for bit; a path they do not allow raises."""
    x, scale = _pack_operands(np.random.default_rng(m * k), m, k, cuda)
    s = scale if scaled else None
    want = pack_plain(x, s)
    assert torch.equal(pack(x, s), want)
    for path in PACK_PATHS:
        if path in _pack_paths(k):
            assert torch.equal(_pack_launch(x, s, path), want), path
        else:
            with pytest.raises(RuntimeError):
                _pack_launch(x, s, path)


def test_pack_scale_keeps_denormal_products(cuda):
    """A product that is denormal gives bit 1, one that rounds to 0 bit
    0 (no flush to zero), as torch's multiply does."""
    x, scale = _pack_operands(np.random.default_rng(3), 4, 128, cuda)
    bits = pack_plain(x, scale)[1, 0]
    assert [(int(bits) >> b) & 1 for b in range(4, 8)] == [1, 0, 0, 0]
    for path in _pack_paths(128):
        assert torch.equal(_pack_launch(x, scale, path),
                           pack_plain(x, scale))


@pytest.mark.parametrize("scaled", [False, True])
def test_pack_view_at_an_offset(cuda, scaled):
    """x and scale 4 bytes past a 16-byte boundary (contiguous views at
    a storage offset) take the 4-byte path and read nothing outside."""
    m, k = 33, 256
    x, scale = _pack_operands(np.random.default_rng(5), m, k, cuda)
    xo = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)
    xo.copy_(x)
    so = torch.empty(k + 1, device=cuda)[1:]
    so.copy_(scale)
    s = so if scaled else None
    assert xo.data_ptr() % 16 == 4
    assert pack_path(k, xo.data_ptr(), _build.ptr(s)) == "rows"
    assert torch.equal(pack(xo, s), pack_plain(xo, s))
    with pytest.raises(RuntimeError):
        _pack_launch(xo, s, "flat")
    # an aligned x with a scale at an offset: 4-byte loads as well
    assert torch.equal(pack(x, so), pack_plain(x, so))


@pytest.mark.parametrize("path", [None, "flat", "rows"])
def test_pack_counts_one_launch_per_call(cuda, path):
    x, scale = _pack_operands(np.random.default_rng(9), 2048, 128, cuda)
    _build.reset_launch_counts()
    if path is None:
        pack(x, scale)
    else:
        _pack_launch(x, scale, path)
    torch.cuda.synchronize()
    assert _build.launch_counts()["pack"] == 1


@pytest.mark.parametrize("m,k,n,thr,pack_out", [
    (37, 50, 20, "scalar", True), (5, 97, 33, "vector", True),
    (64, 128, 96, "vector", False), (3, 33, 65, None, False),
    (300, 2000, 70, "scalar", False), (256, 1024, 10, None, False),
    (1, 4096, 1000, None, False), (32, 4096, 1000, None, False),
    (256, 4096, 1000, None, False), (1, 1024, 10, None, False),
    (17, 9216, 4096, "vector", True), (1, 4096, 4096, "vector", True)])
def test_popcount_gemm_kernel(cuda, m, k, n, thr, pack_out):
    rng = np.random.default_rng(m + k + n)
    xp, wp = _words(rng, m, k, cuda), _words(rng, n, k, cuda)
    kw = dict(threshold=2 if thr == "scalar" else None,
              threshold_vec=torch.from_numpy(rng.integers(
                  -5, 5, n).astype(np.int32)).to(cuda)
              if thr == "vector" else None, pack_out=pack_out)
    assert torch.equal(popcount_gemm(xp, wp, k, **kw),
                       popcount_gemm_plain(xp, wp, k, **kw))


def _gemm_epilogues(rng, n, device):
    """The four epilogues: the dot, +-1 after a scalar threshold, +-1
    after a per-channel one holding the int32 extremes, and packed
    decisions with valid_n = N - 3."""
    tv = rng.integers(-40, 41, n).astype(np.int32)
    tv[:2] = [-2 ** 31, 2 ** 31 - 1]
    tvec = torch.from_numpy(tv).to(device)
    return [dict(), dict(threshold=-3), dict(threshold_vec=tvec),
            dict(threshold_vec=tvec, pack_out=True, valid_n=n - 3)]


@pytest.mark.parametrize("tile", list(GEMM_TILES))
@pytest.mark.parametrize("m,k,n", [(1, 4096, 1000), (17, 97, 65),
                                   (300, 1024, 10), (300, 1061, 1000),
                                   (17, 50, 10), (1, 33, 65)])
def test_popcount_gemm_every_tile(cuda, tile, m, k, n):
    """Every tile on M = 1, 17, 300, N = 10, 65, 1000 and odd K (K32 =
    2, 4, 34: 4-byte copies where K32 % 4 != 0), in every epilogue, bit
    for bit; the 8-column tile refuses pack_out; two calls give the same
    words."""
    rng = np.random.default_rng(m + k + n + sum(tile))
    xp, wp = _words(rng, m, k, cuda), _words(rng, n, k, cuda)
    for kw in _gemm_epilogues(rng, n, cuda):
        if kw.get("pack_out") and tile[1] < 32:
            with pytest.raises(ValueError):
                _gemm_launch(xp, wp, k, tile, **kw)
            continue
        got = _gemm_launch(xp, wp, k, tile, **kw)
        assert torch.equal(got, popcount_gemm_plain(xp, wp, k, **kw)), kw
        assert torch.equal(got, _gemm_launch(xp, wp, k, tile, **kw))


def test_popcount_gemm_operands_at_an_offset(cuda):
    """Words 4 bytes past a 16-byte boundary with K32 % 4 == 0: 4-byte
    copies of that operand."""
    rng = np.random.default_rng(11)
    m, k, n = 40, 1024, 70
    xp, wp = _words(rng, m, k, cuda), _words(rng, n, k, cuda)
    xo = torch.empty(xp.numel() + 1, dtype=torch.int32,
                     device=cuda)[1:].view(m, k // 32)
    xo.copy_(xp)
    for tile in GEMM_TILES:
        assert torch.equal(_gemm_launch(xo, wp, k, tile),
                           popcount_gemm_plain(xp, wp, k))
        assert torch.equal(_gemm_launch(wp, xo, k, tile),
                           popcount_gemm_plain(wp, xp, k))


@pytest.mark.parametrize("tile", [None] + list(GEMM_TILES))
def test_popcount_gemm_counts_one_launch_per_call(cuda, tile):
    rng = np.random.default_rng(13)
    xp, wp = _words(rng, 32, 4096, cuda), _words(rng, 1000, 4096, cuda)
    _build.reset_launch_counts()
    if tile is None:
        popcount_gemm(xp, wp, 4096)
    else:
        _gemm_launch(xp, wp, 4096, tile)
    torch.cuda.synchronize()
    assert _build.launch_counts()["popcount_gemm"] == 1


@pytest.mark.parametrize("nb,h,c,f,k,s,pad,thr,pack_out", [
    (2, 8, 33, 20, 3, 1, 1, None, False),
    (1, 9, 64, 32, 3, 2, 1, "scalar", True),
    (1, 7, 16, 10, 5, 1, 0, "vector", False),
    (2, 6, 50, 33, 3, 1, 1, "vector", True),
    (4, 32, 128, 128, 3, 1, 1, "vector", True),
    # C32 = 12 (108 words: no multiple of the MMA depth) at 13x13
    (2, 13, 384, 384, 3, 1, 1, "vector", True),
    (1, 13, 384, 384, 3, 1, 1, None, False),
    # odd F
    (3, 13, 384, 37, 3, 1, 1, "scalar", False),
    (2, 11, 96, 71, 3, 2, 0, "vector", True)])
def test_packed_conv2d_kernel(cuda, nb, h, c, f, k, s, pad, thr, pack_out):
    rng = np.random.default_rng(nb + h + c + f)
    xw, ww, kw = _conv_operands(rng, nb, h, c, f, k, s, pad, thr, pack_out,
                                cuda)
    assert torch.equal(packed_conv2d(xw, ww, **kw),
                       packed_conv2d_plain(xw, ww, **kw))


@pytest.mark.parametrize("nb,h,c,f,k,s,pad,thr", [
    (1, 9, 64, 32, 3, 2, 1, "scalar"), (2, 6, 50, 33, 3, 1, 1, "vector"),
    (4, 32, 128, 128, 3, 1, 1, "vector"),
    (2, 13, 384, 384, 3, 1, 1, "vector"),
    (2, 11, 96, 71, 3, 2, 0, "scalar")])
def test_packed_conv2d_kernel_valid_f(cuda, nb, h, c, f, k, s, pad, thr):
    """Packed decisions of the first F - 3 filters only: the bits of the
    rest are zero, in the last word and in whole words past it."""
    rng = np.random.default_rng(nb + h + c + f)
    xw, ww, kw = _conv_operands(rng, nb, h, c, f, k, s, pad, thr, True,
                                cuda, cut=3)
    assert torch.equal(packed_conv2d(xw, ww, **kw),
                       packed_conv2d_plain(xw, ww, **kw))


def _conv_operands(rng, nb, h, c, f, k, s, pad, thr, pack_out, device,
                   cut=0):
    """Packed operands and keywords of a conv; with ``cut``, valid_f is
    F - cut."""
    x = _pm1(rng, nb, h, h, c, device=device)
    w = _pm1(rng, k, k, c, f, device=device)
    xw = pad_words_spatial(pack_words(x, -1), pad, pad).contiguous()
    ww = pack_words(w, 2).reshape(k * k * xw.shape[-1], f).contiguous()
    ho = (h + 2 * pad - k) // s + 1
    kw = dict(kh=k, kw=k, c=c, stride=s, ho=ho, wo=ho, pack_out=pack_out,
              threshold=2 if thr == "scalar" else None,
              threshold_vec=torch.from_numpy(rng.integers(
                  -4, 4, f).astype(np.int32)).to(device)
              if thr == "vector" else None,
              valid_f=f - cut if cut else None)
    return xw, ww, kw


@pytest.mark.parametrize("tile", list(CONV_TILES))
@pytest.mark.parametrize("nb,h,c,f,k,s,pad", [
    (2, 8, 33, 20, 3, 1, 1), (1, 7, 16, 10, 5, 1, 0),
    (2, 13, 384, 70, 3, 2, 1), (3, 9, 128, 96, 3, 1, 1)])
def test_packed_conv2d_every_tile(cuda, nb, h, c, f, k, s, pad, tile):
    """Every output tile on the edge shapes (C32 = 2, 1, 12, 4; 16- and
    4-byte copies): the three epilogues, the packed one with valid_f = F
    and F - 3, bit for bit."""
    rng = np.random.default_rng(nb + h + c + f)
    for thr, pack_out, cut in ((None, False, 0), ("scalar", False, 0),
                               ("vector", True, 0), ("vector", True, 3)):
        xw, ww, kw = _conv_operands(rng, nb, h, c, f, k, s, pad, thr,
                                    pack_out, cuda, cut)
        got = _conv_launch(xw, ww, tile, **kw)
        assert torch.equal(got, packed_conv2d_plain(xw, ww, **kw))


@pytest.mark.parametrize("tile", [None] + list(CONV_TILES))
def test_packed_conv2d_counts_one_launch_per_call(cuda, tile):
    """A call launches one kernel and counts one, with the plan's tile
    (None) at an AlexNet conv4 shape or with each tile forced."""
    rng = np.random.default_rng(7)
    xw, ww, kw = _conv_operands(rng, 2, 13, 384, 384, 3, 1, 1, "vector",
                                True, cuda)
    _build.reset_launch_counts()
    if tile is None:
        packed_conv2d(xw, ww, **kw)
    else:
        _conv_launch(xw, ww, tile, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()["packed_conv2d"] == 1


# the edge stacks: odd N with fewer words than a cluster has blocks (20,
# 33, 300, 65, 40), K = 50 and 97 bits (4-byte weight copies), one layer,
# AlexNet's fc6 + fc7 at batch 1 (BM = 64 does not fit it), and 8 layers
FUSED_STACKS = [(37, 50, [20, 33]), (301, 97, [300, 65, 40]), (5, 64, [32]),
                (1, 9216, [4096, 4096]),
                (70, 128, [64, 40, 96, 33, 20, 300, 65, 10])]
FUSED_CONFIGS = [(bm, cs) for bm in FUSED_ROW_TILES for cs in FUSED_CLUSTERS]


def _fused_operands(rng, m, k0, ns, thr, device):
    x = _words(rng, m, k0, device)
    ws, ks, ts, k = [], [], [], k0
    for i, n in enumerate(ns):
        ws.append(_words(rng, n, k, device))
        ks.append(k)
        vector = thr == "vector" or (thr == "mixed" and i % 2 == 0)
        ts.append(torch.from_numpy(rng.integers(-3, 4, n).astype(np.int32)
                                   ).to(device) if vector
                  else int(rng.integers(-3, 4)))
        k = n
    return x, ws, ks, ts


@pytest.mark.parametrize("thr", ["scalar", "vector", "mixed"])
@pytest.mark.parametrize("m,k0,ns", FUSED_STACKS + [(256, 8192, [1024, 1024])])
def test_fused_mlp_kernel(cuda, m, k0, ns, thr):
    """The plan's config and every forced (BM, CS) bit for bit against
    the plain chain; a config whose block does not fit raises."""
    rng = np.random.default_rng(m + k0 + len(ns))
    x, ws, ks, ts = _fused_operands(rng, m, k0, ns, thr, cuda)
    want = fused_mlp_words_plain(x, ws, ks, ts)
    assert torch.equal(fused_mlp_words(x, ws, ks, ts), want)
    buf_words = stack_plan(m, k0, ns)["buf_words"]
    for config in FUSED_CONFIGS:
        if fused_smem_bytes(config[0], buf_words) > 232448:
            with pytest.raises(ValueError, match="shared memory"):
                _fused_launch(x, ws, ks, ts, config)
        else:
            assert torch.equal(_fused_launch(x, ws, ks, ts, config), want)


def test_fused_mlp_unschedulable_config_raises(cuda, monkeypatch):
    """No silent fallback: a block too large for shared memory raises; a
    cluster the card cannot schedule raises; the plan takes clusters of
    8 where 16 cannot be scheduled, and raises where neither can."""
    rng = np.random.default_rng(3)
    x, ws, ks, ts = _fused_operands(rng, 1, 9216, [4096, 4096], "vector",
                                    cuda)
    with pytest.raises(ValueError, match="shared memory"):
        _fused_launch(x, ws, ks, ts, (64, 16))
    want = fused_mlp_words_plain(x, ws, ks, ts)
    real = fused_mlp._active_clusters
    monkeypatch.setattr(fused_mlp, "_active_clusters",
                        lambda d, bm, cs, bw: 0 if cs == 16
                        else real(d, bm, cs, bw))
    with pytest.raises(RuntimeError, match="cannot schedule"):
        _fused_launch(x, ws, ks, ts, (16, 16))
    _build.reset_launch_counts()
    assert torch.equal(fused_mlp_words(x, ws, ks, ts), want)
    assert _build.launch_counts()["fused_binary_mlp"] == 1
    monkeypatch.setattr(fused_mlp, "_active_clusters", lambda *a: 0)
    with pytest.raises(RuntimeError, match="can schedule no cluster"):
        fused_mlp_words(x, ws, ks, ts)


def test_fused_mlp_occupancy_and_shared_memory(cuda):
    """The card schedules a cluster of 16 and of 8 at every row tile that
    fits; the library's shared memory per block is the plan's."""
    lib = _build._load("fused_mlp")
    lib.fused_mlp_smem_bytes.argtypes = [ctypes.c_int] * 2
    for bm in FUSED_ROW_TILES:
        for buf_words in (8, 256, 288):
            assert lib.fused_mlp_smem_bytes(bm, buf_words) == \
                fused_smem_bytes(bm, buf_words)
    for cs in FUSED_CLUSTERS:
        assert fused_mlp._active_clusters(cuda, 16, cs, 288) >= 1
        assert fused_mlp._active_clusters(cuda, 32, cs, 288) >= 1


def test_binarynet_launch_counts_and_logits(cuda):
    cb = graph.compile(binarynet_cifar10())
    params = cb.init(torch.Generator().manual_seed(0))
    x = torch.randint(-3, 4, (4, 32, 32, 3),
                      generator=torch.Generator().manual_seed(1)
                      ).float().to(cuda)
    _build.reset_launch_counts()
    logits = cb.apply(params, x)
    torch.cuda.synchronize()
    # conv1 packs its signs in the entry_conv kernel: no pack launch
    assert _build.launch_counts() == {"pack": 0, "packed_conv2d": 5,
                                      "fused_binary_mlp": 1,
                                      "popcount_gemm": 1, "xnor_gemm": 0,
                                      "entry_conv": 1,
                                      "stem_conv": 0, "residual_conv": 0,
                                      "shortcut_conv": 0}
    ref = graph.compile(binarynet_cifar10(), backend="torch").apply(params, x)
    assert torch.equal(logits, ref)


def test_alexnet_launch_counts_and_logits(cuda):
    """The float entry convs run the same cuDNN calls on both backends
    (a float pool follows each, so the entry_conv kernel never runs),
    so the card's two backends agree exactly."""
    cb = graph.compile(alexnet_imagenet(), batch=2)
    params = cb.init(torch.Generator().manual_seed(0))
    x = torch.randint(-3, 4, (2, 227, 227, 3),
                      generator=torch.Generator().manual_seed(1)
                      ).float().to(cuda)
    _build.reset_launch_counts()
    logits = cb.apply(params, x)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"pack": 1, "packed_conv2d": 3,
                                      "fused_binary_mlp": 1,
                                      "popcount_gemm": 1, "xnor_gemm": 0,
                                      "entry_conv": 0,
                                      "stem_conv": 0, "residual_conv": 0,
                                      "shortcut_conv": 0}
    ref = graph.compile(alexnet_imagenet(), backend="torch").apply(params, x)
    assert logits.shape == (2, 1000) and torch.equal(logits, ref)


def _xnor_operands(rng, m, k, n, dtype, device):
    """Integer x in [-3, 3] and alpha in {0.5, 1, 2}: every sum is exact
    in float32, so kernel and plain version agree bit for bit."""
    x = torch.from_numpy(rng.integers(-3, 4, size=(m, k)).astype(
        np.float32)).to(device=device, dtype=dtype)
    wp = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(
        k // 32, n), dtype=np.int64).astype(np.int32)).to(device)
    alpha = torch.from_numpy(rng.choice([0.5, 1.0, 2.0], size=n).astype(
        np.float32)).to(device)
    return x, wp, alpha


@pytest.mark.parametrize("m,k,n,dtype,thr,pack_out", [
    (128, 128, 128, torch.float32, None, False),
    (384, 256, 384, torch.bfloat16, None, False),
    (37, 96, 40, torch.float32, "scalar", True),
    (111, 544, 200, torch.bfloat16, "vector", False),
    (1, 8192, 256, torch.bfloat16, "vector", True),
    (5, 1024, 65, torch.float32, "scalar", False),
    (20, 4096, 97, torch.bfloat16, "vector", True),
    # the row-tile boundaries: BM = 16 up to M = 16, then 64
    (16, 544, 97, torch.float32, None, False),
    (16, 96, 40, torch.bfloat16, "vector", True),
    (17, 544, 97, torch.bfloat16, None, False),
    (17, 96, 65, torch.float32, "scalar", True),
    (65, 544, 200, torch.float32, "vector", False),
    (65, 1024, 130, torch.bfloat16, None, False)])
def test_xnor_gemm_kernel(cuda, m, k, n, dtype, thr, pack_out):
    rng = np.random.default_rng(m + k + n)
    x, wp, alpha = _xnor_operands(rng, m, k, n, dtype, cuda)
    kw = dict(threshold=0.5 if thr == "scalar" else None,
              threshold_vec=torch.from_numpy(rng.integers(
                  -6, 7, n).astype(np.float32)).to(cuda)
              if thr == "vector" else None, pack_out=pack_out,
              valid_n=n - 3 if pack_out else None)
    got = xnor_gemm(x, wp, alpha, **kw)
    assert torch.equal(got, xnor_gemm_plain(x, wp, alpha, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("tile", list(TILES))
def test_xnor_gemm_every_tile(cuda, tile, splits, dtype):
    """Every output tile, whole K and K in 3 parts (K = 17 words), with
    M and N no multiple of any tile: exact y and packed words."""
    rng = np.random.default_rng(sum(tile) + splits)
    m, k, n = 150, 544, 200
    x, wp, alpha = _xnor_operands(rng, m, k, n, dtype, cuda)
    tvec = torch.from_numpy(rng.integers(-6, 7, n).astype(
        np.float32)).to(cuda)
    for kw in (dict(), dict(threshold_vec=tvec, pack_out=True,
                            valid_n=n - 7)):
        got = _launch(x, wp, alpha, (*tile, splits), **kw)
        assert torch.equal(got, xnor_gemm_plain(x, wp, alpha, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xnor_gemm_non_finite_and_deterministic(cuda, dtype):
    """+-inf and NaN in x land where the plain version's do; two calls
    give the same bits."""
    rng = np.random.default_rng(3)
    m, k, n = 19, 544, 97
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    for r, c, v in [(0, 5, float("inf")), (1, 7, float("-inf")),
                    (2, 9, float("nan")), (3, 1, float("inf")),
                    (3, 2, float("-inf"))]:
        x[r, c] = v
    x = x.to(device=cuda, dtype=dtype)
    _, wp, _ = _xnor_operands(rng, m, k, n, dtype, cuda)
    alpha = torch.ones(n, device=cuda)
    got = xnor_gemm(x, wp, alpha).float()
    want = xnor_gemm_plain(x, wp, alpha).float()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    again = xnor_gemm(x, wp, alpha).float()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_xnor_gemm_weights_at_an_offset(cuda):
    """Weights that start 4 bytes past a 16-byte boundary (a contiguous
    view at a storage offset), N a multiple of 4: every tile."""
    rng = np.random.default_rng(5)
    m, k, n = 37, 544, 200
    x, wp, alpha = _xnor_operands(rng, m, k, n, torch.bfloat16, cuda)
    off = torch.empty(wp.numel() + 1, dtype=wp.dtype, device=cuda)
    off[1:] = wp.reshape(-1)
    wo = off[1:].view(k // 32, n)
    assert wo.is_contiguous() and wo.data_ptr() % 16 == 4
    want = xnor_gemm_plain(x, wp, alpha)
    assert torch.equal(xnor_gemm(x, wo, alpha), want)
    for tile in TILES:
        assert torch.equal(_launch(x, wo, alpha, (*tile, 2)), want)


@pytest.mark.parametrize("m,k,n,dtype", [
    (128, 4096, 512, torch.bfloat16), (1, 8192, 1024, torch.float32)])
def test_xnor_gemm_counts_every_kernel_it_launches(cuda, m, k, n, dtype):
    """A call launches one kernel, or two where its plan splits K (the
    parts, then their sum): the count says which."""
    rng = np.random.default_rng(m + n)
    x, wp, alpha = _xnor_operands(rng, m, k, n, dtype, cuda)
    planes = 3 if dtype == torch.float32 else 1
    splits = tile_plan(m, n, k // 32,
                       torch.cuda.get_device_properties(
                           cuda).multi_processor_count, planes)["splits"]
    _build.reset_launch_counts()
    xnor_gemm(x, wp, alpha)
    torch.cuda.synchronize()
    assert _build.launch_counts()["xnor_gemm"] == (1 if splits == 1 else 2)


def test_binary_dense_launches_xnor_gemm(cuda):
    rng = np.random.default_rng(0)
    x, wp, alpha = _xnor_operands(rng, 6, 512, 96, torch.bfloat16, cuda)
    w = PackedArray(wp, length=500, axis=-2)
    _build.reset_launch_counts()
    y = ops.binary_dense(x[:, :500].reshape(2, 3, 500), w, alpha,
                         threshold=np.zeros(96), pack_out=True)
    torch.cuda.synchronize()
    assert _build.launch_counts()["xnor_gemm"] == 1
    want = ops.binary_dense(x[:, :500].reshape(2, 3, 500), w, alpha,
                            threshold=np.zeros(96), pack_out=True,
                            backend="torch")
    assert torch.equal(y.words, want.words)


# ------------------------------------------------------------------ #
# the graphed apply and the server on the card                         #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("batch", [1, 32, 256])
@pytest.mark.parametrize("workload,per_forward", [
    ("binarynet", {"entry_conv": 1, "packed_conv2d": 5,
                   "fused_binary_mlp": 1, "popcount_gemm": 1}),
    ("alexnet", {"pack": 1, "packed_conv2d": 3, "fused_binary_mlp": 1,
                 "popcount_gemm": 1})])
def test_graphed_logits_equal_eager(cuda, workload, per_forward, batch):
    """One CUDA graph per forward: its logits equal eager apply's bit for
    bit, a valid_rows graph equals eager on those rows, and a replay
    counts the kernels its capture recorded (the capture counts none)."""
    from repro_torch.core.workloads import WORKLOADS
    from repro_torch.graph.replay import GraphedApply
    cb = graph.compile(WORKLOADS[workload], batch=batch)
    params = cb.init(torch.Generator().manual_seed(0))
    x = torch.randint(-3, 4, (batch, *cb.spec.input_shape),
                      generator=torch.Generator().manual_seed(batch)
                      ).to(torch.float32).to(cuda)
    eager = cb.apply(params, x)
    _build.reset_launch_counts()
    g = GraphedApply(cb, params, batch)
    warm = _build.launch_counts()                   # the eager warm-up
    assert g.launches == per_forward
    assert all(warm[k] == per_forward.get(k, 0) for k in warm)
    _build.reset_launch_counts()
    for _ in range(2):
        got = g(x)
        assert torch.equal(got, eager)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {
        k: 2 * per_forward.get(k, 0) for k in _build.launch_counts()}
    if batch > 1:
        # rows past the request are zeros, as the server pads them
        n, valid = batch - 2, batch - 1
        part = GraphedApply(cb, params, batch, valid_rows=valid)
        padded = torch.cat([x[:n], torch.zeros_like(x[n:])])
        assert torch.equal(part(x[:n]),
                           cb.apply(params, padded, valid_rows=valid))


def test_capture_holds_the_collector_off(cuda, monkeypatch):
    """A graph that only a reference cycle holds, freed by the cyclic
    collector while another forward is being captured, would invalidate
    that capture (CUDAGraph.reset is refused while capturing); the
    capture holds the collector off, so it succeeds and replays right."""
    import gc

    from repro_torch.graph.replay import GraphedApply
    spec = graph.from_dense_stack(512, [256, 64], name="gc")
    cb = graph.compile(spec, batch=8)
    params = cb.init(torch.Generator().manual_seed(5))
    x = ops.binarize_pack(torch.randn(8, 512, generator=torch.Generator()
                                      .manual_seed(6)).to(cuda))
    doomed = [GraphedApply(cb, params, 8)]
    forward = GraphedApply._forward

    def drop_a_graph_mid_capture(self):
        if doomed and torch.cuda.is_current_stream_capturing():
            cycle = [doomed.pop()]
            cycle.append(cycle)                  # only the collector frees it
            del cycle
        return forward(self)

    monkeypatch.setattr(GraphedApply, "_forward", drop_a_graph_mid_capture)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)                    # collect at every chance
    try:
        g = GraphedApply(cb, params, 8)
    finally:
        gc.set_threshold(*thresholds)
    assert not doomed
    gc.collect()
    assert torch.equal(g(x).words, cb.apply(params, x).words)


def test_launch_error_is_a_backend_fault(cuda):
    """A launch the CUDA runtime refuses (no layers) raises LaunchError,
    which the server classifies as a backend fault."""
    from repro_torch.serving.server import _is_backend_fault, _is_sticky
    with pytest.raises(_build.LaunchError) as info:
        _build.FUSED_MLP.launch(cuda, None, None, 1, 8, 0, None, None,
                                None, None, None, None, 16, 16, 8)
    assert _is_backend_fault(info.value) and not _is_sticky(info.value)


def test_server_results_equal_eager_apply(cuda):
    """BNNServer on the card: every submitted request, and a synchronous
    batch, equals eager apply on its own rows; graphs stay within the
    bound, nothing falls back."""
    from repro_torch.core.workloads import binarynet_cifar10
    from repro_torch.serving import BNNServer
    cb = graph.compile(binarynet_cifar10(), batch=16)
    params = cb.init(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    sizes = [1, 5, 16, 9, 3, 12, 7, 2]
    xs = [torch.randint(-3, 4, (r, 32, 32, 3), generator=gen
                        ).to(torch.float32).to(cuda) for r in sizes]
    srv = BNNServer(cb, params, max_batch=16).start()
    try:
        futs = [srv.submit(x) for x in xs]
        got = [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()
    for x, y in zip(xs, got):
        assert torch.equal(y, cb.apply(params, x))
    big = torch.cat(xs[:4])                          # 31 rows: 16 + 15
    assert torch.equal(srv.apply_batch(big), cb.apply(params, big))
    st = srv.stats()
    assert st["jit_traces"] <= st["trace_bound"]
    assert st["faults"]["backend_fallbacks"] == 0


def test_server_falls_back_on_a_refused_launch(cuda, monkeypatch):
    """The first kernel launch of a flight is refused (LaunchError from
    Kernel.launch): the flight re-executes eagerly on the same card with
    the same kernels (their launch counts move, nothing runs on
    "torch"), giving the same words and one counted fallback."""
    from repro_torch.serving import BNNServer
    spec = graph.from_dense_stack(512, [256, 64], name="fb")
    cb = graph.compile(spec, batch=8)
    params = cb.init(torch.Generator().manual_seed(3))
    x = ops.binarize_pack(torch.randn(6, 512, generator=torch.Generator()
                                      .manual_seed(4)).to(cuda))
    want = cb.apply(params, x)
    srv = BNNServer(cb, params, max_batch=8)
    calls = []
    for k in _build.KERNELS:
        lib, fn = k._bind()

        def refuse_first(*args, fn=fn):
            calls.append(1)
            return 1 if len(calls) == 1 else fn(*args)

        monkeypatch.setattr(k, "_fn", (lib, refuse_first))
    _build.reset_launch_counts()
    fut = srv.submit(x)
    srv.flush()
    got = fut.result(timeout=60)
    assert srv._fallback is cb                      # the same kernels
    assert len(calls) > 1 and sum(_build.launch_counts().values()) > 0
    assert torch.equal(got.words, want.words) and got.words.is_cuda
    st = srv.stats()["faults"]
    assert st["backend_fallbacks"] == 1 and st["retries"] == 0
