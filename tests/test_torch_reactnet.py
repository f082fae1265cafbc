"""ReActNet on the port: residual binary half-steps with learned sign
thresholds (RSign), RPReLU and a float shortcut stream, held against
the plain reference ``repro_torch/reference/reactnet.py`` (the JAX
package has no such model).

On the CPU: the zero-padding correction (``packed_conv2d``'s -1 padded
dot plus the correction is the zero-padded +-1 conv, exactly, at every
border class); each half-step kind and the stem bit for bit against the
reference, float stream and packed signs; a small spec of the same
structure end to end within the check's tolerance; the IR's rules; the
plan's launches, description and byte model; the audit; a CPU server
round trip; and that the reference imports only torch.  The tests
marked ``gpu`` hold the kernels bit for bit against their plain
versions at every ReActNet-A half-step shape, the full-width forward
replayed as a CUDA graph against the reference, and a ``BNNServer``
round trip; they skip, inside the ``cuda`` fixture, on a host without
a CUDA device.  Run them on a GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_reactnet.py
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from repro_torch import graph  # noqa: E402
from repro_torch.analysis.audit import expected_launches  # noqa: E402
from repro_torch.graph import ir  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import residual as kres  # noqa: E402
from repro_torch.kernels.packed import PackedArray  # noqa: E402
from repro_torch.reference import reactnet as reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def table_of(spec):
    """The spec as the reference's layer table."""
    rows = []
    for nd in spec.nodes:
        if isinstance(nd, ir.RealConv):
            rows.append({"op": "real_conv", "name": nd.name, "c_in": nd.c_in,
                         "c_out": nd.c_out, "k": nd.kh, "stride": nd.stride,
                         "pad": nd.pad, "in_hw": nd.h_in,
                         "out_hw": nd.h_out})
        elif isinstance(nd, ir.ResidualBinaryConv):
            rows.append({"op": "conv", "kind": "binary", "name": nd.name,
                         "c_in": nd.c_in, "c_out": nd.c_out, "k": nd.k,
                         "stride": nd.stride, "pad": nd.pad,
                         "in_hw": nd.h_in, "out_hw": nd.h_out,
                         "shortcut": nd.shortcut})
        elif isinstance(nd, ir.GlobalAvgPool):
            rows.append({"op": "avgpool", "name": nd.name})
        elif isinstance(nd, ir.RealDense):
            rows.append({"op": "real_dense", "name": nd.name,
                         "n_in": nd.n_in, "n_out": nd.n_out})
    return rows


def weights_of(raw):
    """The published-form tree as the reference's list of weights."""
    return list(raw["stem"]) + list(raw["res"]) + list(raw["head"])


def _images(n, hw, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, hw, hw, 3), generator=g
                         ).to(torch.float32).to(device)


def _half_step_params(c, f, k, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)

    def u(n, lo, hi):
        return (lo + (hi - lo) * torch.rand(n, generator=g)).to(device)
    w = torch.randn(k, k, c, f, generator=g).to(device)
    alpha = w.abs().mean(dim=(0, 1, 2))
    var = alpha * alpha * k * k * c
    return {"b_in": u(c, -0.2, 0.2), "w": w,
            "mean": u(f, -0.5, 0.5) * var.sqrt(), "var": u(f, 0.5, 2) * var,
            "gamma": u(f, 0.5, 1.5), "beta": u(f, -0.5, 0.5),
            "move_a": u(f, -0.2, 0.2), "slope": u(f, 0.05, 0.35),
            "move_b": u(f, -0.2, 0.2)}


# ------------------------------------------------------------------ #
# the zero-padding correction                                          #
# ------------------------------------------------------------------ #
# (K, stride, C, map sizes H x W): every border class (a map of 1 pads
# both sides), C of one and two words
SIDES = [(h, w) for h in (1, 2, 5) for w in (1, 2, 5)]
CORR_CASES = [(3, 1, 32, SIDES), (3, 1, 64, [(3, 4), (4, 3)]),
              (3, 2, 32, [(4, 5), (5, 4), (1, 2)]), (3, 2, 64, [(6, 2)]),
              (1, 1, 32, [(3, 2)]), (1, 1, 64, [(4, 4)])]


@pytest.mark.parametrize("k,stride,c,sizes", CORR_CASES)
def test_dot_plus_correction_is_the_zero_padded_conv(k, stride, c, sizes):
    g = torch.Generator().manual_seed(k * 100 + stride * 10 + c)
    f = 32
    w = torch.randn(k, k, c, f, generator=g)
    wf = PackedArray.pack(w, axis=2)
    signs = wf.unpack(torch.float32)
    pad = (k - 1) // 2
    corr = kres.zero_pad_correction(signs) if pad else None
    for h, wi in sizes:
        a = torch.where(torch.randn(2, h, wi, c, generator=g) > 0, 1.0,
                        -1.0)
        dot = ops.binary_conv2d(PackedArray.pack(a, axis=-1), wf,
                                stride=stride, padding=pad)
        ho, wo = dot.shape[1], dot.shape[2]
        want = F.conv2d(a.permute(0, 3, 1, 2), signs.permute(3, 2, 0, 1),
                        stride=stride, padding=pad)
        want = torch.round(want).to(torch.int32).permute(0, 2, 3, 1)
        if corr is not None:
            cls = kres.border_classes(ho, wo, h, wi, k, stride, pad)
            dot = dot + corr[cls]
        assert torch.equal(dot, want)


def test_border_classes_cover_all_sixteen():
    seen = set()
    for h, w in SIDES:
        seen |= set(kres.border_classes(h, w, h, w, 3, 1, 1).flatten()
                    .tolist())
    assert seen == set(range(16))


# ------------------------------------------------------------------ #
# half-steps and the stem against the reference                        #
# ------------------------------------------------------------------ #
# (C_in, C_out, K, stride, shortcut, H)
HALF_STEPS = [(32, 32, 3, 1, "identity", 6), (64, 64, 3, 2, "avgpool", 6),
              (32, 64, 1, 1, "duplicate", 5), (64, 64, 1, 1, "identity", 3),
              (64, 128, 1, 1, "duplicate", 2)]


def _port_half_step(x, p, c, f, k, stride, shortcut, h, backend, b_next):
    """The half-step as a compiled plan runs it: ``residual_conv`` on a
    kernel backend, ``residual_conv_plain`` on "torch"."""
    pad = (k - 1) // 2
    wf = PackedArray.pack(p["w"], axis=2)
    a = PackedArray.pack(x + p["b_in"], axis=-1)
    corr = kres.zero_pad_correction(wf.unpack(torch.float32)) if pad \
        else None
    table = kres.epilogue_table(p["w"].abs().mean(dim=(0, 1, 2)), p["mean"],
                                p["var"], p["gamma"], p["beta"],
                                p["move_a"], p["slope"], p["move_b"], b_next)
    conv = kres.residual_conv if backend == "cuda" else \
        kres.residual_conv_plain
    return conv(a, wf, corr, table, x, shortcut=shortcut, stride=stride,
                pad=pad)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("c,f,k,stride,shortcut,h", HALF_STEPS)
def test_half_step_is_the_reference_bit_for_bit(c, f, k, stride, shortcut,
                                               h, backend):
    g = torch.Generator().manual_seed(c + f + k + h)
    x = torch.randn(3, h, h, c, generator=g) * 2.0
    p = _half_step_params(c, f, k, seed=h)
    b_next = torch.rand(f, generator=g) - 0.5
    out, bits = _port_half_step(x, p, c, f, k, stride, shortcut, h, backend,
                                b_next)
    layer = {"name": "step", "stride": stride, "pad": (k - 1) // 2,
             "shortcut": shortcut}
    want = reference._half_step(x, p, layer)
    assert out.dtype == torch.float32 and torch.equal(out, want)
    assert torch.equal(bits, PackedArray.pack(want + b_next, axis=-1).words)


# the fused half-step's plain path against the chain: (C_in, C_out, K,
# stride, shortcut, H) an identity 3x3, an average-pool stride-2 3x3, a
# 1x1 identity and a 1x1 doubling, each with and without the signs
FUSED_STEPS = [(32, 32, 3, 1, "identity", 6), (64, 64, 3, 2, "avgpool", 6),
               (64, 64, 1, 1, "identity", 3), (32, 64, 1, 1, "duplicate", 5)]


def _fused_operands(c, f, k, stride, shortcut, h, n=2, seed=0):
    """Signs, filters, correction, table and shortcut of one half-step."""
    g = torch.Generator().manual_seed(seed + c + f + k + h)
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    p = _half_step_params(c, f, k, seed=h)
    wf = PackedArray.pack(p["w"], axis=2)
    xp = PackedArray.pack(torch.randn(n, h, h, c, generator=g), axis=-1)
    corr = kres.zero_pad_correction(wf.unpack(torch.float32)) if pad \
        else None
    table = kres.epilogue_table(p["w"].abs().mean(dim=(0, 1, 2)), p["mean"],
                                p["var"], p["gamma"], p["beta"],
                                p["move_a"], p["slope"], p["move_b"],
                                torch.rand(f, generator=g) - 0.5)
    side = h if shortcut == "avgpool" else ho
    sc = torch.randn(n, side, side, f // 2 if shortcut == "duplicate" else f,
                     generator=g) * 2.0
    return xp, wf, corr, table, sc, dict(shortcut=shortcut, stride=stride,
                                         pad=pad)


@pytest.mark.parametrize("write_bits", [True, False])
@pytest.mark.parametrize("c,f,k,stride,shortcut,h", FUSED_STEPS)
def test_fused_half_step_plain_is_the_chain(c, f, k, stride, shortcut, h,
                                            write_bits):
    xp, wf, corr, table, sc, kw = _fused_operands(c, f, k, stride,
                                                  shortcut, h)
    got = kres.residual_conv(xp, wf, corr, table, sc, write_bits=write_bits,
                             **kw)
    dot = ops.binary_conv2d(xp, wf, stride=stride, padding=kw["pad"])
    want = kres.residual_epilogue_plain(dot, corr, table, sc, k=k, h_in=h,
                                        w_in=h, write_bits=write_bits, **kw)
    assert got[0].dtype == torch.float32 and torch.equal(got[0], want[0])
    if write_bits:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


# (case, how the operands are spoiled, the refusal's words)
FUSED_BAD = [
    ("shortcut_dtype", lambda a: a.update(sc=a["sc"].double()),
     "shortcut is float32"),
    ("table_dtype", lambda a: a.update(table=a["table"].double()),
     "float32 table"),
    ("corr_dtype", lambda a: a.update(corr=a["corr"].long()),
     "int32 correction"),
    ("width", lambda a: a.update(wf=PackedArray.pack(
        torch.randn(3, 3, 32, 48), axis=2)), "F % 32 == 0"),
    ("filters", lambda a: a.update(wf=PackedArray.pack(
        torch.randn(3, 1, 32, 32), axis=2)), "square filters"),
    ("channels", lambda a: a.update(xp=PackedArray.pack(
        torch.randn(2, 6, 6, 64), axis=-1)), "channel mismatch"),
    ("shortcut_shape", lambda a: a.update(sc=a["sc"][:, :5]),
     "shortcut is float32"),
    ("shortcut_name", lambda a: a.update(shortcut="concat"),
     "shortcut must be one of"),
    ("table_shape", lambda a: a.update(table=a["table"][:8]),
     r"table must be \[9, 32\]"),
    ("no_correction", lambda a: a.update(corr=None), "takes corr"),
    ("not_packed", lambda a: a.update(xp=a["xp"].words), "PackedArray")]


@pytest.mark.parametrize("case,spoil,message", FUSED_BAD,
                         ids=[b[0] for b in FUSED_BAD])
def test_fused_half_step_refuses_what_the_kernel_does_not_take(case, spoil,
                                                              message):
    xp, wf, corr, table, sc, kw = _fused_operands(32, 32, 3, 1, "identity",
                                                  6)
    a = dict(xp=xp, wf=wf, corr=corr, table=table, sc=sc, **kw)
    spoil(a)
    with pytest.raises(ValueError, match=message):
        kres.residual_conv(a.pop("xp"), a.pop("wf"), a.pop("corr"),
                           a.pop("table"), a.pop("sc"), **a)


def test_stem_is_the_reference_bit_for_bit():
    g = torch.Generator().manual_seed(5)
    x = _images(2, 9, seed=5)
    w = torch.randn(3, 3, 3, 32, generator=g)
    bn = {"mean": torch.randn(32, generator=g) * 50,
          "var": torch.rand(32, generator=g) * 1e4 + 1e3,
          "gamma": torch.rand(32, generator=g) + 0.5,
          "beta": torch.rand(32, generator=g) - 0.5}
    b_next = torch.rand(32, generator=g) - 0.5
    table = kres.stem_table(bn["mean"], bn["var"], bn["gamma"], bn["beta"],
                            b_next)
    out, bits = kres.stem_conv(x, w, table, stride=2, pad=1)
    layer = {"k": 3, "stride": 2, "pad": 1, "out_hw": 5}
    want = reference._stem(x, {"w": w, **bn}, layer, "exact")
    assert torch.equal(out, want)
    assert torch.equal(bits, PackedArray.pack(want + b_next, axis=-1).words)


# the stem kernel's tiles (csrc/stem_conv.cu), written out in torch:
# (N, H, W, F, stride, pad): ReActNet's stem at 16 and 224 rows, several
# passes a tile, an odd width, an output height the tile does not divide,
# a slab of 64 and of 128 channels and three of 32 (F = 96), stride 1 to
# 3, pad 0 to 2, three tiles across a row
STEM_TILE_CASES = [(2, 16, 16, 32, 2, 1), (1, 224, 224, 32, 2, 1),
                   (3, 48, 48, 32, 2, 1), (2, 45, 37, 32, 2, 1),
                   (2, 17, 17, 96, 2, 0), (2, 19, 19, 64, 1, 1),
                   (1, 23, 21, 128, 1, 0), (2, 25, 26, 32, 3, 2),
                   (1, 12, 300, 32, 1, 1)]


def _stem_tiles_emulated(x, w, table, stride, pad, p):
    """What the stem kernel computes on the plan ``p``, tile by tile: the
    tile's input rows staged as [row][kw][pos][c] (zero outside the
    image), each pass's pixel groups reading their taps as 12 floats at
    ``ry * stride * 9 * cols + 12 * gx`` plus ``(kh * 3 + kw) * 3 *
    cols``, the 16 sums in the order (kh, kw, c), the batch norm, the
    words from 4-bit nibbles.  Returns the map, the words and how often
    each output pixel was written."""
    n, h, wi, _ = x.shape
    f = w.shape[-1]
    rows, cols, ho, wo = p["rows"], p["cols"], p["ho"], p["wo"]
    pix = kres.STEM_PIX
    gcols = cols // pix
    groups = kres.STEM_THREADS * kres.STEM_CH // p["slab"]
    prow = (rows - 1) * stride + 3
    tiles_y, tiles_x = -(-ho // rows), -(-wo // cols)
    assert p["tiles"] == n * tiles_y * tiles_x
    out = torch.full((n, ho, wo, f), float("nan"))
    words = torch.zeros(n, ho, wo, f // 32, dtype=torch.int64)
    hits = torch.zeros(n, ho, wo, dtype=torch.int64)
    wr = w.reshape(27, f)
    mean, inv, gamma, beta, b_next = table
    pg = torch.arange(p["passes"] * groups)
    live = pg < rows * gcols
    pgc = torch.where(live, pg, 0)          # a spare thread sums group 0
    ry, gx = pgc // gcols, pgc % gcols
    base = ry * stride * 9 * cols + 3 * pix * gx
    place = torch.tensor([1 << b for b in range(32)], dtype=torch.int64)
    for tl in range(p["tiles"]):
        img, rem = divmod(tl, tiles_y * tiles_x)
        ty, tx = divmod(rem, tiles_x)
        oy0, ox0 = ty * rows, tx * cols
        iy = oy0 * stride - pad + torch.arange(prow)
        ix = ((ox0 + torch.arange(cols)) * stride - pad
              + torch.arange(3)[:, None])                   # [kw, pos]
        ok = ((iy >= 0) & (iy < h))[:, None, None] & \
            ((ix >= 0) & (ix < wi))[None]
        patch = x[img][iy.clamp(0, h - 1)[:, None, None],
                       ix.clamp(0, wi - 1)[None]]          # [r, kw, pos, c]
        flat = torch.where(ok[..., None], patch, 0.0).reshape(-1)
        acc = torch.zeros(len(pg), pix, f)
        for kk in range(9):
            kh, kw = divmod(kk, 3)
            xv = flat[base[:, None] + (kh * 3 + kw) * 3 * cols
                      + torch.arange(3 * pix)]
            for c in range(3):
                for j in range(pix):
                    acc[:, j] = acc[:, j] + xv[:, 3 * j + c, None] * \
                        wr[3 * kk + c]
        v = (acc - mean) * inv
        v = v * gamma + beta
        bit = ((v + b_next) > 0).to(torch.int64).reshape(len(pg), pix,
                                                         f // 32, 32)
        oy = oy0 + ry
        ox = ox0 + pix * gx[:, None] + torch.arange(pix)
        keep = live[:, None] & (oy < ho)[:, None] & (ox < wo)
        gi, ji = keep.nonzero(as_tuple=True)
        at = (torch.full_like(gi, img), oy[gi], ox[gi, ji])
        out[at] = v[gi, ji]
        words[at] = (bit[gi, ji] * place).sum(dim=-1)
        hits.index_put_(at, torch.ones(len(gi), dtype=torch.int64),
                        accumulate=True)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return out, words.to(torch.int32), hits


def _stem_operands(n, h, w, f, seed, device="cpu"):
    """Integer pixels, normal weights and a batch norm that centres the
    sums, as the card tests draw them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (n, h, w, 3), generator=g).to(torch.float32)
    wt = torch.randn(3, 3, 3, f, generator=g)
    table = kres.stem_table(torch.randn(f, generator=g) * 100,
                            torch.rand(f, generator=g) * 1e5 + 1e4,
                            torch.rand(f, generator=g) + 0.5,
                            torch.rand(f, generator=g) - 0.5,
                            torch.rand(f, generator=g) - 0.5)
    return x.to(device), wt.to(device), table.to(device)


@pytest.mark.parametrize("n,h,w,f,stride,pad", STEM_TILE_CASES)
@pytest.mark.parametrize("sms", [132, 1])
def test_stem_kernel_tiles_are_the_plain_version(n, h, w, f, stride, pad,
                                                 sms):
    """The kernel's staging layout, tap addresses and pass mapping on
    :func:`kres.stem_plan`'s tiles give ``stem_conv_plain``'s map and
    words bit for bit, each output pixel written once (one SM: tall
    tiles of several passes, the last with spare threads)."""
    x, wt, table = _stem_operands(n, h, w, f, seed=h + w + f)
    p = kres.stem_plan(n, h, w, f, stride, pad, sms)
    got, words, hits = _stem_tiles_emulated(x, wt, table, stride, pad, p)
    want = kres.stem_conv_plain(x, wt, table, stride=stride, pad=pad)
    assert bool((hits == 1).all())
    assert torch.equal(got.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(words, want[1])


@pytest.mark.parametrize("n,h,w,f,stride,pad", STEM_TILE_CASES + [
    (256, 224, 224, 32, 2, 1), (7, 224, 224, 32, 2, 1),
    (300, 9, 9, 32, 1, 1), (1, 40, 1001, 256, 1, 1),
    (2, 64, 64, 160, 2, 1), (1, 9, 9, 32, 5, 4), (4, 3, 3, 32, 1, 0)])
@pytest.mark.parametrize("sms", [132, 1])
def test_stem_plan_fits_and_covers_every_pixel_once(n, h, w, f, stride, pad,
                                                    sms):
    """The plan's tiles: at most STEM_COLS columns, a multiple of
    STEM_PIX; at most STEM_PASSES passes; two staged tiles within a
    block's share of the SM (at most the 227 KB a block may have); the
    tiles of every image and the live pixel groups of their passes cover
    each output pixel exactly once."""
    p = kres.stem_plan(n, h, w, f, stride, pad, sms)
    ho = (h + 2 * pad - 3) // stride + 1
    wo = (w + 2 * pad - 3) // stride + 1
    assert (p["ho"], p["wo"]) == (ho, wo)
    assert f % p["slab"] == 0 and p["slab"] in (32, 64, 128)
    assert p["cols"] % kres.STEM_PIX == 0 and p["cols"] <= kres.STEM_COLS
    assert 1 <= p["passes"] <= kres.STEM_PASSES
    assert p["smem"] == kres.stem_smem(p["rows"], p["cols"], stride)
    # two blocks an SM: within half an SM's 228 KB, 1 KB reserved a block
    assert p["smem"] <= 233472 // kres.STEM_BLOCKS - 1024 <= 232448
    rows, cols = p["rows"], p["cols"]
    gcols = cols // kres.STEM_PIX
    groups = kres.STEM_THREADS * kres.STEM_CH // p["slab"]
    assert p["passes"] == -(-rows * gcols // groups)
    tiles_y, tiles_x = -(-ho // rows), -(-wo // cols)
    assert p["tiles"] == n * tiles_y * tiles_x
    # one image's tiles (every image's are the same)
    pg = torch.arange(p["passes"] * groups)
    pg = pg[pg < rows * gcols]
    ty, tx = torch.arange(tiles_y), torch.arange(tiles_x)
    oy = ty[:, None, None, None] * rows + (pg // gcols)[None, None, :, None]
    ox = tx[None, :, None, None] * cols + \
        (kres.STEM_PIX * (pg % gcols))[None, None, :, None] + \
        torch.arange(kres.STEM_PIX)
    oy, ox = torch.broadcast_tensors(oy, ox)
    keep = (oy < ho) & (ox < wo)
    hits = torch.bincount((oy[keep] * wo + ox[keep]).reshape(-1),
                          minlength=ho * wo)
    assert bool((hits == 1).all())


STEM_BAD = [
    ("x 3-d", lambda a: a.update(x=a["x"][0]), "takes x"),
    ("channels differ", lambda a: a.update(x=a["x"][..., :2]), "takes x"),
    ("5x5 taps", lambda a: a.update(w=torch.zeros(5, 5, 3, 32)),
     "takes w"),
    ("4 channels", lambda a: a.update(
        x=torch.zeros(1, 8, 8, 4), w=torch.zeros(3, 3, 4, 32)), "takes w"),
    ("F = 48", lambda a: a.update(w=torch.zeros(3, 3, 3, 48),
                                  table=torch.zeros(5, 48)), "takes w"),
    ("table [4, F]", lambda a: a.update(table=a["table"][:4]), "takes w"),
]


@pytest.mark.parametrize("case,spoil,message", STEM_BAD,
                         ids=[b[0] for b in STEM_BAD])
def test_stem_conv_refuses_what_the_kernel_does_not_take(case, spoil,
                                                         message):
    x, wt, table = _stem_operands(1, 8, 8, 32, seed=3)
    a = dict(x=x, w=wt, table=table)
    spoil(a)
    with pytest.raises(ValueError, match=message):
        kres.stem_conv(a["x"], a["w"], a["table"], stride=2, pad=1)


# ------------------------------------------------------------------ #
# the small spec end to end                                            #
# ------------------------------------------------------------------ #
def _gap(got, want):
    """Each image's widest logit gap over its largest reference logit."""
    return ((got - want).abs().amax(dim=1) /
            want.abs().amax(dim=1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_spec_within_tolerance_of_the_reference(seed):
    spec = ir.reactnet_small()
    cb = graph.compile(spec, device="cpu", batch=4)
    raw = cb.draw_residual(torch.Generator().manual_seed(seed))
    params = cb.bind(raw)
    x = _images(4, 16, seed=seed + 10)
    got = cb.apply(params, x)
    assert torch.equal(got, cb.with_backend("torch").apply(params, x))
    want = reference.logits(table_of(spec), weights_of(raw), x)
    assert got.shape == want.shape == (4, 10)
    assert float(_gap(got, want).max()) <= reference.LOGIT_REL_TOL
    # the stream before the head is the reference's, bit for bit
    head, _ = cb.split("avgpool")
    stream = head.apply(params, x)
    ref = x
    for row, w in zip(table_of(spec)[:-2], weights_of(raw)):
        ref = reference._stem(ref, w, row, "exact") \
            if row["op"] == "real_conv" else reference._half_step(ref, w, row)
    assert torch.equal(stream, ref)


def test_valid_rows_keep_the_first_rows():
    spec = ir.reactnet_small()
    cb = graph.compile(spec, device="cpu", batch=4)
    params = cb.init(torch.Generator().manual_seed(3))
    x = _images(4, 16, seed=4)
    assert torch.equal(cb.apply(params, x, valid_rows=3),
                       cb.apply(params, x)[:3])


# ------------------------------------------------------------------ #
# the IR's rules                                                       #
# ------------------------------------------------------------------ #
def _chain(*steps, hw=8):
    stem = ir.RealConv("stem", 3, 3, 3, 32, 2 * hw, 2 * hw, hw, hw, 2, 1)
    tail = [ir.GlobalAvgPool("pool"), ir.RealDense("fc", steps[-1].c_out, 10),
            ir.Logits("logits", 10)]
    return ir.BNNSpec("t", (2 * hw, 2 * hw, 3), (stem, *steps, *tail))


BAD = [
    ("3x3 over 3 channels", lambda: ir.BNNSpec("t", (16, 16, 3), (
        ir.RealConv("stem", 5, 5, 3, 32, 16, 16, 8, 8, 2, 2),
        ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10),
        ir.Logits("l", 10)))),
    ("expects", lambda: _chain(ir.ResidualBinaryConv(
        "s", 3, 64, 64, 8, 8, 8, 8, 1, 1, "identity"))),          # width
    ("keeps its width or doubles", lambda: _chain(ir.ResidualBinaryConv(
        "s", 1, 32, 96, 8, 8, 8, 8, 1, 0, "duplicate"))),         # 3C
    ("odd map", lambda: _chain(ir.ResidualBinaryConv(
        "s", 3, 32, 32, 7, 7, 4, 4, 2, 1, "avgpool"), hw=7)),     # odd
    ("takes the 'avgpool' shortcut", lambda: _chain(ir.ResidualBinaryConv(
        "s", 3, 32, 32, 8, 8, 4, 4, 2, 1, "identity"))),
    ("pad 1", lambda: _chain(ir.ResidualBinaryConv(
        "s", 3, 32, 32, 8, 8, 6, 6, 1, 0, "identity"))),
    ("writes its sign bits", lambda: ir.BNNSpec("t", (8, 8, 32), (
        ir.ResidualBinaryConv("s", 3, 32, 32, 8, 8, 8, 8, 1, 1, "identity"),
        ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10),
        ir.Logits("l", 10)))),
    ("followed by Logits", lambda: ir.BNNSpec("t", (16, 16, 3), (
        ir.RealConv("stem", 3, 3, 3, 32, 16, 16, 8, 8, 2, 1),
        ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10)))),
]


@pytest.mark.parametrize("message,build", BAD, ids=[b[0] for b in BAD])
def test_validate_rejects_a_malformed_chain(message, build):
    with pytest.raises(ValueError, match=message):
        build().validate()


def test_reactnet_a_is_the_published_network():
    spec = ir.reactnet_a()
    res = spec.residual_nodes
    assert len(res) == 26 and spec.input_shape == (224, 224, 3)
    assert [nd.c_out for nd in res[1::2]] == list(ir.REACTNET_A_WIDTHS[1:])
    assert [i + 1 for i, nd in enumerate(res[0::2]) if nd.stride == 2] == \
        [2, 4, 6, 12]
    assert res[-1].h_out == 7 and spec.head_nodes[0].n_out == 1000
    shortcuts = {nd.shortcut for nd in res}
    assert shortcuts == {"identity", "avgpool", "duplicate"}
    # 4.82e9 BOPs, as published: 3x3 convs 4.277 G, 1x1 convs 0.54 G
    b3 = sum(nd.k ** 2 * nd.c_in * nd.c_out * nd.h_out ** 2 for nd in res
             if nd.k == 3)
    b1 = sum(nd.c_in * nd.c_out * nd.h_out ** 2 for nd in res if nd.k == 1)
    assert round(b3 / 1e9, 3) == 4.277 and round(b1 / 1e9, 2) == 0.54
    assert round((b3 + b1) / 1e9, 2) == 4.82


# ------------------------------------------------------------------ #
# plan, launches, description, byte model, audit, mapping              #
# ------------------------------------------------------------------ #
def test_plan_launches_and_description():
    cb = graph.compile(ir.reactnet_a(), device="cpu", batch=256)
    kinds = [s.kind for s in cb.plan]
    assert kinds.count("residual_conv") == 26
    assert kinds[0] == "real_conv" and kinds[-3:] == ["global_pool",
                                                      "real_dense", "logits"]
    # one fused launch a half-step; the layer-by-layer chain has two
    assert cb.launch_count() == 27 and cb.legacy_launch_count() == 53
    assert expected_launches(cb, 256) == {"stem_conv": 1,
                                          "residual_conv": 26}
    text = cb.describe()
    assert "residual_conv" in text and "stem_conv" in text
    assert "packed_conv_kernel_residual_epilogue" in text
    sign_next = [s.args["sign_next"] for s in cb.plan
                 if s.kind in ("real_conv", "residual_conv")]
    assert sign_next == [True] * 26 + [False]
    t = cb.traffic(1)
    assert [ly["name"] for ly in t["layers"]] == \
        [s.name for s in cb.plan if s.kind in ("real_conv", "residual_conv",
                                               "real_dense")]
    # the half-steps take their tile rule alone: no tuning key
    assert len(cb.tuning_keys) == 0
    # the fused kernel's tiles: no 128-row tile, none wider than F
    tiles = [s.detail.split("tile ")[1].split(")")[0] for s in cb.plan
             if s.kind == "residual_conv"]
    widths = [nd.c_out for nd in cb.spec.residual_nodes]
    assert tiles == ["64x64" if f <= 64 else "64x128" for f in widths]
    assert cb.tuning_keys_for_batch(32) == graph.compile(
        ir.reactnet_a(), device="cpu", batch=32).tuning_keys


def test_fused_plan_reads_no_packed_conv_tuning_entry(monkeypatch):
    """A ``packed_conv`` tuning-table entry at a half-step's geometry
    (timed on the kernel that writes the int32 dot) changes that conv's
    own tile plan and none of the half-step's plan."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import packed_conv as kconv
    monkeypatch.delenv(autotune.ENV_TABLE, raising=False)
    monkeypatch.setattr(autotune, "_TABLE", autotune.TuningTable())
    cb = graph.compile(ir.reactnet_a(), device="cpu", batch=256)
    keys = [ops.plan_conv_launch(nd.h_in, nd.w_in, nd.c_in, nd.c_out, nd.k,
                                 nd.k, stride=nd.stride, padding=nd.pad,
                                 pack_out=False, nb=256)["key"]
            for nd in cb.spec.residual_nodes]
    rule = [kres.residual_tile_plan(*k[2:]) for k in keys]
    for k in keys:
        autotune.get_table().put(k, {"bm": 128, "bn": 128})
    assert all(kconv.tile_plan(*k[2:])["bm"] == 128 for k in keys)
    assert [kres.residual_tile_plan(*k[2:]) for k in keys] == rule
    again = graph.compile(ir.reactnet_a(), device="cpu", batch=256)
    assert [s.detail for s in again.plan] == [s.detail for s in cb.plan]
    assert [s.args for s in again.plan] == [s.args for s in cb.plan]


def test_audit_passes_on_the_small_spec():
    cb = graph.compile(ir.reactnet_small(), device="cpu", batch=2)
    report = cb.audit(batch=2, max_batch=8)
    assert report.ok


def test_tulip_mapping_refuses_the_residual_family():
    cb = graph.compile(ir.reactnet_small(), device="cpu")
    with pytest.raises(ValueError, match="outside the TULIP mapping"):
        cb.tulip_mapping()


def test_cpu_server_round_trip():
    from repro_torch.serving import BNNServer

    cb = graph.compile(ir.reactnet_small(), device="cpu", batch=8)
    params = cb.init(torch.Generator().manual_seed(7))
    x = _images(5, 16, seed=8)
    srv = BNNServer(cb, params, max_batch=8, device="cpu")
    srv.start()
    try:
        got = srv.submit(x).result(timeout=60)
    finally:
        srv.stop()
    assert torch.equal(got, cb.apply(params, x))


def test_reference_imports_only_torch():
    path = ROOT / "src" / "repro_torch" / "reference" / "reactnet.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "typing", "torch"}
    assert "torch" in names


# ------------------------------------------------------------------ #
# on the card                                                          #
# ------------------------------------------------------------------ #
def _reactnet_a_steps():
    spec = ir.reactnet_a()
    return [(nd.c_in, nd.c_out, nd.k, nd.stride, nd.shortcut, nd.h_in)
            for nd in spec.residual_nodes]


def _distinct_half_steps():
    """ReActNet-A's half-steps by (C_in, C_out, K, stride, shortcut, H,
    whether the next RSign's words are written), once each."""
    spec = ir.reactnet_a()
    res = spec.residual_nodes
    return sorted({(nd.c_in, nd.c_out, nd.k, nd.stride, nd.shortcut,
                    nd.h_in, i + 1 < len(res)) for i, nd in enumerate(res)})


def _fused_on_card(cuda, c, f, k, stride, shortcut, h, n, seed):
    """A half-step's operands on the card, drawn there."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    p = _half_step_params(c, f, k, seed=h, device=cuda)
    wf = PackedArray.pack(p["w"], axis=2)
    xp = PackedArray.pack(torch.randn(n, h, h, c, generator=g, device=cuda),
                          axis=-1)
    corr = kres.zero_pad_correction(wf.unpack(torch.float32)) if pad \
        else None
    table = kres.epilogue_table(p["w"].abs().mean(dim=(0, 1, 2)), p["mean"],
                                p["var"], p["gamma"], p["beta"],
                                p["move_a"], p["slope"], p["move_b"],
                                torch.rand(f, generator=g, device=cuda) - 0.5)
    side = h if shortcut == "avgpool" else ho
    sc = torch.randn(n, side, side, f // 2 if shortcut == "duplicate" else f,
                     generator=g, device=cuda) * 2.0
    return xp, wf, corr, table, sc, dict(shortcut=shortcut, stride=stride,
                                         pad=pad)


def _same_bits(got, want):
    """Float streams by their bit patterns, and the sign words."""
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        assert torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 7, 256])
@pytest.mark.parametrize("c,f,k,stride,shortcut,h,write_bits",
                         _distinct_half_steps())
def test_fused_half_step_kernel_is_its_plain_version(cuda, c, f, k, stride,
                                                    shortcut, h, write_bits,
                                                    rows):
    """The fused kernel (through its tile plan) against its plain
    version, ``residual_conv_plain`` on the card, bit for bit, at every
    ReActNet-A half-step."""
    xp, wf, corr, table, sc, kw = _fused_on_card(cuda, c, f, k, stride,
                                                 shortcut, h, rows,
                                                 seed=c + f + h + rows)
    want = kres.residual_conv_plain(xp, wf, corr, table, sc,
                                    write_bits=write_bits, **kw)
    _build.reset_launch_counts()
    got = kres.residual_conv(xp, wf, corr, table, sc, write_bits=write_bits,
                             **kw)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts["residual_conv"] == 1 and counts["packed_conv2d"] == 0
    _same_bits(got, want)


# every tile forced: a partial pixel tile, F of one, two and four words
# of a 128-column tile, C of one word, each shortcut
TILE_STEPS = [(32, 32, 3, 1, "identity", 9, 3), (32, 64, 1, 1, "duplicate",
                                                 9, 2),
              (64, 64, 3, 2, "avgpool", 10, 3), (128, 256, 1, 1,
                                                 "duplicate", 7, 5),
              (256, 256, 3, 1, "identity", 7, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("c,f,k,stride,shortcut,h,rows", TILE_STEPS)
def test_fused_half_step_kernel_every_tile(cuda, c, f, k, stride, shortcut,
                                           h, rows):
    from repro_torch.kernels import packed_conv as kconv
    xp, wf, corr, table, sc, kw = _fused_on_card(cuda, c, f, k, stride,
                                                 shortcut, h, rows, seed=5)
    want = kres.residual_conv_plain(xp, wf, corr, table, sc, **kw)
    xw, ww, geo = kres._conv_operands(xp, wf, kw["stride"], kw["pad"])
    for tile in kconv.TILES:
        _same_bits(kres._launch_residual_conv(xw, ww, corr, table, sc, tile,
                                              geo, **kw), want)


# (N, H, W, F, stride, pad, write the words): ReActNet's stem at 3, 1
# and 7 rows; an output height no tile divides and an odd width; F of
# 64, 96, 128 at stride 1 and 2, pad 0 and 1; stride 3 with pad 2; three
# tiles across a row; 300 images of one tile each, so that a block
# walks tiles across images; the map alone
STEM_CARD_CASES = [
    (3, 224, 224, 32, 2, 1, True), (3, 17, 17, 96, 2, 0, True),
    (3, 19, 19, 64, 1, 1, True), (1, 224, 224, 32, 2, 1, True),
    (7, 224, 224, 32, 2, 1, True), (2, 45, 37, 32, 2, 1, True),
    (2, 30, 29, 64, 1, 0, True), (2, 31, 33, 64, 2, 1, True),
    (2, 23, 23, 96, 1, 1, True), (2, 21, 19, 128, 2, 1, True),
    (2, 20, 20, 128, 1, 0, True), (2, 25, 26, 32, 3, 2, True),
    (1, 40, 300, 32, 1, 1, True), (300, 9, 9, 32, 1, 1, True),
    (2, 45, 37, 32, 2, 1, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,f,stride,pad,write_bits", STEM_CARD_CASES)
def test_stem_kernel_bit_for_bit(cuda, n, h, w, f, stride, pad, write_bits):
    """ReActNet's stem, and other batches, sizes, widths, strides and
    pads: the map by its bit patterns and the words, one launch."""
    x, wt, table = _stem_operands(n, h, w, f, seed=11)
    args = dict(stride=stride, pad=pad, write_bits=write_bits)
    want = kres.stem_conv_plain(x, wt, table, **args)
    _build.reset_launch_counts()
    got = kres.stem_conv(x.to(cuda), wt.to(cuda), table.to(cuda), **args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["stem_conv"] == 1
    _same_bits(tuple(t if t is None else t.cpu() for t in got), want)


@pytest.mark.gpu
def test_full_width_graphed_forward_against_the_reference(cuda):
    spec = ir.reactnet_a()
    cb = graph.compile(spec, batch=8)
    raw = cb.draw_residual(torch.Generator().manual_seed(0))
    params = cb.bind(raw)
    x = _images(6, 224, seed=1, device=cuda)
    g = graph.GraphedApply(cb, params, batch=8, valid_rows=6)
    _build.reset_launch_counts()
    got = g(x)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    # one fused kernel a half-step: no dot for a separate epilogue
    assert counts["residual_conv"] == 26 and counts["stem_conv"] == 1
    assert counts["packed_conv2d"] == 0
    want = reference.logits(table_of(spec), weights_of(raw), x)
    assert float(_gap(got, want).max()) <= reference.LOGIT_REL_TOL
    # the float stream is the eager forward's bit for bit; the head's sums
    # may take another order at another batch
    head, _ = cb.split("avgpool")
    assert torch.equal(graph.GraphedApply(head, params, batch=8,
                                          valid_rows=6)(x),
                       head.apply(params, x))


@pytest.mark.gpu
def test_audit_on_the_card(cuda):
    """One eager forward launches exactly the plan's kernels (1 stem and
    a fused residual_conv a half-step), no half-step's int32 dot exists
    on the card, and the plan's shared memory re-derives."""
    cb = graph.compile(ir.reactnet_small(), batch=4)
    report = cb.audit(batch=4, max_batch=8)
    launches = next(c for c in report.checks if c.name == "launches")
    assert report.ok and not launches.skipped
    assert report.launches == {"stem_conv": 1, "residual_conv": 6}
    nd = cb.spec.residual_nodes[0]
    assert (4, nd.h_out, nd.w_out, nd.c_out) in report.banned_shapes


@pytest.mark.gpu
def test_server_round_trip_on_the_card(cuda):
    from repro_torch.serving import BNNServer

    cb = graph.compile(ir.reactnet_a(), batch=8)
    params = cb.init(torch.Generator().manual_seed(2))
    x = _images(5, 224, seed=3, device=cuda)
    srv = BNNServer(cb, params, max_batch=8, prewarm=True)
    srv.start()
    try:
        got = srv.submit(x).result(timeout=300)
    finally:
        srv.stop()
    want = cb.apply(params, x)
    assert float(_gap(got, want).max()) <= reference.LOGIT_REL_TOL


def test_every_half_step_shape_is_covered_on_the_card():
    """The card's kernel test runs each distinct ReActNet-A half-step
    shape: C = 32 (one word), 1x1 and 3x3, stride 2, F = 2C."""
    shapes = set(_reactnet_a_steps())
    assert any(c == 32 for c, *_ in shapes)
    assert {(k, s) for _, _, k, s, _, _ in shapes} == {(3, 1), (3, 2),
                                                       (1, 1)}
    assert any(f == 2 * c for c, f, *_ in shapes)
