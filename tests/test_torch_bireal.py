"""Bi-Real Net on the port: a 7x7 float stem with its max pool, residual
binary half-steps without learned activations (ReActNet's fused
half-step with neutral parameters) and float 1x1 projection shortcuts,
held against the plain reference ``repro_torch/reference/bireal.py``
(the JAX package has no such model).

On the CPU: a small spec end to end within the check's tolerance, the
float stream bit for bit; the IR's rules for the stem's pool and the
projection shortcut; the pooled stem and the projection against the
reference's loops; a neutral-parameter half-step against a Bi-Real
half-step written out; the pooled stem kernel's bands, staging and tap
addresses emulated in torch against its plain version; the plan's
launches; and that the TULIP mapping, the simulator and training refuse
the residual nodes.  The tests marked ``gpu`` hold the pooled stem and
the projection kernels bit for bit against their plain versions at the
published widths and at edge shapes, and count a full-width forward's
launches; they skip, inside the ``cuda`` fixture, on a host without a
CUDA device.  Run them on a GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_bireal.py
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

from repro_torch import graph  # noqa: E402
from repro_torch.analysis.audit import expected_launches  # noqa: E402
from repro_torch.graph import ir  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import residual as kres  # noqa: E402
from repro_torch.kernels.packed import PackedArray  # noqa: E402
from repro_torch.reference import bireal as reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def table_of(spec):
    """The spec as the reference's layer table (the stem's pool a row of
    its own)."""
    rows = []
    for nd in spec.nodes:
        if isinstance(nd, ir.RealConv):
            conv = nd.conv_hw()[0]
            rows.append({"op": "real_conv", "name": nd.name, "c_in": nd.c_in,
                         "c_out": nd.c_out, "k": nd.kh, "stride": nd.stride,
                         "pad": nd.pad, "in_hw": nd.h_in, "out_hw": conv})
            if nd.pool:
                window, stride, pad = ir.STEM_POOL
                rows.append({"op": "maxpool", "name": "maxpool",
                             "window": window, "stride": stride, "pad": pad,
                             "in_hw": conv, "out_hw": nd.h_out})
        elif isinstance(nd, ir.ResidualBinaryConv):
            rows.append({"op": "conv", "kind": "binary", "name": nd.name,
                         "c_in": nd.c_in, "c_out": nd.c_out, "k": nd.k,
                         "stride": nd.stride, "pad": nd.pad,
                         "in_hw": nd.h_in, "out_hw": nd.h_out,
                         "shortcut": nd.shortcut, "rprelu": nd.rprelu})
        elif isinstance(nd, ir.GlobalAvgPool):
            rows.append({"op": "avgpool", "name": nd.name})
        elif isinstance(nd, ir.RealDense):
            rows.append({"op": "real_dense", "name": nd.name,
                         "n_in": nd.n_in, "n_out": nd.n_out})
    return rows


def weights_of(raw):
    """The published-form tree as the reference's list of weights."""
    return list(raw["stem"]) + list(raw["res"]) + list(raw["head"])


def _images(n, hw, seed, device="cpu", w=None):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, hw, w or hw, 3), generator=g
                         ).to(torch.float32).to(device)


def _gap(got, want):
    """Each image's widest logit gap over its largest reference logit."""
    return ((got - want).abs().amax(dim=1) / want.abs().amax(dim=1))


def _stem_operands(n, h, w, f, seed, device="cpu"):
    """Integer pixels, normal 7x7 weights and a batch norm that centres
    the sums."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (n, h, w, 3), generator=g).to(torch.float32)
    wt = torch.randn(7, 7, 3, f, generator=g)
    table = kres.stem_table(torch.randn(f, generator=g) * 300,
                            torch.rand(f, generator=g) * 1e6 + 1e5,
                            torch.rand(f, generator=g) + 0.5,
                            torch.rand(f, generator=g) - 0.5,
                            torch.rand(f, generator=g) - 0.5)
    return x.to(device), wt.to(device), table.to(device)


def _proj_operands(n, h, c, f, seed, device="cpu"):
    """A float stream and a projection's weights and table."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, h, c, generator=g) * 3.0
    w = torch.randn(c, f, generator=g)
    var = (w * w).sum(dim=0) * 9.0
    table = kres.shortcut_table(torch.randn(f, generator=g),
                                var * (0.5 + torch.rand(f, generator=g)),
                                torch.rand(f, generator=g) + 0.5,
                                torch.rand(f, generator=g) - 0.5)
    return x.to(device), w.to(device), table.to(device)


def _bn_params(f, var, g):
    return {"mean": (torch.rand(f, generator=g) - 0.5) * var.sqrt(),
            "var": (0.5 + 1.5 * torch.rand(f, generator=g)) * var,
            "gamma": torch.rand(f, generator=g) + 0.5,
            "beta": torch.rand(f, generator=g) - 0.5}


POOL = (3, 2, 1)


# ------------------------------------------------------------------ #
# the small spec end to end                                            #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_spec_within_tolerance_of_the_reference(seed):
    spec = ir.bireal_small()
    cb = graph.compile(spec, device="cpu", batch=4)
    raw = cb.draw_residual(torch.Generator().manual_seed(seed))
    params = cb.bind(raw)
    x = _images(4, 32, seed=seed + 10)
    got = cb.apply(params, x)
    assert torch.equal(got, cb.with_backend("torch").apply(params, x))
    table = table_of(spec)
    want = reference.logits(table, weights_of(raw), x)
    assert got.shape == want.shape == (4, 10)
    assert float(_gap(got, want).max()) <= reference.LOGIT_REL_TOL
    # the stream before the head is the reference's, bit for bit
    head, _ = cb.split("avgpool")
    stream = head.apply(params, x)
    ref = x
    weights = iter(weights_of(raw))
    for row in table[:-2]:
        if row["op"] == "maxpool":
            ref = reference._maxpool(ref, row)
        elif row["op"] == "real_conv":
            ref = reference._stem(ref, next(weights), row, "exact")
        else:
            ref = reference._half_step(ref, next(weights), row)
    assert torch.equal(stream, ref)


def test_valid_rows_keep_the_first_rows():
    cb = graph.compile(ir.bireal_small(), device="cpu", batch=4)
    params = cb.init(torch.Generator().manual_seed(3))
    x = _images(4, 32, seed=4)
    assert torch.equal(cb.apply(params, x, valid_rows=3),
                       cb.apply(params, x)[:3])


# ------------------------------------------------------------------ #
# the IR's rules                                                       #
# ------------------------------------------------------------------ #
def _chain(*steps, hw=8):
    stem = ir.RealConv("stem", 7, 7, 3, 32, 4 * hw, 4 * hw, hw, hw, 2, 3,
                       pool=True)
    tail = [ir.GlobalAvgPool("pool"), ir.RealDense("fc", steps[-1].c_out, 10),
            ir.Logits("logits", 10)]
    return ir.BNNSpec("t", (4 * hw, 4 * hw, 3), (stem, *steps, *tail))


def _proj(stride=2, shortcut="projection", c=32, f=64, rprelu=False):
    ho = 8 // stride
    return ir.ResidualBinaryConv("s", 3, c, f, 8, 8, ho, ho, stride, 1,
                                 shortcut, rprelu=rprelu)


@pytest.mark.parametrize("rprelu", [False, True])
def test_validate_takes_a_projection_at_stride_two(rprelu):
    spec = _chain(_proj(rprelu=rprelu))
    spec.validate()
    assert spec.residual_nodes[0].shortcut == "projection"
    assert spec.stem_nodes[0].conv_hw() == (16, 16)


BAD = [
    ("takes the 'duplicate' shortcut, got 'projection'",
     lambda: _chain(_proj(stride=1))),
    ("takes the 'projection' shortcut, got 'duplicate'",
     lambda: _chain(_proj(shortcut="duplicate"))),
    ("takes the 'projection' shortcut, got 'avgpool'",
     lambda: _chain(_proj(shortcut="avgpool"))),
    ("takes the 'projection' shortcut, got 'identity'",
     lambda: _chain(_proj(shortcut="identity"))),
    ("takes the 'avgpool' shortcut, got 'projection'",
     lambda: _chain(_proj(f=32))),
    ("a 7x7 or a 3x3 over 3 channels", lambda: ir.BNNSpec("t", (16, 16, 3), (
        ir.RealConv("stem", 5, 5, 3, 32, 16, 16, 8, 8, 2, 2),
        ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10),
        ir.Logits("l", 10)))),
    ("the max pool maps H 16 to 8, not 7", lambda: ir.BNNSpec(
        "t", (32, 32, 3), (
            ir.RealConv("stem", 7, 7, 3, 32, 32, 32, 7, 7, 2, 3, pool=True),
            ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10),
            ir.Logits("l", 10)))),
    ("H 32 -> 8 is not a 7-wide", lambda: ir.BNNSpec("t", (32, 32, 3), (
        ir.RealConv("stem", 7, 7, 3, 32, 32, 32, 8, 8, 2, 3),
        ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10),
        ir.Logits("l", 10)))),
    # the stems no stem kernel takes: a 7x7 without the pool, a 3x3 with
    # it, a 7x7 and its pool at stride 1
    ("a 7x7 stride 2 pad 3 without the pool", lambda: ir.BNNSpec(
        "t", (32, 32, 3), (
            ir.RealConv("stem", 7, 7, 3, 32, 32, 32, 16, 16, 2, 3),
            ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10),
            ir.Logits("l", 10)))),
    ("a 3x3 stride 2 pad 1 with the pool", lambda: ir.BNNSpec(
        "t", (32, 32, 3), (
            ir.RealConv("stem", 3, 3, 3, 32, 32, 32, 8, 8, 2, 1, pool=True),
            ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10),
            ir.Logits("l", 10)))),
    ("a 7x7 stride 1 pad 3 with the pool", lambda: ir.BNNSpec(
        "t", (16, 16, 3), (
            ir.RealConv("stem", 7, 7, 3, 32, 16, 16, 8, 8, 1, 3, pool=True),
            ir.GlobalAvgPool("p"), ir.RealDense("fc", 32, 10),
            ir.Logits("l", 10)))),
]


@pytest.mark.parametrize("message,build", BAD, ids=[b[0] for b in BAD])
def test_validate_rejects_a_malformed_chain(message, build):
    with pytest.raises(ValueError, match=message):
        build().validate()


def test_plan_refuses_a_stem_row_wider_than_the_kernel_takes():
    # 256 pixels: a conv row of 128 columns, past STEM_POOL_COLS; the
    # plain route takes it
    spec = ir.bireal_spec("wide", 256, (32, 32, 64), (1, 1), 10)
    with pytest.raises(ValueError, match="at most 112 columns, got 128"):
        graph.compile(spec, backend="cuda", device="cpu", batch=2)
    graph.compile(spec, backend="torch", device="cpu", batch=2)


def test_bireal_net18_is_the_published_network():
    spec = ir.bireal_net18()
    res = spec.residual_nodes
    stem = spec.stem_nodes[0]
    assert len(res) == 16 and spec.input_shape == (224, 224, 3)
    assert (stem.kh, stem.stride, stem.pad, stem.c_out) == (7, 2, 3, 64)
    assert stem.conv_hw() == (112, 112) and stem.h_out == 56
    assert stem.pool and ir.STEM_POOL == POOL
    assert [nd.name for nd in res if nd.shortcut == "projection"] == \
        ["layer2.0", "layer3.0", "layer4.0"]
    assert {nd.shortcut for nd in res} == {"identity", "projection"}
    assert not any(nd.rprelu for nd in res)
    assert res[-1].h_out == 7 and spec.head_nodes[0].n_out == 1000
    # 1.676 G binary MACs an image; 118.0 M float MACs in the stem and
    # 19.3 M in the projections; 11.7 M parameters
    macs = sum(9 * nd.c_in * nd.c_out * nd.h_out ** 2 for nd in res)
    assert round(macs / 1e9, 3) == 1.676
    assert round(49 * 3 * 64 * 112 ** 2 / 1e6, 1) == 118.0
    proj = sum(nd.c_in * nd.c_out * nd.h_out ** 2 for nd in res
               if nd.shortcut == "projection")
    assert round(proj / 1e6, 1) == 19.3
    params = 49 * 3 * 64 + sum(9 * nd.c_in * nd.c_out for nd in res) + \
        sum(nd.c_in * nd.c_out for nd in res
            if nd.shortcut == "projection") + 512 * 1000 + 1000
    assert round(params / 1e6, 1) == 11.7


# ------------------------------------------------------------------ #
# the stem, the projection and the half-step against the reference    #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n,hw", [(2, 32), (1, 30), (1, 21)])
def test_pooled_stem_is_the_reference_bit_for_bit(n, hw):
    """``stem_conv_plain`` at 7x7 with the max pool against the
    reference's tap loop and MaxPool2d: the map and the words."""
    g = torch.Generator().manual_seed(hw)
    x = torch.randint(0, 256, (n, hw, hw, 3), generator=g).to(torch.float32)
    wt = torch.randn(7, 7, 3, 32, generator=g)
    bn = _bn_params(32, 5461.25 * (wt * wt).sum(dim=(0, 1, 2)), g)
    bn["mean"] = bn["mean"] + 127.5 * wt.sum(dim=(0, 1, 2))
    b_next = torch.rand(32, generator=g) - 0.5
    table = kres.stem_table(bn["mean"], bn["var"], bn["gamma"], bn["beta"],
                            b_next)
    out, bits = kres.stem_conv(x, wt, table, stride=2, pad=3, pool=POOL)
    conv = (hw + 6 - 7) // 2 + 1
    row = {"k": 7, "stride": 2, "pad": 3, "out_hw": conv}
    want = reference._maxpool(reference._stem(x, {"w": wt, **bn}, row,
                                              "exact"),
                              {"window": 3, "stride": 2, "pad": 1})
    assert out.shape == (n, (conv - 1) // 2 + 1, (conv - 1) // 2 + 1, 32)
    assert torch.equal(out, want)
    assert torch.equal(bits, PackedArray.pack(want + b_next, axis=-1).words)


@pytest.mark.parametrize("c,f,h", [(32, 64, 4), (64, 128, 6)])
def test_projection_is_the_reference_bit_for_bit(c, f, h):
    g = torch.Generator().manual_seed(c + h)
    x = torch.randn(2, h, h, c, generator=g) * 3.0
    w = torch.randn(c, f, generator=g)
    bn = _bn_params(f, (w * w).sum(dim=0), g)
    table = kres.shortcut_table(bn["mean"], bn["var"], bn["gamma"],
                                bn["beta"])
    got = kres.shortcut_conv(x, w, table)
    want = reference._projection(x, {"w": w, **bn}, "exact")
    assert got.shape == (2, h // 2, h // 2, f)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shortcut", ["identity", "projection"])
def test_neutral_half_step_is_a_bireal_half_step(shortcut):
    """The fused half-step's plain version with the neutral table (and,
    for a projection, ``shortcut_conv``'s map read as an identity
    shortcut) is a Bi-Real half-step written out: ``bn(alpha * dot) +
    shortcut``, and its words the signs of the result."""
    c, h = 32, 6
    f, stride = (2 * c, 2) if shortcut == "projection" else (c, 1)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, h, h, c, generator=g) * 2.0
    w = torch.randn(3, 3, c, f, generator=g)
    alpha = w.abs().mean(dim=(0, 1, 2))
    p = {"w": w, **_bn_params(f, alpha * alpha * 9 * c, g)}
    if shortcut == "projection":
        pw = torch.randn(c, f, generator=g)
        p["proj"] = {"w": pw, **_bn_params(f, (pw * pw).sum(dim=0), g)}
    wf = PackedArray.pack(w, axis=2)
    corr = kres.zero_pad_correction(wf.unpack(torch.float32))
    table = kres.neutral_table(alpha, p["mean"], p["var"], p["gamma"],
                               p["beta"])
    sc = x
    if shortcut == "projection":
        pr = p["proj"]
        sc = kres.shortcut_conv(x, pr["w"], kres.shortcut_table(
            pr["mean"], pr["var"], pr["gamma"], pr["beta"]))
    xp = PackedArray.pack(x, axis=-1)
    got, words = kres.residual_conv_plain(xp, wf, corr, table, sc,
                                          shortcut="identity", stride=stride,
                                          pad=1)
    row = {"name": "s", "stride": stride, "pad": 1, "shortcut": shortcut}
    want = reference._half_step(x, p, row)
    assert torch.equal(got, want)
    assert torch.equal(words, PackedArray.pack(want, axis=-1).words)


# ------------------------------------------------------------------ #
# the pooled stem kernel, emulated                                     #
# ------------------------------------------------------------------ #
def _pitch(wo):
    ap = 3 * (wo + 3)
    return ap + (4 - ap % 8) % 8


def _stem_pool_emulated(x, w, table, p):
    """What ``stem_conv_pool_kernel`` computes on the plan ``p``, band by
    band: input rows staged into a ring of 16 by column parity (entry q
    of parity r is column 2 (q - 2) + r, zero outside the image; the next
    step's rows staged before this step sums, as the copies may land
    while it does), each lane's 7 columns reading their taps at ``ring
    + ((2 y + kh - 3) & 15) * 2 ap`` plus ``3 ((kw + 1) / 2)`` (odd kw)
    or ``ap + 3 (kw / 2)`` (even kw) plus ``3 ox + c``, the sums in the
    order (kh, kw, c), the batch norm, the two rows' max, the max with
    the kept row, then each pooled pixel's max over three columns.
    Returns the map, the words and how often each pixel was written."""
    n, h, wi, _ = x.shape
    f = w.shape[-1]
    ho, wo, ph, pw = p["ho"], p["wo"], p["ph"], p["pw"]
    band, bands = p["band"], p["bands"]
    assert p["tiles"] == n * bands * (f // p["slab"])
    ap = _pitch(wo)
    ninf = float("-inf")
    wr = w.reshape(147, f)
    mean, inv, gamma, beta, b_next = table
    lanes = torch.arange(112)
    ox = (lanes % 16 + 16 * (lanes // 16)).clamp(max=wo - 1)
    real = (lanes % 16 + 16 * (lanes // 16)) < wo
    out = torch.full((n, ph, pw, f), float("nan"))
    hits = torch.zeros(n, ph, pw, dtype=torch.int64)
    e = torch.arange(2 * (wo + 3) * 3)
    ix, ce = e // 3 - 4, e % 3
    dst = (ix & 1) * ap + 3 * ((ix >> 1) + 2) + ce
    for img in range(n):
        for b in range(bands):
            py0, py1 = b * band, min(b * band + band, ph)
            ring = torch.full((16, 2 * ap), float("nan"))

            def stage(iy):
                ok = (0 <= iy < h) & (ix >= 0) & (ix < wi)
                v = x[img, min(max(iy, 0), h - 1),
                      ix.clamp(0, wi - 1), ce]
                ring[iy & 15, dst] = torch.where(ok, v, 0.0)

            pre = py0 > 0
            y0 = 2 * py0 - 2 if pre else 2 * py0
            prev = torch.full((wo, f), ninf)
            for iy in range(2 * y0 - 3, 2 * y0 + 6):
                stage(iy)
            steps = py1 - py0 + pre
            for s in range(steps):
                if s + 1 < steps:
                    for iy in range(2 * y0 + 6, 2 * y0 + 10):
                        stage(iy)
                rows = []
                for half in (0, 1):
                    y = y0 + half
                    acc = torch.zeros(112, f)
                    for kh in range(7):
                        base = ((2 * y + kh - 3) & 15)
                        for kw in range(7):
                            off = 3 * ((kw + 1) // 2) if kw & 1 else \
                                ap + 3 * (kw // 2)
                            for c in range(3):
                                xv = ring[base, off + 3 * ox + c]
                                acc = acc + xv[:, None] * \
                                    wr[(kh * 7 + kw) * 3 + c]
                    v = (acc - mean) * inv
                    v = v * gamma + beta
                    rows.append(v if y < ho else torch.full_like(v, ninf))
                m = torch.maximum(rows[0], rows[1])[real]
                if not (pre and s == 0):
                    vmax = torch.maximum(m, prev)
                prev = rows[1][real]
                if not (pre and s == 0):
                    py = y0 // 2
                    for px in range(pw):
                        cols = [cx for cx in (2 * px - 1, 2 * px, 2 * px + 1)
                                if 0 <= cx < wo]
                        out[img, py, px] = vmax[cols].amax(dim=0)
                        hits[img, py, px] += 1
                y0 += 2
    words = PackedArray.pack(out + b_next, axis=-1).words
    return out, words, hits


STEM_POOL_CASES = [(1, 32, 32, 32, 132), (2, 30, 26, 64, 132),
                   (2, 30, 26, 64, 1), (1, 21, 40, 96, 1),
                   (1, 224, 224, 64, 132)]


@pytest.mark.parametrize("n,h,w,f,sms", STEM_POOL_CASES)
def test_pooled_stem_kernel_bands_are_the_plain_version(n, h, w, f, sms):
    """The kernel's staging layout, tap addresses, pair walk and pool on
    :func:`kres.stem_pool_plan`'s bands give ``stem_conv_plain``'s map
    and words bit for bit, each pooled pixel written once."""
    x, wt, table = _stem_operands(n, h, w, f, seed=h + w + f)
    p = kres.stem_pool_plan(n, h, w, f, sms)
    got, words, hits = _stem_pool_emulated(x, wt, table, p)
    want = kres.stem_conv_plain(x, wt, table, stride=2, pad=3, pool=POOL)
    assert bool((hits == 1).all())
    assert torch.equal(got.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(words, want[1])


@pytest.mark.parametrize("n,h,w,f", [(1, 224, 224, 64), (7, 224, 224, 64),
                                     (256, 224, 224, 64), (1, 32, 32, 32),
                                     (3, 30, 26, 96), (1, 230, 229, 128)])
@pytest.mark.parametrize("sms", [132, 1])
def test_stem_pool_plan_fits_and_covers_every_row(n, h, w, f, sms):
    """The plan's bands cover the pooled rows; a block's shared memory
    lets two blocks share an SM; 64-channel slabs where F allows."""
    p = kres.stem_pool_plan(n, h, w, f, sms)
    conv_h, conv_w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    assert (p["ho"], p["wo"]) == (conv_h, conv_w)
    assert (p["ph"], p["pw"]) == ((conv_h - 1) // 2 + 1,
                                  (conv_w - 1) // 2 + 1)
    assert p["slab"] == (64 if f % 64 == 0 else 32)
    assert p["threads"] == 4 * p["slab"]
    assert (p["bands"] - 1) * p["band"] < p["ph"] <= p["bands"] * p["band"]
    assert p["smem"] == kres.stem_pool_smem(p["wo"], p["slab"])
    assert 2 * (p["smem"] + 1024) <= 233472
    if (n, h, f, sms) == (256, 224, 64, 132):
        # 256 blocks of a whole image each: one wave over 2 blocks an SM
        assert (p["band"], p["bands"], p["tiles"]) == (56, 1, 256)


STEM_BAD = [
    ("5x5 with a pool", dict(w=torch.zeros(5, 5, 3, 32)), "takes w"),
    ("7x7 without a pool", dict(pool=None), "takes w"),
    ("7x7 at stride 1", dict(stride=1), "takes w"),
    ("another pool", dict(pool=(2, 2, 0)), "takes w"),
]


@pytest.mark.parametrize("case,change,message", STEM_BAD,
                         ids=[b[0] for b in STEM_BAD])
def test_stem_conv_refuses_what_the_kernels_do_not_take(case, change,
                                                        message):
    x, wt, table = _stem_operands(1, 16, 16, 32, seed=3)
    a = dict(x=x, w=wt, table=table, stride=2, pad=3, pool=POOL)
    a.update(change)
    with pytest.raises(ValueError, match=message):
        kres.stem_conv(a.pop("x"), a.pop("w"), a.pop("table"), **a)


def test_shortcut_conv_refuses_an_odd_map():
    x, w, table = _proj_operands(1, 5, 16, 64, seed=1)
    with pytest.raises(ValueError, match="even map"):
        kres.shortcut_conv(x, w, table)


# ------------------------------------------------------------------ #
# plan, launches, and what refuses the residual nodes                  #
# ------------------------------------------------------------------ #
def test_plan_launches_and_description():
    cb = graph.compile(ir.bireal_net18(), device="cpu", batch=256)
    kinds = [s.kind for s in cb.plan]
    assert kinds.count("residual_conv") == 16
    assert kinds[0] == "real_conv" and cb.plan[0].args["pool"] == POOL
    # per forward: the stem 1, a projection before 3 half-steps, and one
    # fused kernel a half-step
    assert expected_launches(cb, 256) == {"stem_conv": 1, "shortcut_conv": 3,
                                          "residual_conv": 16}
    assert cb.launch_count() == 20 and cb.legacy_launch_count() == 36
    text = cb.describe()
    assert "max pool 3x3/s2 p1" in text and "shortcut_conv" in text
    assert "no activation" in text and "RPReLU" not in text.split(
        "\n", 1)[1].replace("RPReLU, the", "")
    sign_next = [s.args["sign_next"] for s in cb.plan
                 if s.kind in ("real_conv", "residual_conv")]
    assert sign_next == [True] * 16 + [False]
    # the stem, the half-steps and the projections take their rule alone
    assert len(cb.tuning_keys) == 0
    t = cb.traffic(1)
    assert [ly["name"] for ly in t["layers"]] == \
        [s.name for s in cb.plan if s.kind in ("real_conv", "residual_conv",
                                               "real_dense")]


def test_audit_passes_on_the_small_spec():
    cb = graph.compile(ir.bireal_small(), device="cpu", batch=2)
    assert cb.audit(batch=2, max_batch=8).ok


def test_tulip_mapping_refuses_the_residual_family():
    cb = graph.compile(ir.bireal_small(), device="cpu")
    with pytest.raises(ValueError, match="outside the TULIP mapping"):
        cb.tulip_mapping()


def test_simulator_refuses_the_residual_family():
    from repro_torch.sim import simulate
    cb = graph.compile(ir.bireal_small(), device="cpu")
    params = cb.init(torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="outside the TULIP mapping"):
        simulate(cb, params, _images(1, 32, seed=2))


def test_train_forward_refuses_the_residual_family():
    from repro_torch.train.models import train_forward
    spec = ir.bireal_small()
    with pytest.raises(ValueError, match="residual family"):
        train_forward(spec, {"conv": [], "fc": []}, {"conv": [], "fc": []},
                      _images(1, 32, seed=2), train=False)


def test_cpu_server_round_trip():
    from repro_torch.serving import BNNServer

    cb = graph.compile(ir.bireal_small(), device="cpu", batch=8)
    params = cb.init(torch.Generator().manual_seed(7))
    x = _images(5, 32, seed=8)
    srv = BNNServer(cb, params, max_batch=8, device="cpu")
    srv.start()
    try:
        got = srv.submit(x).result(timeout=60)
    finally:
        srv.stop()
    assert torch.equal(got, cb.apply(params, x))


def test_reference_imports_only_torch():
    path = ROOT / "src" / "repro_torch" / "reference" / "bireal.py"
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
def _same_bits(got, want):
    """Float maps by their bit patterns, and the sign words."""
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        assert torch.equal(got[1], want[1])


# (N, H, W, F, write the words): Bi-Real Net-18's stem at 1, 7 and 256
# rows; edge rows: an odd conv map (30 -> 15 -> 8), unequal sides, a
# small map, F of 32, 96 and 128 (slabs of 32 and 64), the widest conv
# row the kernel takes beside an odd one; the map alone
STEM_POOL_CARD_CASES = [
    (1, 224, 224, 64, True), (7, 224, 224, 64, True),
    (256, 224, 224, 64, True), (3, 30, 26, 64, True),
    (2, 32, 32, 32, True), (2, 31, 33, 96, True), (2, 40, 40, 128, True),
    (1, 223, 224, 64, True), (3, 224, 224, 64, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,f,write_bits", STEM_POOL_CARD_CASES)
def test_pooled_stem_kernel_bit_for_bit(cuda, n, h, w, f, write_bits):
    """Bi-Real Net's stem kernel against its plain version on the card:
    the pooled map by its bit patterns and the words, one launch."""
    x, wt, table = _stem_operands(n, h, w, f, seed=n + h + w + f,
                                  device=cuda)
    args = dict(stride=2, pad=3, pool=POOL, write_bits=write_bits)
    want = kres.stem_conv_plain(x, wt, table, **args)
    _build.reset_launch_counts()
    got = kres.stem_conv(x, wt, table, **args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["stem_conv"] == 1
    _same_bits(got, want)


# (N, H, C): Bi-Real Net-18's three projections at 1, 7 and 256 rows,
# and a map whose pixels leave a partial tile
PROJ_CARD_CASES = [(rows, h, c) for h, c in ((56, 64), (28, 128), (14, 256))
                   for rows in (1, 7, 256)] + [(3, 6, 16), (5, 10, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,c", PROJ_CARD_CASES)
def test_shortcut_kernel_bit_for_bit(cuda, n, h, c):
    x, w, table = _proj_operands(n, h, c, 2 * c if c >= 32 else 64,
                                 seed=n + h + c, device=cuda)
    want = kres.shortcut_conv_plain(x, w, table)
    _build.reset_launch_counts()
    got = kres.shortcut_conv(x, w, table)
    torch.cuda.synchronize()
    assert _build.launch_counts()["shortcut_conv"] == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_full_width_graphed_forward_against_the_reference(cuda):
    spec = ir.bireal_net18()
    cb = graph.compile(spec, batch=8)
    raw = cb.draw_residual(torch.Generator().manual_seed(0))
    params = cb.bind(raw)
    x = _images(6, 224, seed=1, device=cuda)
    g = graph.GraphedApply(cb, params, batch=8, valid_rows=6)
    _build.reset_launch_counts()
    got = g(x)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    # per forward: 1 stem, 3 projections, 16 fused half-steps, no
    # half-step unfused
    assert counts["stem_conv"] == 1 and counts["shortcut_conv"] == 3
    assert counts["residual_conv"] == 16 and counts["packed_conv2d"] == 0
    want = reference.logits(table_of(spec), weights_of(raw), x)
    assert float(_gap(got, want).max()) <= reference.LOGIT_REL_TOL
    head, _ = cb.split("avgpool")
    assert torch.equal(graph.GraphedApply(head, params, batch=8,
                                          valid_rows=6)(x),
                       head.apply(params, x))


@pytest.mark.gpu
def test_audit_on_the_card(cuda):
    cb = graph.compile(ir.bireal_small(), batch=4)
    report = cb.audit(batch=4, max_batch=8)
    launches = next(c for c in report.checks if c.name == "launches")
    assert report.ok and not launches.skipped
    assert report.launches == {"stem_conv": 1, "shortcut_conv": 1,
                               "residual_conv": 2}


@pytest.mark.gpu
def test_server_round_trip_on_the_card(cuda):
    from repro_torch.serving import BNNServer

    cb = graph.compile(ir.bireal_net18(), batch=8)
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
