"""The port's op counter (``repro_torch.runtime.op_cost``) against the
reference's loop-aware HLO analyzer (``repro.runtime.hlo_cost``).

* the four counting cases of ``tests/test_hlo_cost.py`` — matmul flops,
  a 12-trip loop, nested 5 x 7 loops, slices charged and not stacks —
  each within the reference's 5%, with the loops walked and with
  ``op_cost.scan`` scaling one trip (the two counts equal);
* the counting rules: views free, an in-place update charged its
  region, every rule name an aten op;
* each reduced architecture's ``forward`` on the same converted params
  and tokens: the port's flops within ``FLOP_TOL`` of
  ``hlo_cost.analyze`` of the reference's jitted forward, falcon-mamba
  within ``MAMBA_RATIO`` — its selective scan is the gap, and with the
  scan's own difference taken out it is within ``FLOP_TOL`` too;
* the scaled count (a layer cycle counted as the difference of two cut
  depths, chunk loops one trip) equals the full count exactly on the
  ten reduced archs, train and prefill.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import _ctx_from_inputs as j_ctx  # noqa: E402
from repro.runtime.hlo_cost import analyze  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import _ctx_from_inputs as t_ctx  # noqa: E402
from repro_torch.runtime import op_cost  # noqa: E402

from test_torch_models import np_tree  # noqa: E402

ARCH_IDS = list(jconfigs.ARCHS)
REL = 0.05            # the reference's tolerance in test_hlo_cost.py
FLOP_TOL = 0.05       # port forward flops vs hlo_cost, relative
# falcon-mamba's forward at B=2, S=64 counts 0.841 of hlo_cost's flops
# (measured): XLA's compiled associative scan (jax's odd/even
# recursion) counts 25.6 flops an element of a 16-step chunk where the
# port's doubling scan counts 11.2 — the HLO recomputes the up-sweep's
# products in each consumer fusion and interleaves the odd and even
# halves with pad + pad + add, an add an element a level that hlo_cost
# prices as arithmetic.  Both compute the same recurrence.
MAMBA_RATIO = (0.80, 0.88)
B, S = 2, 64


def rel(got, want):
    return abs(got - want) / want


# ------------------------------------------------------------------ #
# test_hlo_cost.py's cases                                             #
# ------------------------------------------------------------------ #
def _count(fn, *args, scale_loops=False):
    with torch.no_grad(), op_cost.Counter(scale_loops=scale_loops) as c:
        fn(*args)
    return c.cost


def test_matmul_flops_exact():
    a, b = torch.randn(256, 512), torch.randn(512, 128)
    c = op_cost.count(lambda x, y: x @ y, a, b)
    expect = 2 * 256 * 512 * 128
    assert rel(c.flops, expect) < REL
    assert c.flops == expect
    assert c.bytes == (256 * 512 + 512 * 128 + 256 * 128) * 4


def _scan_12(xs):
    def body(carry, x):
        return carry + x @ x, None
    return op_cost.scan(body, torch.zeros(64, 64), xs)


@pytest.mark.parametrize("scale_loops", [False, True])
def test_scan_trip_count_scaling(scale_loops):
    xs = torch.randn(12, 64, 64)
    c = _count(_scan_12, xs, scale_loops=scale_loops)
    expect = 12 * 2 * 64 ** 3
    assert rel(c.flops, expect) < REL
    assert c.flops == _count(_scan_12, xs).flops


def _nested(xs):
    def inner(ci, xi):
        return ci + xi @ xi, None

    def outer(co, x):
        ci, _ = op_cost.scan(inner, co, x)
        return ci, None
    return op_cost.scan(outer, torch.zeros(32, 32), xs)


@pytest.mark.parametrize("scale_loops", [False, True])
def test_nested_scan_multiplies(scale_loops):
    xs = torch.randn(5, 7, 32, 32)
    c = _count(_nested, xs, scale_loops=scale_loops)
    expect = 5 * 7 * 2 * 32 ** 3
    assert rel(c.flops, expect) < REL
    assert c.flops == _count(_nested, xs).flops


@pytest.mark.parametrize("scale_loops", [False, True])
def test_scan_bytes_charge_slices_not_stacks(scale_loops):
    """A loop reading one [64,64] slice a trip must charge ~trips *
    slice bytes, not trips * full-stack bytes."""
    trips = 50
    xs = torch.randn(trips, 64, 64)
    c = _count(_scan_12, xs, scale_loops=scale_loops)
    stack_bytes = trips * trips * 64 * 64 * 4     # the over-count regime
    assert c.bytes < stack_bytes / 4, \
        f"bytes {c.bytes:.2e} look like full-stack charging"
    assert c.bytes == _count(_scan_12, xs).bytes


def test_scaled_scan_returns_the_loops_shapes():
    """One trip run, its ``y`` in every slot: the shapes (and so every
    op after the loop) are the full loop's."""
    xs = torch.randn(6, 8, 8)

    def body(h, x):
        h = h + x
        return h, h * 2
    with torch.no_grad(), op_cost.Counter(scale_loops=True):
        h1, ys1 = op_cost.scan(body, torch.zeros(8, 8), xs)
    h0, ys0 = op_cost.scan(body, torch.zeros(8, 8), xs)
    assert len(ys1) == len(ys0) == 6 and h1.shape == h0.shape
    h, want = torch.zeros(8, 8), []
    for x in xs:
        h = h + x
        want.append(h * 2)
    assert torch.equal(torch.stack(ys0), torch.stack(want))


def test_scan_runs_every_trip_with_grad_on():
    """With grad enabled the backward pass would see one trip, so the
    loop runs whole even under a scaling counter."""
    xs = torch.randn(4, 64, 64, requires_grad=True)
    with op_cost.Counter(scale_loops=True) as c:
        h, _ = _scan_12(xs)
    with op_cost.Counter() as full:
        _scan_12(xs)
    assert c.cost.flops == full.cost.flops
    assert c.ops == full.ops


# ------------------------------------------------------------------ #
# the counting rules                                                   #
# ------------------------------------------------------------------ #
def test_views_cost_nothing():
    x = torch.randn(4, 6, 8)

    def views(t):
        return (t.transpose(0, 1), t.reshape(24, 8), t[:, 2:4],
                t.select(0, 1), t.expand(2, 4, 6, 8), t.unsqueeze(0),
                t.detach(), t.permute(2, 0, 1), t.unbind(0))
    c = op_cost.count(views, x)
    assert (c.flops, c.bytes) == (0.0, 0.0)


def test_elementwise_and_reductions():
    x = torch.randn(10, 20)
    assert op_cost.count(torch.add, x, x).flops == 200
    assert op_cost.count(torch.nn.functional.silu, x).flops == 400
    assert op_cost.count(lambda t: t.sum(dim=-1), x).flops == 10
    assert op_cost.count(lambda t: t.mean(dim=-1), x).flops == 20
    # a dtype change is a convert, a same-dtype copy moves bytes only
    assert op_cost.count(lambda t: t.to(torch.bfloat16), x).flops == 200
    assert op_cost.count(torch.clone, x).flops == 0


def test_in_place_update_charges_its_region():
    """index_put_ is the dynamic-update-slice of a cache write: twice
    the written rows, not the whole cache."""
    cache = torch.zeros(1024, 64)
    idx = torch.tensor([3, 7])
    vals = torch.ones(2, 64)

    def put(c):
        c[idx] = vals
    c = op_cost.count(put, cache)
    assert c.bytes == 2 * 2 * 64 * 4 + idx.numel() * 8


def test_rule_names_are_aten_ops():
    """Every name of the rule tables resolves to an aten op (a renamed
    op would otherwise go unpriced silently)."""
    for name in (*op_cost.DOT, *op_cost.ELEMENTWISE, *op_cost.REDUCE):
        assert hasattr(torch.ops.aten, name), name


def test_peak_follows_storage_lifetimes():
    """peak_bytes: the live bytes created inside the call at their
    peak; a freed temporary stops counting."""
    x = torch.randn(1000)

    def f(t):
        a = t * 2                   # 4000 bytes
        b = a + 1                   # 8000 live
        del a
        return b * 3                # b + result: 8000 live
    with op_cost.Counter() as c:
        out = f(x)
    assert c.peak_bytes == 8000
    assert c.live_bytes == 4000
    del out
    assert c.live_bytes == 0


# ------------------------------------------------------------------ #
# the ten reduced architectures against hlo_cost                       #
# ------------------------------------------------------------------ #
def _inputs(cfg):
    rng = np.random.default_rng(0)
    inp = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                  ).astype(np.int32)}
    if cfg.is_encdec:
        inp["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision_patches":
        inp["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return inp


def _forward_flops(arch):
    """(port flops, hlo_cost flops) of ``forward`` + logits on the same
    converted params and inputs."""
    cfg_j = jconfigs.reduced(jconfigs.get_arch(arch)).replace(
        dtype="float32")
    cfg_t = tconfigs.reduced(tconfigs.get_arch(arch)).replace(
        dtype="float32")
    jp = jmodels.init_params(jax.random.PRNGKey(0), cfg_j)
    inp = _inputs(cfg_t)

    def jf(p, batch):
        x, _, _ = jmodels.forward(p, cfg_j, batch["tokens"],
                                  ctx=j_ctx(p, cfg_j, batch))
        return jlayers.logits_apply(p.get("lm_head", p["embed"]), x, True)
    text = jax.jit(jf).lower(
        jp, {k: jnp.asarray(v) for k, v in inp.items()}).compile().as_text()
    tp = params_from_numpy(np_tree(jp), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp.items()}
    batch["tokens"] = batch["tokens"].long()

    def tf(p, b):
        x, _, _ = tmodels.forward(p, cfg_t, b["tokens"],
                                  ctx=t_ctx(p, cfg_t, b))
        return tlayers.logits_apply(p.get("lm_head", p["embed"]), x, True)
    return op_cost.count(tf, tp, batch).flops, analyze(text).flops, cfg_t


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_flops_match_hlo_cost(arch):
    port, ref, cfg = _forward_flops(arch)
    if cfg.family != "ssm":
        assert rel(port, ref) < FLOP_TOL, (port, ref, port / ref)
        return
    lo, hi = MAMBA_RATIO
    assert lo <= port / ref <= hi, port / ref
    # the gap is the selective scan: take out its difference at this
    # shape, layer by layer, and the rest agrees within FLOP_TOL
    C, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    a = jax.ShapeDtypeStruct((B, S, C, N), jnp.float32)
    h0 = jax.ShapeDtypeStruct((B, C, N), jnp.float32)
    scan_ref = analyze(jax.jit(lambda a, b, h: jssm._scan_chunked(
        a, b, h, 16)).lower(a, a, h0).compile().as_text()).flops
    z = torch.zeros(B, S, C, N)
    scan_port = op_cost.count(tssm._scan_chunked, z, z,
                              torch.zeros(B, C, N), 16).flops
    assert scan_ref / scan_port > 2.0
    closed = port + cfg.num_layers * (scan_ref - scan_port)
    assert rel(closed, ref) < FLOP_TOL, (closed, ref)


# ------------------------------------------------------------------ #
# the scaled count equals the full count                               #
# ------------------------------------------------------------------ #
SMALL = {"train": tconfigs.ShapeConfig("t", 16, 2, "train"),
         "prefill": tconfigs.ShapeConfig("p", 16, 2, "prefill")}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_scaled_count_equals_full_count(arch):
    """Four cycles a stack (whisper's encoder too), attention tiles of
    4 x 8 over 16 tokens: the dry-run's count (a cycle as the
    difference of two cut depths, prefill's chunk loops one trip)
    equals the count of the whole step, flops and bytes exactly."""
    base = tconfigs.reduced(tconfigs.get_arch(arch)).replace(
        dtype="float32", attn_q_chunk=4, attn_kv_chunk=8, remat="full")
    cyc, _, rem = dryrun._stacks(base)["decoder"]
    cfg = base.replace(num_layers=4 * len(cyc) + rem,
                       encoder_layers=4 if base.is_encdec else 0)
    for kind, shape in SMALL.items():
        _, fn, args = dryrun.build_cell(arch, shape.name, "baseline", cfg,
                                        shape)
        with op_cost.Counter() as full:
            fn(*args)
        got = dryrun.step_cost(arch, shape.name, "baseline", cfg, shape)
        assert got["walked_cycles"], (arch, got["cycles"])
        assert (got["cost2"].flops, got["cost2"].bytes) == \
            (full.cost.flops, full.cost.bytes), (arch, kind)
