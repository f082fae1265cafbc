"""The port's LLM layers against the reference's, one piece at a time.

* The binary surface of ``models.layers`` on the port's kernels (plain
  versions on the CPU): ``dense`` with a PackedArray x (popcount_gemm,
  int32 dot x alpha), ``packed_dense`` (popcount_gemm's pack epilogue)
  and the ``packed_mlp`` shim (compile_dense_stack, fused_binary_mlp)
  equal the reference's ``xla`` backend exactly, on both port backends.
* The float paths — dense in every mode and layout, the norms, RoPE,
  the activations, ``logits_apply`` — match within 1e-6 x max|ref|
  (float32), with one case each for the hazards the port mirrors:
  ``jax.nn.gelu`` is the tanh approximation, ``jnp.var`` the population
  variance, ``ste_sign(0)`` is +1 while the pack bit of 0 is 0.
* MoE: the ``capacity`` and ``gather`` dispatches equal ``dense`` when
  no token is dropped, and every impl equals the reference's, with
  drops too; the int8 KV cache stays close to the float one and equals
  the reference's int8 decode.
* ``adopt_packed``, ``tree_nbytes`` and ``default_backend``.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.kernels import packed as jpacked  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import packed as tpacked  # noqa: E402
from repro_torch.kernels.packed import (PackedArray, as_uint32,  # noqa: E402
                                        from_uint32)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

FLOAT_TOL = 1e-6     # one layer in float32: x max|ref|
MODEL_TOL = 1e-4     # a reduced model's logits: x max|ref|
BACKENDS = ("cuda", "torch")   # on the CPU "cuda" takes the plain versions


def close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    scale = max(float(np.abs(want.astype(np.float64)).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"max err {err:.3g} > {tol} x {scale:.3g}"


def jpack(w, axis):
    return jpacked.PackedArray.pack(jnp.asarray(w), axis=axis)


def tpack(w, axis):
    return PackedArray.pack(torch.from_numpy(w), axis=axis)


# ------------------------------------------------------------------ #
# the binary surface: popcount_gemm and fused_binary_mlp               #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,k,n", [(5, 64, 48), (3, 100, 37), (7, 256, 96)])
def test_dense_packed_x_equals_reference(backend, m, k, n):
    """dense(p, PackedArray x): the int32 popcount dot x alpha, exact on
    the reference's packed params (the port's own pack gives the same
    words, and alpha within FLOAT_TOL: a mean summed in another
    order)."""
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    pj = jlayers.pack_dense_params({"w": jnp.asarray(w)})
    want = jlayers.dense(pj, jpacked.PackedArray.pack(jnp.asarray(x)))
    own = tlayers.pack_dense_params({"w": torch.from_numpy(w)})
    np.testing.assert_array_equal(as_uint32(own["wp"].words),
                                  np.asarray(pj["wp"].words))
    close(own["alpha"], np.asarray(pj["alpha"]), FLOAT_TOL)
    pt = params_from_numpy(
        {"wp": {"words": np.asarray(pj["wp"].words), "length": k,
                "axis": pj["wp"].axis},
         "alpha": np.asarray(pj["alpha"])}, "cpu")
    xp = PackedArray.pack(torch.from_numpy(x))
    got = tlayers.dense(pt, xp) if backend == "cuda" else \
        tlayers.kops.binary_binary_dense(
            xp, pt["wp"].move_pack_axis_last(),
            backend="torch").to(torch.float32) * pt["alpha"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("thr", ["scalar", "vector"])
def test_packed_dense_words_equal_reference(backend, thr):
    rng = np.random.default_rng(3)
    m, k, n = 9, 160, 70
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    t = 2 if thr == "scalar" else rng.integers(-6, 7, n).astype(np.int32)
    want = jlayers.packed_dense({"wp": jpack(w, 0)},
                                jpacked.PackedArray.pack(jnp.asarray(x)),
                                t if thr == "scalar" else jnp.asarray(t),
                                backend="xla")
    got = tlayers.packed_dense({"wp": tpack(w, 0)},
                               PackedArray.pack(torch.from_numpy(x)),
                               t if thr == "scalar" else torch.from_numpy(t),
                               backend=backend)
    assert (got.length, got.axis) == (want.length, want.axis)
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("widths", [(96, (64, 80, 32)),
                                    (128, (224, 64, 128)),
                                    (64, (33,))])
def test_packed_mlp_words_equal_reference(backend, widths):
    """The deprecated packed_mlp shim (compile_dense_stack) gives the
    reference's words, mixing scalar and per-channel thresholds."""
    k0, ns = widths
    rng = np.random.default_rng(k0 + len(ns))
    x = rng.standard_normal((6, k0)).astype(np.float32)
    ws, ts = [], []
    k = k0
    for i, n in enumerate(ns):
        ws.append(rng.standard_normal((k, n)).astype(np.float32))
        ts.append(1 if i % 2 else rng.integers(-4, 5, n).astype(np.int32))
        k = n
    want = jlayers.packed_mlp(
        [{"wp": jpack(w, 0)} for w in ws],
        jpacked.PackedArray.pack(jnp.asarray(x)),
        [t if isinstance(t, int) else jnp.asarray(t) for t in ts],
        backend="xla")
    got = tlayers.packed_mlp(
        [{"wp": tpack(w, 0)} for w in ws],
        PackedArray.pack(torch.from_numpy(x)),
        [t if isinstance(t, int) else torch.from_numpy(t) for t in ts],
        backend=backend)
    assert got.length == want.length == ns[-1]
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))


# ------------------------------------------------------------------ #
# float paths and the mirrored hazards                                 #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("mode", ["none", "weights", "weights+acts"])
@pytest.mark.parametrize("layout", ["latent", "packed"])
def test_dense_float_paths_match_reference(mode, layout):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    pj = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    pt = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    if layout != "latent":
        pj, pt = jlayers.pack_dense_params(pj), tlayers.pack_dense_params(pt)
    want = jlayers.dense(pj, jnp.asarray(x), mode)
    got = tlayers.dense(pt, torch.from_numpy(x), mode)
    close(got, want, FLOAT_TOL)


@pytest.mark.parametrize("where", ["dense", "moe"])
def test_raw_words_are_refused(where):
    """The projections take packed weights only as PackedArrays: raw
    int32 words raise (``adopt_packed`` is the one way in), and the
    same words adopted give the packed layout's result."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    p = tlayers.pack_dense_params({"w": w})
    raw = {"wp": p["wp"].words, "alpha": p["alpha"]}
    if where == "dense":
        with pytest.raises(TypeError, match="PackedArray"):
            tlayers.dense(raw, x)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            adopted = dict(raw, wp=tpacked.adopt_packed(
                raw["wp"], axis=0, context="test raw words"))
        assert torch.equal(tlayers.dense(adopted, x), tlayers.dense(p, x))
    else:
        moe_p = {"w_gate_p": raw["wp"][None], "w_gate_alpha": p["alpha"]}
        with pytest.raises(TypeError, match="PackedArray"):
            tmoe._get_w(moe_p, "w_gate", "weights", torch.float32)


def test_sign_of_zero_hazard():
    """ste_sign maps 0 to +1 (dense latent path) while the pack bit of
    0 is 0, i.e. -1 (packed path): both as the reference."""
    w = np.array([[0.0, 1.0], [-1.0, 0.0], [2.0, -3.0]], np.float32)
    x = np.ones((1, 3), np.float32)
    want = jlayers.dense({"w": jnp.asarray(w)}, jnp.asarray(x), "weights")
    got = tlayers.dense({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                        "weights")
    close(got, want, FLOAT_TOL)
    pt = tlayers.pack_dense_params({"w": torch.from_numpy(w)})
    assert as_uint32(pt["wp"].words).tolist() == [[0b100, 0b001]]
    np.testing.assert_array_equal(
        as_uint32(pt["wp"].words),
        np.asarray(jlayers.pack_dense_params({"w": jnp.asarray(w)})
                   ["wp"].words))
    dense_y = got.numpy()
    packed_y = tlayers.dense(pt, torch.from_numpy(x)).numpy()
    assert not np.allclose(dense_y, packed_y)   # the zeros' signs differ


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tlayers.act_fn("gelu")(torch.from_numpy(x))
    close(got, want, FLOAT_TOL)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4     # erf gelu would fail
    for name in ("silu", "relu"):
        close(tlayers.act_fn(name)(torch.from_numpy(x)),
              np.asarray(jlayers.act_fn(name)(jnp.asarray(x))), FLOAT_TOL)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_population_variance_float32_inside(kind, dtype):
    rng = np.random.default_rng(5)
    d = 8        # small d: n vs n-1 in the variance shows plainly
    x = (rng.standard_normal((3, 4, d)) * 3 + 1).astype(np.float32)
    sc = rng.standard_normal(d).astype(np.float32)
    bi = rng.standard_normal(d).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    pj = {"scale": jnp.asarray(sc).astype(jd),
          "bias": jnp.asarray(bi).astype(jd)}
    pt = {"scale": torch.from_numpy(sc).to(td),
          "bias": torch.from_numpy(bi).to(td)}
    want = jlayers.apply_norm(pj, jnp.asarray(x).astype(jd), kind)
    got = tlayers.apply_norm(pt, torch.from_numpy(x).to(td), kind)
    assert got.dtype == td
    tol = FLOAT_TOL if dtype == "float32" else 2 ** -8   # one bf16 ulp
    close(got.to(torch.float32), np.asarray(want.astype(jnp.float32)), tol)
    if kind == "layernorm" and dtype == "float32":
        xf = torch.from_numpy(x)
        unbiased = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
            xf.var(-1, keepdim=True, correction=1) + 1e-6)
        unbiased = unbiased * pt["scale"] + pt["bias"]
        assert (unbiased - got).abs().max() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    for pos in (np.arange(7, dtype=np.int32),
                np.array([[3], [200]], np.int32)):
        xx = x if pos.ndim == 1 else x[:, :1]
        want = jlayers.apply_rope(jnp.asarray(xx).astype(jd),
                                  jnp.asarray(pos), 10_000.0)
        got = tlayers.apply_rope(torch.from_numpy(xx).to(td),
                                 torch.from_numpy(pos), 10_000.0)
        assert got.dtype == td
        tol = 1e-5 if dtype == "float32" else 2 ** -7
        close(got.to(torch.float32), np.asarray(want.astype(jnp.float32)),
              tol)


def test_logits_apply_casts_weight_then_result():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((40, 16)).astype(np.float32)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    got = tlayers.logits_apply(torch.from_numpy(emb),
                               torch.from_numpy(x).to(torch.bfloat16), True)
    assert got.dtype == torch.float32
    want = jlayers.logits_apply(jnp.asarray(emb),
                                jnp.asarray(x).astype(jnp.bfloat16), True)
    close(got, np.asarray(want), 2 ** -7)
    close(tlayers.logits_apply(torch.from_numpy(emb), torch.from_numpy(x),
                               True),
          np.asarray(jlayers.logits_apply(jnp.asarray(emb), jnp.asarray(x),
                                          True)), FLOAT_TOL)


# ------------------------------------------------------------------ #
# MoE dispatch and the int8 KV cache                                   #
# ------------------------------------------------------------------ #
def _moe_case(num_experts, top_k, seed=4):
    base = dict(num_experts=num_experts, top_k=top_k, dtype="float32")
    cfg_j = jconfigs.reduced(jconfigs.get_arch("mixtral-8x22b")).replace(
        **base)
    cfg_t = tconfigs.reduced(tconfigs.get_arch("mixtral-8x22b")).replace(
        **base)
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), cfg_j)
    pt = params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, "cpu")
    rng = np.random.default_rng(seed)
    # a shared offset skews the routing, so a small capacity overflows
    x = (rng.standard_normal((2, 12, cfg_t.d_model))
         + 2 * rng.standard_normal(cfg_t.d_model)).astype(np.float32)
    return cfg_j, cfg_t, pj, pt, x


@pytest.mark.parametrize("impl", ["capacity", "gather"])
def test_moe_dispatch_equals_dense_without_drops(impl):
    """4 experts, top-2, S=12: capacity int(2*S*k/E) = 12 holds every
    token an expert can get, so no token drops."""
    _, cfg, _, pt, x = _moe_case(4, 2)
    xt = torch.from_numpy(x)
    y_dense, aux_d = tmoe.moe_apply(pt, xt, cfg, impl="dense")
    y, aux = tmoe.moe_apply(pt, xt, cfg, impl=impl)
    close(y, y_dense.numpy(), FLOAT_TOL)
    assert float(aux) == float(aux_d)


@pytest.mark.parametrize("impl", ["dense", "capacity", "gather"])
@pytest.mark.parametrize("experts,top_k", [(4, 2), (8, 1)])
def test_moe_impls_match_reference(impl, experts, top_k):
    """8 experts top-1 has capacity 3 of 12 tokens: tokens drop, and the
    port drops the same ones."""
    cfg_j, cfg_t, pj, pt, x = _moe_case(experts, top_k)
    yj, auxj = jmoe.moe_apply(pj, jnp.asarray(x), cfg_j, impl=impl)
    yt, auxt = tmoe.moe_apply(pt, torch.from_numpy(x), cfg_t, impl=impl)
    close(yt, np.asarray(yj), FLOAT_TOL)
    close(auxt, np.asarray(auxj), FLOAT_TOL)
    if (experts, top_k) == (8, 1) and impl != "dense":
        yd, _ = tmoe.moe_apply(pt, torch.from_numpy(x), cfg_t, impl="dense")
        assert (yd - yt).abs().max() > 1e-3          # something dropped


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x22b"])
def test_int8_kv_cache_close_to_float_and_to_reference(arch):
    from test_torch_models import np_tree
    cfg_j = jconfigs.reduced(jconfigs.get_arch(arch)).replace(
        dtype="float32", num_layers=2)
    cfg_t = tconfigs.reduced(tconfigs.get_arch(arch)).replace(
        dtype="float32", num_layers=2)
    pj = jmodels.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_numpy(np_tree(pj), "cpu")
    B, S = 2, 12
    toks = np.random.default_rng(0).integers(
        0, cfg_t.vocab_size, (B, S + 1)).astype(np.int32)
    outs = {}
    for tag, ct in (("fp", cfg_t), ("int8", cfg_t.replace(
            kv_cache_dtype="int8"))):
        tt = torch.from_numpy(toks).long()
        _, caches = tmodels.prefill(pt, ct, {"tokens": tt[:, :S]},
                                    cache_capacity=16)
        assert (caches["layers"][0]["self"]["k"].dtype == torch.int8) == \
            (tag == "int8")
        logits, _ = tmodels.decode_step(pt, ct, {
            "tokens": tt[:, S:S + 1],
            "step": torch.full((B,), S, dtype=torch.int32),
            "caches": caches})
        outs[tag] = logits.numpy()
    denom = np.abs(outs["fp"]).max() + 1e-9
    assert np.abs(outs["fp"] - outs["int8"]).max() / denom < 5e-2
    cj8 = cfg_j.replace(kv_cache_dtype="int8")
    _, cj = jmodels.prefill(pj, cj8, {"tokens": jnp.asarray(toks[:, :S])},
                            cache_capacity=16)
    want, _ = jmodels.decode_step(pj, cj8, {
        "tokens": jnp.asarray(toks[:, S:S + 1]),
        "step": jnp.full((B,), S, jnp.int32), "caches": cj})
    close(outs["int8"], np.asarray(want), MODEL_TOL)


# ------------------------------------------------------------------ #
# the kernels/packed.py pieces this side uses                          #
# ------------------------------------------------------------------ #
def test_adopt_packed_warns_once_per_context():
    words = from_uint32(np.array([[0xFFFF0000, 7]], np.uint32))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        a = tpacked.adopt_packed(words, axis=0, context="test ctx A")
        tpacked.adopt_packed(words, axis=0, context="test ctx A")
        tpacked.adopt_packed(words, length=20, axis=0, context="test ctx B")
    dep = [r for r in rec if issubclass(r.category, DeprecationWarning)]
    assert len(dep) == 2
    assert (a.length, a.axis) == (32, -2)
    assert tpacked.adopt_packed(a) is a
    with pytest.raises(ValueError):
        tpacked.adopt_packed(a, length=31)


def test_tree_nbytes_counts_words_and_default_backend_is_cuda():
    p = {"a": torch.zeros(3, 5), "b": (tpack(
        np.ones((64, 10), np.float32), 0), None),
        "c": [torch.zeros(4, dtype=torch.bfloat16)]}
    assert tpacked.tree_nbytes(p) == 60 + 2 * 10 * 4 + 8
    assert tpacked.default_backend() == "cuda"
    assert tpacked.get_backend().name == "cuda"


def test_packed_cnn_shims_equal_the_compiled_pipeline():
    """The deprecated CNN shims: the reference's params through
    ``packed_cnn_apply`` give the reference's logits exactly (integer
    images), and init / traffic are the compiled pipeline's."""
    from repro.core.workloads import binarynet_cifar10 as jbinarynet
    from repro_torch import graph as tgraph
    from repro_torch.core.workloads import binarynet_cifar10
    from test_torch_models import np_tree
    pj = jlayers.packed_cnn_init(jax.random.PRNGKey(0), jbinarynet())
    x = np.random.default_rng(0).integers(-3, 4, (2, 32, 32, 3)
                                          ).astype(np.float32)
    want = jlayers.packed_cnn_apply(pj, jnp.asarray(x), jbinarynet(),
                                    backend="xla")
    wl = binarynet_cifar10()
    got = tlayers.packed_cnn_apply(params_from_numpy(np_tree(pj), "cpu"),
                                   torch.from_numpy(x), wl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    a = tlayers.packed_cnn_init(torch.Generator().manual_seed(1), wl,
                                device="cpu")
    b = tgraph.compile(wl, device="cpu").init(
        torch.Generator().manual_seed(1))
    assert torch.equal(a["conv"][0]["w"], b["conv"][0]["w"])
    assert torch.equal(a["fc"][-1]["wp"].words, b["fc"][-1]["wp"].words)
    assert tlayers.packed_cnn_traffic(wl, batch=2) == \
        tgraph.compile(wl, device="cpu").traffic(batch=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d,dff", [(1024, 2816), (96, 160)])
def test_gpu_binary_surface_equals_plain(cuda, d, dff):
    """dense with a packed x, packed_dense and the packed_mlp shim on
    the card: popcount_gemm / fused_binary_mlp launched, words and
    values equal to the "torch" backend's."""
    from repro_torch.kernels import _build
    g = torch.Generator(device=cuda).manual_seed(d)

    def rn(*s):
        return torch.randn(s, generator=g, device=cuda)
    xp = PackedArray.pack(rn(64, d))
    p = tlayers.pack_dense_params({"w": rn(d, dff)})
    stack = [tlayers.pack_dense_params({"w": rn(k, n)})
             for k, n in ((d, dff), (dff, dff), (dff, d))]
    ts = [3, 0, torch.randint(-9, 10, (d,), generator=g, device=cuda,
                              dtype=torch.int32)]
    _build.reset_launch_counts()
    y = tlayers.dense(p, xp)
    words = tlayers.packed_dense(p, xp, 5)
    out = tlayers.packed_mlp(stack, xp, ts)
    counts = _build.launch_counts()
    assert counts["popcount_gemm"] >= 2 and \
        counts["fused_binary_mlp"] + counts["popcount_gemm"] >= 3
    plain = tlayers.kops.binary_binary_dense(
        xp, p["wp"].move_pack_axis_last(), backend="torch")
    assert torch.equal(y, plain.to(torch.float32) * p["alpha"])
    assert torch.equal(words.words, tlayers.packed_dense(
        p, xp, 5, backend="torch").words)
    assert torch.equal(out.words, tlayers.packed_mlp(
        stack, xp, ts, backend="torch").words)
