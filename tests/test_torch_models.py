"""The port's LLM models against the reference's, per architecture.

For each of the ten architectures, reduced (``reduced(cfg)``) in
float32, the reference's params (``repro.models.init_params``) are
carried across with ``params_from_numpy`` and the same numpy-seeded
tokens (plus Whisper frames / image embeddings) go through both
packages:

* ``forward``'s logits at every position, ``prefill``'s last-token
  logits and caches, and one ``decode_step``'s logits and new caches
  match the reference's within ``TOL`` x max|ref| (float32 sums in
  another order; integer leaves such as cache positions exactly);
* prefill + decode agrees with the port's own forward, as
  ``tests/test_archs_smoke.py`` holds the reference;
* ``pack_model_params`` gives the reference's tree with the same paths
  packed: the words bit for bit (through ``as_uint32``), the same
  length and negative pack axis (on cycle-stacked leaves too), alpha
  within ``ALPHA_TOL``, and the packed forward matches the reference's
  packed forward;
* ``init_params`` from a ``torch.Generator`` and ``abstract_params`` on
  the meta device give the reference's tree, shapes and dtypes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro.kernels.packed import tree_nbytes as jtree_nbytes  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import _ctx_from_inputs as j_ctx  # noqa: E402
from repro.models.quantize import \
    pack_model_params as jpack_model_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.packed import (PackedArray, as_uint32,  # noqa: E402
                                        tree_nbytes)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import _ctx_from_inputs as t_ctx  # noqa: E402
from repro_torch.models.quantize import pack_model_params  # noqa: E402

ARCH_IDS = list(jconfigs.ARCHS)
TOL = 1e-4          # float32 logits and caches: x max|ref|
ALPHA_TOL = 1e-6    # alpha = mean|w| summed in another order
B, S, CAP = 2, 12, 16


def np_tree(tree):
    """The reference tree with every leaf as numpy — the form
    params_from_numpy takes."""
    if isinstance(tree, JPacked):
        return {"words": np.asarray(tree.words), "length": tree.length,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


def pairs(port, ref, path=""):
    """(path, port leaf, reference leaf) over two trees of one shape;
    a PackedArray pairs with the reference's words dict."""
    if isinstance(port, PackedArray):
        assert isinstance(ref, dict) and "words" in ref, path
        yield path, port, ref
    elif isinstance(port, dict):
        assert isinstance(ref, dict) and sorted(port) == sorted(ref), \
            (path, sorted(port), sorted(ref))
        for k in sorted(port):
            yield from pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, (list, tuple)):
        assert isinstance(ref, (list, tuple)) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from pairs(a, b, f"{path}/{i}")
    else:
        yield path, port, ref


def dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def assert_close(name, got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, \
        f"{name}: max err {err:.3g} > {tol} x {scale:.3g}"


def assert_trees_close(port, ref, tol=TOL):
    n = 0
    for path, a, b in pairs(port, ref):
        assert_close(path, a, b, tol)
        n += 1
    assert n > 0


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)
                                  ).astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision_patches":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jax_run(params, cfg, inp, with_caches=True):
    tokens = jnp.asarray(inp["tokens"])
    batch = {k: jnp.asarray(v) for k, v in inp.items()}
    ctx = j_ctx(params, cfg, batch)
    x, _, _ = jmodels.forward(params, cfg, tokens, ctx=ctx)
    emb = params.get("lm_head", params["embed"])
    out = {"forward": np.asarray(jlayers.logits_apply(emb, x, True))}
    if with_caches:
        pre = dict(batch, tokens=tokens[:, :S])
        logits0, caches = jmodels.prefill(params, cfg, pre,
                                          cache_capacity=CAP)
        dec, new_caches = jmodels.decode_step(params, cfg, {
            "tokens": tokens[:, S:S + 1],
            "step": jnp.full((B,), S, jnp.int32), "caches": caches})
        out.update(prefill=np.asarray(logits0), caches=np_tree(caches),
                   decode=np.asarray(dec), new_caches=np_tree(new_caches))
    return out


def _torch_run(params, cfg, inp, with_caches=True):
    tokens = torch.from_numpy(inp["tokens"]).long()
    batch = {k: torch.from_numpy(v) for k, v in inp.items()}
    batch["tokens"] = tokens
    ctx = t_ctx(params, cfg, batch)
    x, _, _ = tmodels.forward(params, cfg, tokens, ctx=ctx)
    emb = params.get("lm_head", params["embed"])
    out = {"forward": tlayers.logits_apply(emb, x, True)}
    if with_caches:
        pre = dict(batch, tokens=tokens[:, :S])
        logits0, caches = tmodels.prefill(params, cfg, pre,
                                          cache_capacity=CAP)
        dec, new_caches = tmodels.decode_step(params, cfg, {
            "tokens": tokens[:, S:S + 1],
            "step": torch.full((B,), S, dtype=torch.int32),
            "caches": caches})
        out.update(prefill=logits0, caches=caches, decode=dec,
                   new_caches=new_caches)
    return out


_CACHE = {}


def run(arch):
    """Both packages on one reduced arch (computed once per process:
    the reference's forward is the slow part)."""
    if arch not in _CACHE:
        cfg_j = jconfigs.reduced(jconfigs.get_arch(arch)).replace(
            dtype="float32")
        cfg_t = tconfigs.reduced(tconfigs.get_arch(arch)).replace(
            dtype="float32")
        jparams = jmodels.init_params(jax.random.PRNGKey(0), cfg_j)
        jpacked = jpack_model_params(jparams)
        inp = _inputs(cfg_t, seed=7)
        tparams = params_from_numpy(np_tree(jparams), "cpu")
        _CACHE[arch] = dict(
            cfg=cfg_t, jparams=jparams, inp=inp, tparams=tparams,
            ref=_jax_run(jparams, cfg_j, inp),
            port=_torch_run(tparams, cfg_t, inp),
            jpacked=np_tree(jpacked),
            jpacked_nbytes=(jtree_nbytes(jparams), jtree_nbytes(jpacked)),
            ref_packed=_jax_run(jpacked, cfg_j, inp, with_caches=False))
    return _CACHE[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    r = run(arch)
    assert_close("forward", r["port"]["forward"], r["ref"]["forward"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_reference(arch):
    r = run(arch)
    assert_close("prefill", r["port"]["prefill"], r["ref"]["prefill"])
    assert_trees_close(r["port"]["caches"], r["ref"]["caches"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_reference(arch):
    r = run(arch)
    assert_close("decode", r["port"]["decode"], r["ref"]["decode"])
    assert_trees_close(r["port"]["new_caches"], r["ref"]["new_caches"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_agrees_with_forward(arch):
    """decode(cache(prefill(x[:S]))) == forward(x[:S+1]) at position S,
    and prefill's own logits == forward at S-1 (the port alone)."""
    port = run(arch)["port"]
    fwd = port["forward"]
    assert_close("decode vs forward", port["decode"], fwd[:, S:S + 1])
    assert_close("prefill vs forward", port["prefill"], fwd[:, S - 1:S])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pack_model_params_words_bit_identical(arch):
    r = run(arch)
    packed = pack_model_params(r["tparams"])
    n_packed = 0
    for path, a, b in pairs(packed, r["jpacked"]):
        if isinstance(a, PackedArray):
            np.testing.assert_array_equal(as_uint32(a.words), b["words"],
                                          err_msg=path)
            assert (a.length, a.axis) == (b["length"], b["axis"]), path
            assert a.axis == -2, path
            n_packed += 1
        elif path.endswith("_alpha"):
            assert dtype_name(a) == str(b.dtype), path
            assert_close(path, a, b, ALPHA_TOL)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    assert n_packed > 0
    assert (tree_nbytes(r["tparams"]), tree_nbytes(packed)) == \
        r["jpacked_nbytes"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_packed_forward_matches_reference(arch):
    r = run(arch)
    packed = params_from_numpy(r["jpacked"], "cpu")
    port = _torch_run(packed, r["cfg"], r["inp"], with_caches=False)
    assert_close("packed forward", port["forward"],
                 r["ref_packed"]["forward"])


def _shape_tree(tree):
    """{path: (shape, dtype name)} of a reference or port tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_tree_shapes_and_dtypes(arch):
    """init_params from a torch.Generator and abstract_params on the
    meta device give the reference's tree, shapes and dtypes (the
    reduced bf16 config, and the full-size one abstractly)."""
    cfg_t = tconfigs.reduced(tconfigs.get_arch(arch))
    cfg_j = jconfigs.reduced(jconfigs.get_arch(arch))
    ref = _shape_tree(jax.eval_shape(
        lambda: jmodels.init_params(jax.random.PRNGKey(0), cfg_j)))
    params = tmodels.init_params(torch.Generator().manual_seed(0), cfg_t,
                                 device="cpu")
    assert _shape_tree(params) == ref
    assert all(t.device.type == "cpu" for t in _leaves(params))
    full = _shape_tree(tmodels.abstract_params(tconfigs.get_arch(arch)))
    assert full == _shape_tree(jmodels.abstract_params(
        jconfigs.get_arch(arch)))


def _leaves(tree):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(tree)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    for name, shape in tconfigs.SHAPES.items():
        ok, _ = tconfigs.shape_applicable(tconfigs.get_arch(arch), shape)
        if not ok:
            continue
        got = tmodels.input_specs(tconfigs.get_arch(arch), shape)
        want = jmodels.input_specs(jconfigs.get_arch(arch),
                                   jconfigs.get_shape(name))
        assert all(t.device.type == "meta" for t in _leaves(got))
        assert _shape_tree(got) == _shape_tree(want), (arch, name)


def test_init_params_runs_on_the_card_by_default():
    """No device means the card: without one it raises, never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.reduced(tconfigs.get_arch("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.init_caches(cfg, 1, 8)
