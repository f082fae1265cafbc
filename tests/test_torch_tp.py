"""Tensor-parallel compute over "model" (``runtime.sharding``'s
``tensor_parallel``, ``Block`` and the autograd collectives; the
models' TP layers), on the CPU with gloo ranks.

* The vocab-parallel loss and embedding: ``chunked_xent`` (its last
  chunk padded), ``vocab_parallel_nll`` and ``embed_lookup`` on a vocab
  block, on the 2 model ranks of a (2, 2) mesh and the 4 of a (1, 4)
  one, at a small vocab and at qwen1.5-0.5b's (151,936 rows, chunk
  8192), with a target on each rank's first and last rows (those next
  to a padded last chunk), against the one-process versions: values
  and the gradients of ``x`` and of the rank's block, finite and within
  1e-5.
* The mesh prefill and decode (``launch.dryrun.place_cell``: the params
  as their blocks, the caches in their ``batch_specs`` blocks) on (2, 2)
  and (1, 4), from the reference's params (``params_from_numpy``): the
  logits against the one-process port's ``prefill`` / ``decode_step``
  and against the reference's, within ``TOL`` x max|ref|; every cache
  leaf a rank returns is the ``batch_specs`` block of the one-process
  caches (its shape, and its values within ``TOL``), a second decode
  step from the mesh's own cache blocks too.  internlm2 has 2 kv heads:
  on (1, 4) its kv heads do not divide, so a rank's q head reads the
  kv head it needs and the cache is split over the sequence (split-KV
  decode); recurrentgemma's RG-LRU and falcon-mamba's Mamba blocks run
  on their channel blocks with their states in their blocks
  (recurrentgemma at 8 layers: 2 cycles and 2 remainder RG-LRU blocks,
  whose leaves the rules leave whole, their states gathered and cut
  back), and
  recurrentgemma's MQA attention (one kv head) reads it whole; whisper's
  cross-attention reads its static cache; qwen packed runs the
  row-parallel packed words (their blocks on (2, 2), rows unpacked
  from whole words on (1, 4)) and int8 kv caches.
* Packed words row-parallel: a block's length is its bits (the last
  block's pad bits outside it, and 0), and rows cut from whole words
  equal the rows of the unpacked weight.
* The head rules at the production widths (``sharding.heads_split``).

The gloo ranks run as ``python tests/test_torch_tp.py tp <dir>``
through ``test_torch_spmd``'s job runner.

    PYTHONPATH=src python -m pytest -q tests/test_torch_tp.py
"""
import json
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_spmd as spmd  # noqa: E402

TOL = 1e-4               # float32: x max|want|
B, S, CAP = 4, 12, 16    # rows, prompt, cache capacity (4 divides it)
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# (case, arch, cfg changes, packed)
CASES = [("qwen", "qwen1.5-0.5b", {}, False),
         ("internlm2", "internlm2-20b", {}, False),
         ("recurrentgemma", "recurrentgemma-2b", {"num_layers": 8}, False),
         ("falcon-mamba", "falcon-mamba-7b", {}, False),
         ("whisper", "whisper-large-v3", {}, False),
         ("qwen-packed-int8", "qwen1.5-0.5b", {"kv_cache_dtype": "int8"},
          True)]
# the loss's (vocab, width, chunk): a small one, and qwen1.5-0.5b's
# padded vocab and logits chunk (at 2 model ranks a block of 75,968 rows
# in 10 chunks of 7,597, its last padded by 2 rows)
LOSS_CASES = {"small": (200, 16, 16), "qwen-vocab": (151936, 8, 8192)}


def cfg_of(arch, **kw):
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch(arch)).replace(dtype="float32", **kw)


def np_tree(tree):
    """A reference tree with numpy leaves (``params_from_numpy``'s
    form; a PackedArray as its words dict)."""
    from repro.kernels.packed import PackedArray as JPacked
    if isinstance(tree, JPacked):
        return {"words": np.asarray(tree.words), "length": tree.length,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


def inputs(cfg, seed=7):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 2)
                                  ).astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision_patches":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def job_reference(out):
    """The reference's reduced params (packed where the case packs),
    prefill logits and one decode step's logits, per case."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import models as jM
    from repro.models.quantize import pack_model_params
    ref = {}
    for case, arch, kw, packed in CASES:
        cfg = jconfigs.reduced(jconfigs.get_arch(arch)).replace(
            dtype="float32", **kw)
        params = jM.init_params(jax.random.PRNGKey(0), cfg)
        if packed:
            params = pack_model_params(params)
        inp = inputs(cfg)
        batch = {k: jnp.asarray(v) for k, v in inp.items()}
        pre = dict(batch, tokens=batch["tokens"][:, :S])
        logits0, caches = jM.prefill(params, cfg, pre, cache_capacity=CAP)
        dec, _ = jM.decode_step(params, cfg, {
            "tokens": batch["tokens"][:, S:S + 1],
            "step": jnp.full((B,), S, jnp.int32), "caches": caches})
        ref[case] = dict(params=np_tree(params), inputs=inp,
                         prefill=np.asarray(logits0),
                         decode=np.asarray(dec))
    with open(os.path.join(out, "reference.pkl"), "wb") as f:
        pickle.dump(ref, f)


# ------------------------------------------------------------------ #
# the gloo ranks                                                       #
# ------------------------------------------------------------------ #
def _err(got, want):
    """max |got - want| / max |want| (0 for equal integers)."""
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double()
    assert got.shape == want.shape, (tuple(got.shape), tuple(want.shape))
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def boundary_rows(v, m):
    """Every model rank's first three and last vocab rows of a
    ``v``-row vocab on ``m`` ranks (the rows next to a rank's padded
    last chunk), and the vocab's first and last."""
    n = v // m
    rows = {0, v - 1}
    for k in range(m):
        rows |= {k * n, k * n + 1, k * n + 2, (k + 1) * n - 1}
    return sorted(rows)


def _loss_report(dm, v, d, chunk):
    """The vocab-parallel loss and embedding on ``dm``'s model ranks
    against the one-process versions (every rank computes both), the
    targets holding every ``boundary_rows``."""
    from repro_torch.models import layers as L
    from repro_torch.runtime import sharding as shd
    groups = shd.tp_groups(dm)
    m, r = groups.model_size, groups.model_rank
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((2, 10, d))
                          .astype(np.float32))
    emb0 = torch.from_numpy(
        rng.standard_normal((v, d)).astype(np.float32) * 0.5)
    tgt = torch.from_numpy(rng.integers(0, v, (2, 10)))
    rows = boundary_rows(v, m)
    tgt.view(-1)[:len(rows)] = torch.tensor(rows)
    wts = torch.from_numpy(rng.standard_normal((2, 10)).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((2, 10, d))
                          .astype(np.float32))
    n = v // m
    out = {}

    def run(fn, tp):
        x = x0.clone().requires_grad_(True)
        emb = (emb0[r * n:(r + 1) * n] if tp else emb0).clone() \
            .requires_grad_(True)
        with shd.tensor_parallel(groups if tp else None):
            y = fn(x, emb)
            w = up if y.ndim == 3 else wts
            (y * w).sum().backward()
        g = emb.grad if tp else emb.grad[r * n:(r + 1) * n]
        return y.detach(), x.grad, g
    fns = {
        "chunked_xent": lambda x, e: L.chunked_xent(x, e, tgt, True, chunk,
                                                    vocab=v),
        "vocab_parallel_nll": lambda x, e: (
            L.vocab_parallel_nll(x, e, tgt) if e.shape[0] < v
            else L.chunked_xent(x, e, tgt, True, v)),
        "embed_lookup": lambda x, e: L.embed_lookup(e, tgt, v) + 0 * x,
    }
    for name, fn in fns.items():
        got, want = run(fn, True), run(fn, False)
        out[name] = [_err(a, b) for a, b in zip(got, want)]
        out[name + "_finite"] = all(bool(torch.isfinite(t).all())
                                    for t in got)
    # the padded last chunk of the rank's block
    out["pads"] = (n % -(-n // chunk)) != 0
    out["targets"] = sorted(set(tgt.view(-1).tolist()) & set(rows))
    return out


def _blocks_of(whole, specs, dm):
    """Every leaf of ``whole`` cut to this rank's block by ``specs``."""
    from repro_torch import tree
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime import sharding as shd
    shape = tuple(dm.shape)
    slots = Mesh(np.array([torch.device("cpu")] * dm.size(), dtype=object)
                 .reshape(shape), dm.mesh_dim_names)
    me = int(np.ravel_multi_index(dm.get_coordinate(), shape))

    def one(t, spec):
        block = shd.NamedSharding(slots, spec).blocks(t.shape)[me]
        return t[tuple(slice(a, b) for a, b in block)]
    return tree.map(one, whole, specs, is_leaf=lambda s: isinstance(s, shd.P))


def _serve_report(dm, ref):
    """Each case's mesh prefill, decode and second decode on ``dm``
    against the one-process port and the reference."""
    from repro_torch import tree
    from repro_torch.configs import ShapeConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import rules_mesh
    from repro_torch.models import model as M
    from repro_torch.runtime import sharding as shd
    out = {}
    shard, n_shards = shd.batch_shard(dm)
    mine = slice(shard * B // n_shards, (shard + 1) * B // n_shards)
    for case, arch, kw, packed in CASES:
        cfg = cfg_of(arch, **kw)
        r = ref[case]
        params = params_from_numpy(r["params"], "cpu")
        variant = "packed" if packed else "baseline"
        toks = torch.from_numpy(r["inputs"]["tokens"]).long()
        pre = {k: torch.from_numpy(v) for k, v in r["inputs"].items()}
        pre["tokens"] = toks[:, :S]
        one_logits, one_caches = M.prefill(params, cfg, pre,
                                           cache_capacity=CAP)
        fn, args = dryrun.place_cell(
            cfg, ShapeConfig("p", CAP, B, "prefill"), variant, dm, params,
            pre)
        logits, caches = fn(*args)
        rep = {"prefill_port": _err(logits, one_logits[mine]),
               "prefill_ref": _err(logits, r["prefill"][mine])}

        def cache_errs(got, want, name):
            """``got`` (the rank's caches) against its blocks of the
            one-process caches ``want`` (all rows)."""
            specs = shd.batch_specs({"caches": want}, rules_mesh(dm))
            blocks = _blocks_of(want, specs["caches"], dm)
            errs, bad = [], []
            for (path, g), w in zip(tree.flatten_with_path(got)[0],
                                    tree.leaves(blocks)):
                if tuple(g.shape) != tuple(w.shape):
                    bad.append(f"{path}: {tuple(g.shape)} vs "
                               f"{tuple(w.shape)}")
                else:
                    errs.append(_err(g, w))
            rep[name] = dict(err=max(errs), bad=bad,
                             split=sum(g.numel() < w.numel() for g, w in
                                       zip(tree.leaves(got),
                                           tree.leaves(want))))
        cache_errs(caches, one_caches, "prefill_caches")
        dec = {"tokens": toks[:, S:S + 1],
               "step": torch.full((B,), S, dtype=torch.int32),
               "caches": one_caches}
        one_dec, one_new = M.decode_step(params, cfg, dec)
        shape = ShapeConfig("d", CAP, B, "decode")
        fn, args = dryrun.place_cell(cfg, shape, variant, dm, params, dec)
        logits, new = fn(*args)
        rep["decode_port"] = _err(logits, one_dec[mine])
        rep["decode_ref"] = _err(logits, r["decode"][mine])
        cache_errs(new, one_new, "decode_caches")
        # a second step from the mesh's own cache blocks
        dec2 = {"tokens": toks[:, S + 1:S + 2],
                "step": torch.full((B,), S + 1, dtype=torch.int32),
                "caches": one_new}
        one_dec2, _ = M.decode_step(params, cfg, dec2)
        logits2, _ = fn(args[0], dict(args[1], tokens=toks[mine, S + 1:S + 2],
                                      step=dec2["step"][mine], caches=new))
        rep["decode2_port"] = _err(logits2, one_dec2[mine])
        out[case] = rep
    return out


def job_tp(rank, where):
    import torch.distributed as dist
    spmd._join(rank, 4, where, "tp")
    with open(os.path.join(where, "reference.pkl"), "rb") as f:
        ref = pickle.load(f)
    result = {}
    for key, shape in MESHES.items():
        dm = spmd._mesh(shape)
        result[key] = dict(
            loss={case: _loss_report(dm, *loss)
                  for case, loss in LOSS_CASES.items()},
            serve=_serve_report(dm, ref))
    with open(os.path.join(where, f"tp{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


# ------------------------------------------------------------------ #
# the tests                                                            #
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    where = tmp_path_factory.mktemp("tp")
    spmd.run("job reference", [sys.executable, os.path.abspath(__file__),
                               "reference", str(where)])
    spmd.run("job tp", [sys.executable, os.path.abspath(__file__), "tp",
                        str(where)])
    return [json.load(open(where / f"tp{r}.json")) for r in range(4)]


@pytest.mark.parametrize("loss", list(LOSS_CASES))
@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ["chunked_xent", "vocab_parallel_nll",
                                  "embed_lookup"])
def test_vocab_parallel_equals_one_process(gloo, key, name, loss):
    """The value, the gradient of x and of the rank's vocab block, all
    finite, with a target on every rank's first and last rows."""
    v = LOSS_CASES[loss][0]
    for r, result in enumerate(gloo):
        rep = result[key]["loss"][loss]
        assert rep[name + "_finite"], (r, name)
        assert not max(rep[name]) > 1e-5, (r, name, rep[name])
        assert rep["targets"] == boundary_rows(v, MESHES[key][-1])
        if name == "chunked_xent":
            assert rep["pads"], "no padded chunk"


CASE_IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_prefill_and_decode_equal_one_process_and_reference(
        gloo, key, case):
    for r, result in enumerate(gloo):
        rep = result[key]["serve"][case]
        for name in ("prefill_port", "prefill_ref", "decode_port",
                     "decode_ref", "decode2_port"):
            assert rep[name] <= TOL, (r, name, rep[name])


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_caches_are_their_batch_specs_blocks(gloo, key, case):
    """Every cache leaf a rank returns has its ``batch_specs`` block's
    shape and values; some leaf is split over the mesh."""
    for r, result in enumerate(gloo):
        for name in ("prefill_caches", "decode_caches"):
            rep = result[key]["serve"][case][name]
            assert rep["bad"] == [], (r, name, rep["bad"])
            assert rep["err"] <= TOL, (r, name, rep["err"])
            assert rep["split"] > 0, (r, name)


def _at_rank(size, rank):
    from repro_torch.runtime import sharding as shd
    return shd.TPGroups(None, size, rank, None, 1, None, 1, None, 1)


@pytest.mark.parametrize("k,m", [(80, 3), (96, 3), (200, 7)])
def test_packed_row_block_keeps_its_bits(k, m):
    """A "model" block of words along the pack axis (K/32 words split
    m ways) has the block's bits as its length: the last block ends at
    K, its pad bits past it and 0; the unpacked blocks stack to the
    whole weight's rows."""
    from repro_torch.kernels.packed import PackedArray
    from repro_torch.runtime import sharding as shd
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.standard_normal((k, 8)).astype(np.float32))
    pa = PackedArray.pack(w, axis=-2)
    n_words = pa.words.shape[0]
    assert n_words % m == 0
    per = n_words // m
    rows = []
    for r in range(m):
        blk = shd.Block(pa.with_words(pa.words[r * per:(r + 1) * per]),
                        model_dim=0, data_dim=None, whole=False)
        with shd.tensor_parallel(_at_rank(m, r)):
            got = shd.materialize(blk)
        assert got.length == min(k, (r + 1) * per * 32) - r * per * 32
        rows.append(got.unpack(torch.float32))
    whole = pa.unpack(torch.float32)
    assert torch.equal(torch.cat(rows), whole)
    pad = n_words * 32 - k
    if pad:
        last = pa.words[-1].view(torch.int32).numpy().view(np.uint32)
        assert np.all(last >> np.uint32(32 - pad) == 0)


@pytest.mark.parametrize("k,m", [(96, 4), (80, 2), (2816, 16)])
def test_own_rows_of_whole_words(k, m):
    """Row-parallel from words held whole over "model": each rank's rows
    (not word-aligned) equal those rows of the unpacked weight."""
    from repro_torch.kernels.packed import PackedArray
    from repro_torch.models.layers import own_rows
    from repro_torch.runtime import sharding as shd
    w = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (k, 5)).astype(np.float32))
    pa = PackedArray.pack(w, axis=-2)
    whole = pa.unpack(torch.float32)
    n = k // m
    for r in range(m):
        with shd.tensor_parallel(_at_rank(m, r)):
            got = own_rows(pa, n, torch.float32)
        assert torch.equal(got, whole[r * n:(r + 1) * n])


@pytest.mark.parametrize("arch,want", [
    ("qwen1.5-0.5b", (True, True)), ("mixtral-8x22b", (True, False)),
    ("internlm2-20b", (True, False)), ("command-r-35b", (True, False)),
    ("recurrentgemma-2b", (False, False)),
    ("whisper-large-v3", (False, False))])
def test_heads_split_at_16_model_ranks(arch, want):
    """q heads go over 16 ranks where they divide and a rank's q heads
    read one kv head (mixtral's 48 / 8: 3 q heads a rank, 6 a kv head);
    kv heads where they divide too; recurrentgemma's 10 heads and
    whisper's 20 compute whole; one model rank splits nothing."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime import sharding as shd
    cfg = get_arch(arch)
    assert shd.heads_split(cfg, 16) == want
    assert shd.heads_split(cfg, 1) == (False, False)
    assert shd.computes_on_block("decoder/layers/0/attn/wq", cfg, 16) \
        == want[0]
    assert shd.computes_on_block("decoder/layers/0/attn/wk", cfg, 16) \
        == want[1]
    assert shd.computes_on_block("embed", cfg, 16)
    assert not shd.computes_on_block("decoder/layers/0/norm1/scale", cfg,
                                     16)


def test_world_of_one_helpers_are_the_identity():
    """With one rank on every axis each helper returns its input itself
    (no op runs), and a Block materialises to its local tensor."""
    from repro_torch.runtime import sharding as shd
    x = torch.randn(3, 4, requires_grad=True)
    with shd.tensor_parallel(_at_rank(1, 0)):
        assert shd.copy_to_model(x) is x
        assert shd.reduce_from_model(x) is x
        assert shd.max_over_model(x) is x
        assert shd.gather_from_model(x, 1) is x
        assert shd.materialize(shd.Block(x, 0, 1, True)) is x


if __name__ == "__main__":
    job, where = sys.argv[1], sys.argv[2]
    if job == "reference":
        job_reference(where)
    elif job == "tp":
        spmd._spawn(job_tp, 4, where)
    else:
        raise SystemExit(f"unknown job {job}")
    sys.exit(0)
