"""The port's LLM training path against the reference's.

* The token stream: ``global_batch_at``, ``shard_batch_at`` and a
  resumed ``DataIterator`` equal ``repro.data``'s bit for bit.
* Gradient compression: ``quantize_int8``'s q / scale / err and
  ``compressed_psum``'s output and error equal the reference's bit for
  bit (the reference under ``shard_map`` on a one-device mesh), float32
  and bfloat16, 513 and 4096 elements; with an initialised
  ``torch.distributed`` group of two (gloo, two processes) the int32
  payloads and the scales are summed across it.
* ``chunked_xent`` against the reference's and the unchunked loss,
  values and gradients, at chunks that do and do not divide the vocab.
* ``remat`` "full" and "dots" give the grads of "none" bit for bit, on
  all ten reduced architectures.
* ``train``: a kill-and-resume equals the port's own uninterrupted run
  bit for bit (the reference's own test of this fails on the CPU,
  ROADMAP hazard 6); the CLI with ``--device cpu``; a ``mesh`` that is
  not a ``DeviceMesh``, of another device type or whose batch axes do
  not divide the global batch, and ``device=None`` without a card,
  raise.  SPMD training over a mesh is ``tests/test_torch_spmd.py``.

``loss_fn`` and one train step against the reference's, per
architecture, are in ``tests/test_torch_llm_loss.py`` (they share these
helpers).  The tests marked ``gpu`` (skipped here) hold one step on the
card against the CPU's and the resume on the card.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime import compression as tcomp  # noqa: E402

ARCH_IDS = list(jconfigs.ARCHS)
LOSS_TOL = 1e-5      # float32 loss, relative
GRAD_TOL = 1e-4      # float32 gradients: x max|g| of each leaf
B, S = 2, 16
TOPT = tadamw.AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=2)


# ------------------------------------------------------------------ #
# helpers                                                              #
# ------------------------------------------------------------------ #
def np_tree(t):
    return jax.tree.map(np.asarray, t)


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def bits(x):
    """The bit pattern of a float array (bf16 widened exactly)."""
    a = to_np(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def leaf_pairs(port, ref):
    """(i, port leaf, reference leaf) in jax's leaf order."""
    fp = tree.leaves(port)
    fr = jax.tree.leaves(ref)
    assert len(fp) == len(fr) > 0
    return list(enumerate(zip(fp, fr)))


def assert_close(what, got, want, tol):
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale:.3g}"


def cfgs(arch, chunk=0, **kw):
    cj = jconfigs.reduced(jconfigs.get_arch(arch)).replace(
        dtype="float32", logits_chunk=chunk, **kw)
    ct = tconfigs.reduced(tconfigs.get_arch(arch)).replace(
        dtype="float32", logits_chunk=chunk, **kw)
    return cj, ct


def batch_np(cfg, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision_patches":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def to_port(batch, device="cpu"):
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out["tokens"], out["targets"] = out["tokens"].long(), \
        out["targets"].long()
    return out


# ------------------------------------------------------------------ #
# the token stream                                                     #
# ------------------------------------------------------------------ #
DATA_CFGS = [dict(vocab_size=997, seq_len=16, global_batch=8, seed=3),
             dict(vocab_size=151936, seq_len=64, global_batch=8),
             dict(vocab_size=101, seq_len=12, global_batch=4, seed=7,
                  zipf_alpha=1.3)]


@pytest.mark.parametrize("kw", DATA_CFGS)
def test_token_stream_equals_reference(kw):
    jc, tc = jdata.DataConfig(**kw), tdata.DataConfig(**kw)
    for step in (0, 1, 7, 1000):
        want = jdata.global_batch_at(jc, step)
        got = tdata.global_batch_at(tc, step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        for n in (1, 2, 4):
            for s in range(n):
                w = jdata.shard_batch_at(jc, step, s, n)
                g = tdata.shard_batch_at(tc, step, s, n)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])


def test_resumed_iterator_equals_reference():
    kw = DATA_CFGS[0]
    jit_ = jdata.DataIterator(jdata.DataConfig(**kw), shard=1, n_shards=2)
    tit = tdata.DataIterator(tdata.DataConfig(**kw), shard=1, n_shards=2)
    for _ in range(3):
        np.testing.assert_array_equal(next(tit)["tokens"],
                                      next(jit_)["tokens"])
    st = tit.state_dict()
    assert st == jit_.state_dict()
    # elastic: resumed on one shard, the full global batch of step 3
    t2 = tdata.DataIterator.from_state(tdata.DataConfig(**kw), st, 0, 1)
    j2 = jdata.DataIterator.from_state(jdata.DataConfig(**kw), st, 0, 1)
    for _ in range(2):
        a, b = next(t2), next(j2)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="does not split"):
        tdata.shard_batch_at(tdata.DataConfig(**kw), 0, 0, 3)


# ------------------------------------------------------------------ #
# gradient compression                                                 #
# ------------------------------------------------------------------ #
def _comp_input(n, dtype, seed=0):
    rng = np.random.default_rng(seed + n)
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    x[::97] = 0.0                       # whole-zero runs and ties at 0
    x[5] = 127.5 * np.abs(x).max() / 127.0
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    return jx, tx


@pytest.mark.parametrize("n", [513, 4096])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_quantize_int8_bit_for_bit(n, dtype):
    jx, tx = _comp_input(n, dtype)
    jq, js, je = jcomp.quantize_int8(jx)
    tq, ts, te = tcomp.quantize_int8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bits(ts), bits(js))
    assert te.dtype == tx.dtype and te.shape == tx.shape
    np.testing.assert_array_equal(bits(te), bits(je))
    for chunk in (64, 1000):
        a, b = tcomp.quantize_int8(tx, chunk), jcomp.quantize_int8(jx, chunk)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(bits(x), bits(y))
    got = tcomp.dequantize_int8(tq, ts, tx.shape, tx.dtype)
    want = jcomp.dequantize_int8(jq, js, jx.shape, jx.dtype)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("n", [513, 4096])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_compressed_psum_bit_for_bit(n, dtype):
    from jax import shard_map
    jx, tx = _comp_input(n, dtype, seed=1)
    je0, _ = _comp_input(n, jnp.float32, seed=2)
    je0 = je0 * 1e-3
    te0 = torch.from_numpy(np.array(je0))
    mesh = jax.make_mesh((1,), ("pod",))
    f = shard_map(lambda a, e: jcomp.compressed_psum(a, "pod", e),
                  mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    jout, jerr = f(jx, je0)
    tout, terr = tcomp.compressed_psum(tx, te0)
    assert tout.dtype == {jnp.float32: torch.float32,
                          jnp.bfloat16: torch.float32}[dtype]
    np.testing.assert_array_equal(bits(tout), bits(jout))
    np.testing.assert_array_equal(bits(terr), bits(jerr))
    # the tree form, the error state and the ratio
    g = {"a": tx, "b": [tx[: n // 2]]}
    errs = tcomp.init_error_state(g)
    assert all(e.dtype == torch.float32 and not e.any()
               for e in tree.leaves(errs))
    new_g, new_e = tcomp.compress_tree_psum(g, errs)
    want_a, want_e = tcomp.compressed_psum(tx, torch.zeros(n))
    assert torch.equal(new_g["a"], want_a) and torch.equal(new_e["a"], want_e)
    assert tcomp.compression_ratio() == jcomp.compression_ratio() == 2.0
    assert tcomp.compression_ratio(torch.float32) == \
        jcomp.compression_ratio(jnp.float32) == 4.0


PSUM2 = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.runtime.compression import compressed_psum


    def run(rank, port, out):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        rng = np.random.default_rng(rank)
        x = torch.from_numpy(rng.standard_normal(1500).astype(np.float32))
        e = torch.from_numpy(rng.standard_normal(1500).astype(np.float32)
                             * 1e-3)
        y, err = compressed_psum(x, e)
        np.savez(f"{out}/rank{rank}.npz", x=x.numpy(), e=e.numpy(),
                 y=y.numpy(), err=err.numpy())
        dist.destroy_process_group()


    if __name__ == "__main__":
        torch.set_num_threads(1)
        mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=2)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compressed_psum_over_a_group_of_two(tmp_path):
    """Two gloo processes: each gets sum(q) x mean(scale) / 2 over both
    members' payloads, and its own quantization error."""
    script = tmp_path / "psum2.py"
    script.write_text(PSUM2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run([sys.executable, str(script), str(_free_port()),
                        str(tmp_path)], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    runs = [np.load(tmp_path / f"rank{i}.npz") for i in range(2)]
    qs = [tcomp.quantize_int8(torch.from_numpy(z["x"] + z["e"]))
          for z in runs]
    q32 = sum(q.to(torch.int32) for q, _, _ in qs)
    mean_scale = (qs[0][1] + qs[1][1]) / 2.0
    want = (q32.to(torch.float32) * mean_scale).reshape(-1)[:1500] / 2.0
    for z, (_, _, err) in zip(runs, qs):
        np.testing.assert_array_equal(z["y"].view(np.uint32),
                                      want.numpy().view(np.uint32))
        np.testing.assert_array_equal(z["err"].view(np.uint32),
                                      err.numpy().view(np.uint32))


# ------------------------------------------------------------------ #
# the loss and its gradients                                           #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_grads_bit_identical(arch):
    _, ct = cfgs(arch)
    params = tmodel.init_params(torch.Generator().manual_seed(1), ct, "cpu")
    batch = to_port(batch_np(ct, seed=2))
    base_loss, base = ttrain.loss_and_grads(params, ct, batch)
    for remat in ("full", "dots"):
        loss, grads = ttrain.loss_and_grads(
            params, ct.replace(remat=remat), batch)
        assert torch.equal(loss, base_loss), remat
        for a, b in zip(tree.leaves(grads), tree.leaves(base)):
            assert torch.equal(a, b), remat
    with pytest.raises(ValueError, match="unknown remat"):
        ttrain.loss_and_grads(params, ct.replace(remat="some"), batch)


@pytest.mark.parametrize("arch,bmm_saved", [("qwen1.5-0.5b", False),
                                           ("mixtral-8x22b", True)])
def test_remat_dots_keeps_the_layer_products_only(arch, bmm_saved,
                                                 monkeypatch):
    """"dots" keeps the projections' and MoE's products (mm, bmm) and
    none of an attention q chunk's, which is checkpointed on its own
    (the reference's nested jax.checkpoint hides them from its
    policy)."""
    from repro_torch.models import transformer
    seen = []
    policy = transformer._save_dots

    def record(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        seen.append((str(op), out.name))
        return out
    monkeypatch.setattr(transformer, "_save_dots", record)
    _, ct = cfgs(arch)
    params = tmodel.init_params(torch.Generator().manual_seed(1), ct, "cpu")
    ttrain.loss_and_grads(params, ct.replace(remat="dots"),
                          to_port(batch_np(ct, seed=2)))
    saved = {op for op, d in seen if d == "MUST_SAVE"}
    assert saved and saved <= {"aten.mm.default", "aten.bmm.default",
                               "aten.addmm.default"}
    assert "aten.mm.default" in saved
    assert ("aten.bmm.default" in saved) == bmm_saved
    assert any(op == "aten.bmm.default" and d == "PREFER_RECOMPUTE"
               for op, d in seen)          # the q chunks' products


@pytest.mark.parametrize("V,chunk", [(101, 30), (101, 7), (101, 1000),
                                     (96, 32)])
def test_chunked_xent_matches_reference_and_unchunked(V, chunk):
    rng = np.random.default_rng(V + chunk)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    emb = rng.standard_normal((V, 16)).astype(np.float32)
    tg = rng.integers(0, V, (2, 5)).astype(np.int32)
    tg[0, 0], tg[0, 1] = 0, V - 1       # the first and the last column

    def jnll(xx, ee):
        return jlayers.chunked_xent(xx, ee, jnp.asarray(tg), True, chunk)
    jv = jnll(jnp.asarray(x), jnp.asarray(emb))
    jgx, jge = jax.grad(lambda a, b: jnll(a, b).sum(), (0, 1))(
        jnp.asarray(x), jnp.asarray(emb))
    tx = torch.from_numpy(x).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    tv = tlayers.chunked_xent(tx, te, torch.from_numpy(tg), True, chunk)
    tgx, tge = torch.autograd.grad(tv.sum(), (tx, te))
    assert_close("nll vs reference", tv, jv, 1e-6)
    assert_close("dx vs reference", tgx, jgx, 1e-6)
    assert_close("demb vs reference", tge, jge, 1e-6)
    # against the unchunked loss, with the [D, V] layout too
    logits = tlayers.logits_apply(te, tx, transpose=True)
    full = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.from_numpy(tg).long()[..., None])[..., 0]
    fgx, fge = torch.autograd.grad(full.sum(), (tx, te))
    assert_close("nll vs unchunked", tv, full, 1e-6)
    assert_close("dx vs unchunked", tgx, fgx, 1e-6)
    assert_close("demb vs unchunked", tge, fge, 1e-6)
    with torch.no_grad():
        tr = tlayers.chunked_xent(tx, te.T, torch.from_numpy(tg), False,
                                  chunk)
    assert torch.equal(tr, tv.detach())


# ------------------------------------------------------------------ #
# train: resume, the CLI, the refusals                                 #
# ------------------------------------------------------------------ #
def _resume_cfg():
    return tconfigs.reduced(tconfigs.get_arch("qwen1.5-0.5b")).replace(
        dtype="float32", num_layers=2)


def _resume_matches(tmp_path, device):
    cfg = _resume_cfg()
    kw = dict(steps=6, global_batch=2, seq_len=16, ckpt_every=2,
              device=device, log_fn=lambda *_: None)
    ref = ttrain.train(cfg, **kw)                       # uninterrupted
    d = str(tmp_path / "ck")
    cut = ttrain.train(cfg, ckpt_dir=d, run_steps=3, **kw)  # preempted
    assert len(cut["losses"]) == 3 and cut["losses"] == ref["losses"][:3]
    logs = []
    out = ttrain.train(cfg, ckpt_dir=d, **dict(kw, log_fn=logs.append))
    assert logs[0] == "[resume] from step 3"
    assert out["losses"] == ref["losses"][3:]
    for a, b in zip(tree.leaves((ref["params"], ref["opt_state"])),
                    tree.leaves((out["params"], out["opt_state"]))):
        assert a.device.type == torch.device(device).type
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_resume_bitwise_identical(tmp_path):
    _resume_matches(tmp_path, "cpu")


def test_bf16_train_checkpoints_and_resumes(tmp_path):
    """The published dtype: bf16 params through save and restore."""
    cfg = _resume_cfg().replace(dtype="bfloat16", logits_chunk=200)
    kw = dict(steps=3, global_batch=2, seq_len=8, ckpt_every=1,
              device="cpu", log_fn=lambda *_: None)
    ref = ttrain.train(cfg, **kw)
    d = str(tmp_path / "ck")
    ttrain.train(cfg, ckpt_dir=d, run_steps=2, **kw)
    out = ttrain.train(cfg, ckpt_dir=d, **kw)
    assert ref["params"]["embed"].dtype == torch.bfloat16
    for a, b in zip(tree.leaves(ref["params"]), tree.leaves(out["params"])):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    assert out["losses"][-1] == ref["losses"][-1]


def test_cli_on_the_cpu(capsys):
    out = ttrain.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps",
                       "4", "--batch", "2", "--seq", "8", "--device",
                       "cpu"])
    text = capsys.readouterr().out
    assert "step     0 loss" in text and "step     3 loss" in text
    assert text.strip().splitlines()[-1].startswith("loss ")
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))


def test_refusals():
    """The mesh contract: ``mesh`` is None or a ``DeviceMesh`` (a
    non-mesh raises), of ``device``'s type (None means the card), whose
    batch axes divide the global batch; ``device=None`` without a card
    raises.  The meshes are over torch's fake process group of 4 ranks
    in this process (no collective runs before the refusals)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_process_mesh
    cfg = _resume_cfg()
    kw = dict(steps=1, global_batch=2, seq_len=8, log_fn=lambda *_: None)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttrain.train(cfg, mesh=object(), device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.train(cfg, **kw)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_process_mesh(device="cpu")            # data 4, model 1
        other = "cpu" if mesh.device_type == "cuda" else "cuda"
        with pytest.raises(ValueError, match="device type"):
            ttrain.train(cfg, mesh=mesh, device=other, **kw)
        with pytest.raises(ValueError, match="device type"):
            ttrain.train(cfg, mesh=mesh, **kw)             # None: the card
        with pytest.raises(ValueError, match="does not split"):
            ttrain.train(cfg, mesh=mesh, device="cpu",
                         **dict(kw, global_batch=6))
        with pytest.raises(ValueError, match="does not split"):
            ttrain.train(cfg, mesh=make_process_mesh(model=2, device="cpu"),
                         device="cpu", **dict(kw, global_batch=3))
    finally:
        dist.destroy_process_group()


def test_cublas_config_is_checked(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        ttrain._deterministic_cublas()
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    ttrain._deterministic_cublas()
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"


def test_step_restores_the_global_modes():
    was = torch.are_deterministic_algorithms_enabled()
    cfg = _resume_cfg()
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                                "cpu")
    ttrain.loss_and_grads(params, cfg, to_port(batch_np(cfg)))
    assert torch.are_deterministic_algorithms_enabled() == was


# ------------------------------------------------------------------ #
# on the card                                                          #
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mixtral-8x22b",
                                  "falcon-mamba-7b"])
def test_gpu_step_close_to_cpu_and_repeatable(cuda, arch):
    _, ct = cfgs(arch)
    params = tmodel.init_params(torch.Generator().manual_seed(0), ct, "cpu")
    opt = tadamw.init(params)
    batch = batch_np(ct)
    step = ttrain.make_train_step(ct, TOPT)
    loss_c, grads_c = ttrain.loss_and_grads(params, ct, to_port(batch))
    card = tree.map(lambda t: t.to(cuda), params)
    loss_g, grads_g = ttrain.loss_and_grads(card, ct, to_port(batch, cuda))
    assert abs(float(loss_g) - float(loss_c)) <= LOSS_TOL * abs(float(loss_c))
    for i, (g, w) in enumerate(zip(tree.leaves(grads_g),
                                   tree.leaves(grads_c))):
        assert_close(f"{arch} grad leaf {i}", g, w, GRAD_TOL)
    a = step(card, tree.map(lambda t: t.to(cuda), opt), to_port(batch, cuda))
    b = step(card, tree.map(lambda t: t.to(cuda), opt), to_port(batch, cuda))
    for x, y in zip(tree.leaves(a[:2]), tree.leaves(b[:2])):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_gpu_resume_bitwise_identical(cuda, tmp_path):
    _resume_matches(tmp_path, cuda.type)
