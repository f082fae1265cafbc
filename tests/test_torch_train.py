"""The port's train -> fold -> compile -> serve loop, against the
reference and on its own.

At the reference's tiny sizes (tests/test_train.py: 4x4x2 images of 4
classes, the ``t-mlp`` dense stack and the ``t-conv`` spec with a float
entry conv, a binary conv, a MaxPool and a head), with the reference's
initial state carried across by ``params_from_numpy``:

* ``init_train_state``: the reference's tree, shapes and dtypes;
* ``train_forward`` in eval: logits exactly equal, both specs; in
  train mode: logits and the new BN statistics within rtol 1e-5;
* one step's loss within 1e-5 and every gradient leaf within
  1e-4 * max|g| of ``jax.value_and_grad`` of the reference's loss
  (the conv spec's MaxPool runs on +-1 activations, whose windows tie:
  both send the gradient to the first maximum of a window, or the
  conv's weight gradients would differ);
* ``export_serving_params`` on a state the reference trained: words
  and thresholds equal.

The train-mode comparisons start from a trained-like BN state (see
``_ref_state``): at init a BN output is exactly 0 wherever a sum equals
its batch mean, and such a tie's sign follows float rounding that the
two packages do in different orders.

On the port alone: ``fit`` learns the separable task, a resumed run is
bit-identical to the uninterrupted one, ``check_sign_identity`` and
``BNNServer.apply_batch`` on the exported checkpoint equal the eval
forward exactly, and every entry point with ``device=None`` raises on a
host without CUDA.  The tests marked ``gpu`` (skipped here) hold the
same on the card, through the port's kernels, plus two identical steps
giving identical bits and one step's gradients on the card against the
CPU's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import graph as jgraph  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.data import ImageDataConfig as JData  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro.train.loop import _loss as jloss  # noqa: E402
from repro.train.loop import _model_input as jinput  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch import train, tree  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import ImageDataConfig  # noqa: E402
from repro_torch.data.images import eval_batch_at, image_batch_at  # noqa
from repro_torch.kernels.packed import as_uint32  # noqa: E402
from repro_torch.serving import BNNServer  # noqa: E402
from repro_torch.train.export import _serving_input  # noqa: E402
from repro_torch.train.loop import loss_and_grads  # noqa: E402

DATA = dict(num_classes=4, height=4, width=4, channels=2, global_batch=16,
            seed=1, flip_prob=0.02)
DCFG = ImageDataConfig(**DATA)
QUIET = dict(log_fn=lambda *_: None)


def _mlp(g):
    return g.from_dense_stack(DCFG.n_pixels, [64, DCFG.num_classes],
                              logits=True, name="t-mlp")


def _conv(g):
    return g.BNNSpec(
        name="t-conv", input_shape=(4, 4, 2),
        nodes=(g.IntegerEntry("c0", 3, 3, 2, 8, 4, 4, 4, 4, stride=1,
                              pad=1),
               g.Binarize("b0"),
               g.BinaryConv("c1", 3, 3, 8, 32, 4, 4, 4, 4, stride=1, pad=1),
               g.BNThreshold("t1", channels=32),
               g.MaxPool("p1", window=2, stride=2),
               g.BinaryDense("fc", n_in=2 * 2 * 32, n_out=DCFG.num_classes),
               g.Logits("out", classes=DCFG.num_classes)))


SPECS = {"mlp": _mlp, "conv": _conv}


def _ref_state(name, seed=0, trained=False):
    """The reference's initial (params, bn) for a spec, and the port's
    copy of it.  ``trained`` replaces BN's gamma, beta and running
    statistics by random values (a state some steps into training), the
    same on both sides.  At init (gamma 1, beta 0) a training-mode BN
    output is exactly 0 wherever a sum equals its batch mean, and the
    sign of such a tie follows the float rounding of the mean and of
    alpha = mean |w|, which XLA and torch sum in different orders; with
    a random beta a tie has probability ~0."""
    params, bn = jtrain.init_train_state(jax.random.PRNGKey(seed),
                                         SPECS[name](jgraph))
    params, bn = jax.tree.map(np.asarray, (params, bn))
    if trained:
        rng = np.random.default_rng(seed)
        for p, b in zip(params["conv"] + params["fc"],
                        bn["conv"] + bn["fc"]):
            if "gamma" in p:
                n = p["gamma"].shape
                p["gamma"] = rng.choice([-1.0, 1.0], n).astype(np.float32) \
                    * rng.uniform(0.5, 1.5, n).astype(np.float32)
                p["beta"] = rng.normal(0, 0.5, n).astype(np.float32)
                b["mu"] = rng.normal(0, 0.1, n).astype(np.float32)
                b["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return jax.tree.map(jnp.asarray, (params, bn)), \
        params_from_numpy((params, bn), "cpu")


def _images(name, step=0):
    b = image_batch_at(DCFG, step)
    x = b["image"]
    if name == "mlp":
        x = x.reshape(x.shape[0], -1)
    return x, b["label"]


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_init_train_state_matches_reference_tree(name):
    (jparams, jbn), _ = _ref_state(name)
    params, bn = train.init_train_state(torch.Generator().manual_seed(0),
                                        SPECS[name](tgraph), device="cpu")
    assert tree.flatten((params, bn))[1] == \
        tree.flatten(jax.tree.map(np.asarray, (jparams, jbn)))[1]
    for a, b in zip(tree.leaves((params, bn)),
                    jax.tree.leaves((jparams, jbn))):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    for p in params["conv"] + params["fc"]:       # N(0, 1) / sqrt(fan_in)
        fan_in = int(np.prod(p["w"].shape[:-1])) if p["w"].ndim == 4 \
            else p["w"].shape[1]
        assert 0.5 < float(p["w"].std()) * fan_in ** 0.5 < 1.5
    mask = train.clip_mask_for(params)
    assert tree.flatten(mask)[1] == tree.flatten(params)[1]
    if name == "conv":
        assert mask["conv"][1] == {"w": True, "gamma": False, "beta": False}
        assert bn["conv"][0] == {} and mask["fc"][0] == {"w": True}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_train_forward_matches_reference(name):
    """Eval logits exactly equal (integer dots behind +-1 signs), at
    init and from a trained-like state; train mode (from the
    trained-like state): logits and the new running statistics within
    rtol 1e-5."""
    (jparams, jbn), (params, bn) = _ref_state(name)
    spec_j, spec_t = SPECS[name](jgraph), SPECS[name](tgraph)
    x, _ = _images(name, 3)
    jl, _ = jtrain.train_forward(spec_j, jparams, jbn, jnp.asarray(x),
                                 train=False)
    tl, _ = train.train_forward(spec_t, params, bn, torch.from_numpy(x),
                                train=False)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    (jparams, jbn), (params, bn) = _ref_state(name, trained=True)
    jl, _ = jtrain.train_forward(spec_j, jparams, jbn, jnp.asarray(x),
                                 train=False)
    tl, _ = train.train_forward(spec_t, params, bn, torch.from_numpy(x),
                                train=False)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    jl, jnew = jtrain.train_forward(spec_j, jparams, jbn, jnp.asarray(x),
                                    train=True)
    tl, tnew = train.train_forward(spec_t, params, bn, torch.from_numpy(x),
                                   train=True)
    _close(tl.detach(), jl)
    for a, b in zip(tree.leaves(tnew), jax.tree.leaves(jnew)):
        _close(a, b)
    # the float32-latent twin: the same graph through tanh
    jl, _ = jtrain.train_forward(spec_j, jparams, jbn, jnp.asarray(x),
                                 train=False, binarize=False)
    tl, _ = train.train_forward(spec_t, params, bn, torch.from_numpy(x),
                                train=False, binarize=False)
    _close(tl, jl, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_one_step_loss_and_grads_match_reference(name):
    """From the trained-like state: loss within 1e-5, every gradient
    leaf within 1e-4 * max|g| of the reference's, and the new BN
    statistics within rtol 1e-5."""
    (jparams, jbn), (params, bn) = _ref_state(name, seed=2, trained=True)
    spec_j, spec_t = SPECS[name](jgraph), SPECS[name](tgraph)
    b = image_batch_at(DCFG, 5)
    scale = jtrain.default_logit_scale(spec_j)
    assert train.default_logit_scale(spec_t) == scale

    def loss_fn(p):
        logits, new_bn = jtrain.train_forward(
            spec_j, p, jbn, jinput(spec_j, jnp.asarray(b["image"])),
            train=True)
        return jloss(logits, jnp.asarray(b["label"]), scale)[0], new_bn

    (jce, jnew), jg = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    ce, acc, tnew, grads = loss_and_grads(
        spec_t, params, bn, torch.from_numpy(b["image"]),
        torch.from_numpy(b["label"]), scale)
    assert abs(float(ce) - float(jce)) <= 1e-5
    assert 0.0 <= float(acc) <= 1.0
    assert tree.flatten(grads)[1] == tree.flatten(params)[1]
    for got, want in zip(tree.leaves(grads), jax.tree.leaves(jg)):
        want = np.asarray(want)
        tol = 1e-4 * max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    for a, w in zip(tree.leaves(tnew), jax.tree.leaves(jnew)):
        _close(a, w)


@pytest.fixture(scope="module")
def ref_trained():
    """A short reference training run per spec (the jitted step
    dominates these tests' time: shared)."""
    out = {}
    for name in SPECS:
        r = jtrain.fit(SPECS[name](jgraph), JData(**DATA),
                       jtrain.TrainConfig(steps=6, lr=0.05), **QUIET)
        out[name] = jax.tree.map(np.asarray, (r["params"], r["bn"]))
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_export_matches_reference(ref_trained, name):
    """On the state the reference trained: every packed word and folded
    threshold equal, the entry conv's float weights too; its alpha
    (mean |w|, summed in another order) within rtol 1e-6."""
    jparams, jbn = ref_trained[name]
    params, bn = params_from_numpy((jparams, jbn), "cpu")
    want = jtrain.export_serving_params(SPECS[name](jgraph), jparams, jbn)
    got = train.export_serving_params(SPECS[name](tgraph), params, bn)
    jflat = jax.tree.leaves(want, is_leaf=lambda v: isinstance(v, JPacked))
    tflat = tree.leaves(got)
    assert len(tflat) == len(jflat)
    for a, b in zip(tflat, jflat):
        if isinstance(b, JPacked):
            assert (a.length, a.axis) == (b.length, b.axis)
            np.testing.assert_array_equal(as_uint32(a.words),
                                          np.asarray(b.words))
        elif a.dtype == torch.float32 and a.ndim == 1:       # alpha
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fit_learns_and_serves_the_export_exactly(name):
    """The separable task trains past 0.5 (chance 0.25); the exported
    checkpoint's compiled forward and BNNServer both equal the eval
    forward exactly."""
    spec = SPECS[name](tgraph)
    out = train.fit(spec, DCFG, train.TrainConfig(steps=30, lr=0.05),
                    device="cpu", **QUIET)
    assert len(out["losses"]) == 30
    assert out["losses"][-1] < out["losses"][0]
    ev = train.evaluate(spec, out["params"], out["bn"], DCFG, n_batches=2,
                        device="cpu")
    assert ev["acc"] > 0.5 and ev["rows"] == 32
    twin = train.evaluate(spec, out["params"], out["bn"], DCFG,
                          n_batches=1, binarize=False, device="cpu")
    assert np.isfinite(twin["loss"]) and 0.0 <= twin["acc"] <= 1.0
    x, _ = _images(name, 0)
    x = eval_batch_at(DCFG, 0)["image"].reshape(x.shape)
    stats = train.check_sign_identity(spec, out["params"], out["bn"], x,
                                      device="cpu")
    assert stats == {"rows": 16, "argmax_agreement": 1.0,
                     "max_abs_logit_delta": 0.0}
    cb, sparams = train.export_compiled(spec, out["params"], out["bn"],
                                        batch=16, device="cpu")
    assert cb.backend == "cuda"     # the kernels' plain versions on the CPU
    xt = torch.from_numpy(x)
    want, _ = train.train_forward(spec, out["params"], out["bn"], xt,
                                  train=False)
    srv = BNNServer(cb, sparams, max_batch=16, device="cpu")
    got = srv.apply_batch(_serving_input(spec, xt, cb.backend))
    assert torch.equal(got.to(torch.float32), want)


def _leaves_equal(a, b):
    fa, ta = tree.flatten(a)
    fb, tb = tree.flatten(b)
    return ta == tb and all(x.dtype == y.dtype and torch.equal(x, y)
                            for x, y in zip(fa, fb))


def _resume_matches(spec, tmp_path, device):
    tcfg = train.TrainConfig(steps=8, lr=0.05, ckpt_every=3, log_every=100)
    full = train.fit(spec, DCFG, tcfg, device=device, **QUIET)
    d = str(tmp_path / "ckpt")
    part1 = train.fit(spec, DCFG, tcfg, ckpt_dir=d, run_steps=4,
                      device=device, **QUIET)
    assert part1["step"] == 4 and part1["losses"] == full["losses"][:4]
    part2 = train.fit(spec, DCFG, tcfg, ckpt_dir=d, device=device, **QUIET)
    assert part2["step"] == 8 and part2["losses"] == full["losses"][4:]
    assert _leaves_equal((part2["params"], part2["bn"], part2["opt"]),
                         (full["params"], full["bn"], full["opt"]))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_resume_is_bit_identical_to_uninterrupted(name, tmp_path):
    _resume_matches(SPECS[name](tgraph), tmp_path, "cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """device=None means "cuda": on a host without one, every entry
    point raises (no silent CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _mlp(tgraph)
    params, bn = train.init_train_state(torch.Generator().manual_seed(0),
                                        spec, device="cpu")
    x = _images("mlp")[0]
    calls = [lambda: train.fit(spec, DCFG, train.TrainConfig(steps=1),
                               **QUIET),
             lambda: train.evaluate(spec, params, bn, DCFG, n_batches=1),
             lambda: train.init_train_state(torch.Generator(), spec),
             lambda: train.export_compiled(spec, params, bn),
             lambda: train.check_sign_identity(spec, params, bn, x)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------------------------ #
# on the card                                                          #
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SPECS))
def test_gpu_fit_export_serve_exact(cuda, name, tmp_path):
    """Trained on the card, exported on the "cuda" backend: the compiled
    forward (the port's kernels) and BNNServer (a CUDA graph) equal the
    eval forward exactly; the resumed run is bit-identical."""
    from repro_torch.kernels import _build
    spec = SPECS[name](tgraph)
    out = train.fit(spec, DCFG, train.TrainConfig(steps=20, lr=0.05),
                    device=cuda, **QUIET)
    assert out["params"]["fc"][0]["w"].device.type == "cuda"
    x = torch.from_numpy(eval_batch_at(DCFG, 0)["image"]).to(cuda)
    x = x.reshape(_images(name)[0].shape)
    _build.reset_launch_counts()
    stats = train.check_sign_identity(spec, out["params"], out["bn"], x)
    assert stats["max_abs_logit_delta"] == 0.0
    assert sum(_build.launch_counts().values()) > 0
    cb, sparams = train.export_compiled(spec, out["params"], out["bn"],
                                        batch=16)
    want, _ = train.train_forward(spec, out["params"], out["bn"], x,
                                  train=False)
    srv = BNNServer(cb, sparams, max_batch=16)
    got = srv.apply_batch(_serving_input(spec, x, cb.backend))
    assert torch.equal(got.to(torch.float32), want.detach())
    _resume_matches(spec, tmp_path, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SPECS))
def test_gpu_step_deterministic_and_close_to_cpu(cuda, name):
    """Two identical steps on the card give identical bits; the card's
    gradients are within 1e-4 * max|g| of the CPU's (the MaxPool's tie
    rule included) and its loss within 1e-5."""
    _, (params, bn) = _ref_state(name, seed=4, trained=True)
    spec = SPECS[name](tgraph)
    b = image_batch_at(dataclasses.replace(DCFG, global_batch=64), 2)
    scale = train.default_logit_scale(spec)
    cfg = train.TrainConfig(steps=4)
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(lr=0.05, total_steps=4, warmup_steps=1,
                                weight_decay=cfg.weight_decay,
                                clip_norm=cfg.clip_norm)
    step = train.make_train_step(spec, opt_cfg, scale)
    on = [tree.map(lambda t: t.to(cuda), s) for s in (params, bn)]
    images = torch.from_numpy(b["image"])
    labels = torch.from_numpy(b["label"])
    runs = [step(*on, adamw.init(on[0]), images.to(cuda), labels.to(cuda))
            for _ in range(2)]
    assert _leaves_equal(runs[0][:3], runs[1][:3])
    assert float(runs[0][3]["loss"]) == float(runs[1][3]["loss"])
    ce_c, _, _, g_c = loss_and_grads(spec, *on, images.to(cuda),
                                     labels.to(cuda), scale)
    ce, _, _, g = loss_and_grads(spec, params, bn, images, labels, scale)
    assert abs(float(ce_c) - float(ce)) <= 1e-5
    for got, want in zip(tree.leaves(g_c), tree.leaves(g)):
        tol = 1e-4 * max(float(want.abs().max()), 1e-12)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=0, atol=tol)
