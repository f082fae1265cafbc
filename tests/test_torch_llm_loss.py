"""The port's ``loss_fn`` and train step against the reference's, per
architecture.

For all ten reduced architectures in float32 (B = 2, S = 16, the
reference's params carried across with ``params_from_numpy``):

* ``loss_fn`` within ``LOSS_TOL`` (relative) of
  ``jax.value_and_grad(repro.models.loss_fn)`` and every gradient leaf
  within ``GRAD_TOL`` x max|g| of that leaf; also with the chunked loss
  (``logits_chunk`` = 100, which does not divide the vocab of 512) on
  qwen and on mixtral (with MoE's aux loss);
* one ``make_train_step`` from the converted params and a converted
  ``OptState`` of numpy leaves (step 3, random moments) against the
  reference's step: params, m and v within ``STEP_TOL`` x max|ref|.

The reference's side is the slow part (its jit of value_and_grad), so
it is computed once per architecture and shared by both tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from test_torch_llm_train import (ARCH_IDS, GRAD_TOL,  # noqa: E402
                                  LOSS_TOL, TOPT, assert_close, batch_np,
                                  cfgs, leaf_pairs, np_tree, to_port)

# one AdamW step from the same params and opt state: the gradients'
# GRAD_TOL moves m by (1 - b1) and the update by lr / sqrt(v) of it
STEP_TOL = 1e-5
OPT = jadamw.AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=2)


def opt_np(params, seed=9):
    """A reference OptState of numpy leaves at step 3 with random
    moments (v > 0), so one step exercises every term of the update."""
    rng = np.random.default_rng(seed)
    flat, tdef = jax.tree.flatten(params)
    m = [rng.standard_normal(np.shape(p)).astype(np.float32) * 1e-2
         for p in flat]
    v = [rng.random(np.shape(p)).astype(np.float32) * 1e-3 + 1e-6
         for p in flat]
    return jadamw.OptState(step=np.asarray(3, np.int32),
                           m=jax.tree.unflatten(tdef, m),
                           v=jax.tree.unflatten(tdef, v))


_REF, _PARAMS = {}, {}


def reference(arch, chunk=0):
    """The reference's loss, grads and one train step on a reduced
    arch (computed once per process).  The step is the reference's
    ``make_train_step`` taken in its two parts, each jitted once:
    ``jax.value_and_grad(loss_fn)``, then ``adamw.apply_updates``."""
    key = (arch, chunk)
    if key not in _REF:
        cj, ct = cfgs(arch, chunk)
        if arch not in _PARAMS:      # the reference's eager init is slow
            _PARAMS[arch] = jmodels.init_params(jax.random.PRNGKey(0), cj)
        jparams = _PARAMS[arch]
        b = batch_np(ct)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jopt = opt_np(jparams)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda q: jmodels.loss_fn(q, cj, jb)))(jparams)
        np_, no, met = jax.jit(lambda p, o, g: jadamw.apply_updates(
            p, o, g, OPT))(jparams, jax.tree.map(jnp.asarray, jopt), grads)
        _REF[key] = dict(cfg=ct, batch=b, params=np_tree(jparams),
                         opt=jopt, loss=float(loss), grads=np_tree(grads),
                         new_params=np_tree(np_), new_opt=np_tree(no),
                         metrics=np_tree(met))
    return _REF[key]


# ------------------------------------------------------------------ #
# the loss and its gradients; one step                                 #
# ------------------------------------------------------------------ #
LOSS_CASES = [(a, 0) for a in ARCH_IDS] + [("qwen1.5-0.5b", 100),
                                          ("mixtral-8x22b", 100)]


@pytest.mark.parametrize("arch,chunk", LOSS_CASES,
                         ids=[f"{a}-chunk{c}" for a, c in LOSS_CASES])
def test_loss_and_grads_match_reference(arch, chunk):
    r = reference(arch, chunk)
    params = params_from_numpy(r["params"], "cpu")
    loss, grads = ttrain.loss_and_grads(params, r["cfg"],
                                        to_port(r["batch"]))
    assert abs(float(loss) - r["loss"]) <= LOSS_TOL * abs(r["loss"])
    for i, (g, w) in leaf_pairs(grads, r["grads"]):
        assert_close(f"{arch} grad leaf {i}", g, w, GRAD_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference(arch):
    r = reference(arch)
    params = params_from_numpy(r["params"], "cpu")
    opt = params_from_numpy(np_tree(r["opt"]), "cpu")
    assert isinstance(opt, tadamw.OptState) and int(opt.step) == 3
    new_p, new_o, met = ttrain.make_train_step(r["cfg"], TOPT)(
        params, opt, to_port(r["batch"]))
    assert int(new_o.step) == 4
    assert abs(float(met["loss"]) - r["loss"]) <= LOSS_TOL * abs(r["loss"])
    for k in ("grad_norm", "lr"):
        assert_close(k, met[k], r["metrics"][k], 1e-5)
    for name, got, want in (("params", new_p, r["new_params"]),
                            ("m", new_o.m, r["new_opt"].m),
                            ("v", new_o.v, r["new_opt"].v)):
        for i, (g, w) in leaf_pairs(got, want):
            assert_close(f"{arch} {name} leaf {i}", g, w, STEP_TOL)
