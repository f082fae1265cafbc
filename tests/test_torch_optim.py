"""The port's AdamW and tree walk against the reference's.

``repro_torch.optim.adamw`` from identical params and grads (numpy,
seeded), over 3 steps, with and without the w-only clip_mask: params,
moments, step, grad norm and learning rate within rtol 1e-6, atol 1e-7
of ``repro.optim.adamw`` (both compute in float32; the sums of squares
and ``pow`` may round differently).  The schedule at its edges within
the same tolerance.  ``repro_torch.tree`` flattens in jax's leaf order
(sorted dict keys, NamedTuple fields in order, no leaf for ``{}`` or
None), which the checkpointer's ``leaf_i`` names depend on.
"""
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _np_params(rng):
    """A training-state shaped tree: a conv with BN, a bare conv, a
    thresholded dense and a head; latent weights scaled past 1 so the
    clamp binds."""
    def n(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return {"conv": [{"w": n(3, 3, 2, 8, s=1.5)},
                     {"w": n(3, 3, 8, 16, s=1.5), "gamma": n(16) + 1,
                      "beta": n(16)}],
            "fc": [{"w": n(12, 64, s=1.2), "gamma": n(12) + 1,
                    "beta": n(12)}, {"w": n(4, 12)}]}


def _mask(p):
    return {"conv": [{k: k == "w" for k in d} for d in p["conv"]],
            "fc": [{k: k == "w" for k in d} for d in p["fc"]]}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0],
                         ids=["clipped", "unclipped"])
def test_adamw_three_steps_match_reference(masked, clip_norm):
    rng = np.random.default_rng(0)
    cfg = dict(lr=0.05, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               clip_norm=clip_norm, warmup_steps=2, total_steps=6)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    p0 = _np_params(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = params_from_numpy(p0, "cpu")
    jopt, topt = jadamw.init(jp), tadamw.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32), p0)
        jp, jopt, jm = jadamw.apply_updates(
            jp, jopt, jax.tree.map(jnp.asarray, g), jcfg,
            clip_mask=_mask(p0) if masked else None)
        tp, topt, tm = tadamw.apply_updates(
            tp, topt, params_from_numpy(g, "cpu"), tcfg,
            clip_mask=_mask(p0) if masked else None)
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k])
    assert int(topt.step) == int(jopt.step) == 3
    assert topt.step.dtype == torch.int32 and topt.step.ndim == 0
    for got, want in zip(tree.leaves((tp, topt)), jax.tree.leaves((jp, jopt))):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)
    if masked:       # gamma and beta escape the clamp, w never does
        assert float(tp["conv"][1]["gamma"].abs().max()) > 1.0
    assert all(float(p["w"].abs().max()) <= 1.0
               for p in tp["conv"] + tp["fc"])


@pytest.mark.parametrize("warmup,total", [(0, 1), (1, 1), (5, 3), (10, 100)])
def test_schedule_matches_reference(warmup, total):
    jcfg = jadamw.AdamWConfig(lr=0.3, warmup_steps=warmup, total_steps=total)
    tcfg = tadamw.AdamWConfig(lr=0.3, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 2, total - 1, total, total + 5):
        got = tadamw.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32)))


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    g = _np_params(rng)
    _close(tadamw.global_norm(params_from_numpy(g, "cpu")),
           jadamw.global_norm(jax.tree.map(jnp.asarray, g)))
    tc, tn = tadamw.clip_by_global_norm(params_from_numpy(g, "cpu"), 0.5)
    jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    _close(tn, jn)
    for a, b in zip(tree.leaves(tc), jax.tree.leaves(jc)):
        _close(a, b)


class _Pair(NamedTuple):
    first: object
    second: object


def _sample_tree():
    return {"b": [{}, {"z": 1, "a": (2, None)}], "a": _Pair([3, {}], 4),
            "c": None, "d": {"y": True, "x": [5, (6,)]}}


def test_tree_order_matches_jax():
    t = _sample_tree()
    flat, td = tree.flatten(t)
    assert flat == jax.tree.leaves(t) == [3, 4, 2, 1, 5, 6, True]
    assert tree.unflatten(td, flat) == t
    assert td == tree.flatten(_sample_tree())[1]
    doubled = tree.map(lambda a, b: a + b, t, t)
    assert tree.leaves(doubled) == [6, 8, 4, 2, 10, 12, 2]
    assert isinstance(doubled["a"], _Pair) and doubled["c"] is None
    assert repr(tree.flatten({"k": [1, {}], "j": None})[1]) == \
        "{'j': None, 'k': [*, {}]}"


def test_tree_rejects_mismatches():
    _, td = tree.flatten({"a": [1, 2]})
    with pytest.raises(ValueError, match="2 leaves expected"):
        tree.unflatten(td, [1])
    with pytest.raises(ValueError, match="structures differ"):
        tree.map(lambda a, b: a, {"a": [1, 2]}, {"a": (1, 2)})


def test_training_state_order_matches_jax():
    """(params, bn_state, OptState) as the reference's checkpoint
    flattens it: leaf for leaf the same arrays in the same order after
    the state crosses through params_from_numpy."""
    rng = np.random.default_rng(1)
    p = _np_params(rng)
    bn = {"conv": [{}, {"mu": np.zeros(16, np.float32),
                        "var": np.ones(16, np.float32)}],
          "fc": [{"mu": np.full(12, 2.0, np.float32),
                  "var": np.full(12, 3.0, np.float32)}, {}]}
    jstate = jax.tree.map(jnp.asarray, (p, bn))
    jopt = jadamw.init(jstate[0])
    ref = jax.tree.leaves((*jstate, jopt))
    tstate = params_from_numpy(
        (p, bn, jax.tree.map(np.asarray, jopt)), "cpu")
    assert isinstance(tstate[2], tadamw.OptState)
    got = tree.leaves(tstate)
    assert len(got) == len(ref) == 29
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
