"""The port's checkpointer: the reference's on-disk layout, both ways.

A training state (params, bn_state, OptState) round-trips exactly,
0-d leaves and dtypes included; the port's ``restore`` reads a
checkpoint the reference's ``save`` wrote (``leaf_i`` in jax's leaf
order) into the port's tree with equal leaves, and the reference's
``restore`` reads the port's; the sha256 digest catches a flipped byte
past the fingerprint's prefix; the write is atomic (a stale ``.tmp``
is neither restored nor counted), retention keeps the newest;
``AsyncCheckpointer.save`` has the tree on the host when it returns
and surfaces a failed write on ``wait``.  bfloat16 leaves (stored as
their uint16 bits, the dtype in ``meta.json``) and PackedArray leaves
(their words as uint32) round-trip bit for bit, through ``save`` and
``AsyncCheckpointer``, and a flipped byte in a bfloat16 leaf raises
``ChecksumError``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import graph as jgraph  # noqa: E402
from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.models import init_train_state as jinit  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    ChecksumError, latest_step, restore,
                                    save)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.packed import PackedArray  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402


def _spec(g):
    return g.from_dense_stack(32, [64, 4], logits=True, name="t-mlp")


def _port_state(seed=0):
    params, bn = init_train_state(torch.Generator().manual_seed(seed),
                                  _spec(tgraph), device="cpu")
    opt = tadamw.init(params)
    return params, bn, opt._replace(step=torch.tensor(5, dtype=torch.int32))


def _assert_leaves_equal(a, b):
    fa, ta = tree.flatten(a)
    fb, tb = tree.flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_exact(tmp_path):
    state = _port_state()
    save(str(tmp_path), 7, state, extra={"step": 7, "data": {"step": 7}})
    got, meta = restore(str(tmp_path), _port_state(seed=1))
    assert meta["extra"] == {"step": 7, "data": {"step": 7}}
    assert meta["n_leaves"] == len(tree.leaves(state)) == 15
    assert isinstance(got[2], tadamw.OptState)
    _assert_leaves_equal(got, state)
    assert got[2].step.ndim == 0 and int(got[2].step) == 5


def test_port_restores_a_reference_checkpoint(tmp_path):
    params, bn = jinit(jax.random.PRNGKey(0), _spec(jgraph))
    opt = jadamw.init(params)
    jsave(str(tmp_path), 3, (params, bn, opt), extra={"step": 3})
    got, meta = restore(str(tmp_path), _port_state())
    assert meta["extra"]["step"] == 3
    want = params_from_numpy(jax.tree.map(np.asarray, (params, bn, opt)),
                             "cpu")
    _assert_leaves_equal(got, want)


def test_reference_restores_a_port_checkpoint(tmp_path):
    state = _port_state()
    save(str(tmp_path), 4, state)
    params, bn = jinit(jax.random.PRNGKey(1), _spec(jgraph))
    (jp, jb, jo), _ = jrestore(str(tmp_path),
                               (params, bn, jadamw.init(params)))
    for a, b in zip(jax.tree.leaves((jp, jb, jo)), tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_digest_catches_deep_corruption(tmp_path):
    t = {"w": torch.arange(8192, dtype=torch.float32),
         "b": torch.ones(4)}
    path = save(str(tmp_path), 1, t)
    with open(os.path.join(path, "meta.json")) as f:
        assert len(json.load(f)["sha256"]) == 64
    npz = os.path.join(path, "arrays.npz")
    with np.load(npz) as z:
        arrs = {n: z[n].copy() for n in z.files}
    big = next(a for a in arrs.values() if a.nbytes > 4096)
    big.view(np.uint8).reshape(-1)[6000] ^= 0x01    # past the prefix
    np.savez(npz, **arrs)
    with pytest.raises(ChecksumError, match="sha256"):
        restore(str(tmp_path), t)
    with pytest.raises(ValueError, match="leaf count"):
        save(str(tmp_path), 2, t)
        restore(str(tmp_path), {"w": t["w"]})


def test_atomic_layout_and_retention(tmp_path):
    d = str(tmp_path)
    assert latest_step(d + "/absent") is None
    t = {"w": torch.zeros(3)}
    for step in (1, 2, 3, 4):
        save(d, step, {"w": torch.full((3,), float(step))}, keep=2)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a torn write
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000009.tmp"]
    assert latest_step(d) == 4
    got, _ = restore(d, t)
    assert torch.equal(got["w"], torch.full((3,), 4.0))
    got, _ = restore(d, t, step=3)
    assert torch.equal(got["w"], torch.full((3,), 3.0))
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"), t)


def test_async_save_copies_to_host_first_and_surfaces_errors(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=3)
    w = torch.ones(1000)
    ck.save(1, {"w": w}, extra={"step": 1})
    w.fill_(7.0)             # the trainer overwrites its tensor at once
    ck.wait()
    assert ck.saved_steps == [1]
    got, _ = restore(str(tmp_path), {"w": w})
    assert torch.equal(got["w"], torch.ones(1000))
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = AsyncCheckpointer(str(blocker))
    bad.save(1, {"w": w})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()               # the error is raised once


# ------------------------------------------------------------------ #
# bfloat16 and PackedArray leaves                                      #
# ------------------------------------------------------------------ #
def _bf16_tree(seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((37, 5), generator=g).to(torch.bfloat16)
    # every bit pattern class: -0.0, inf, a NaN payload, a denormal
    w.view(torch.int16)[0, :4] = torch.tensor([-32768, 0x7F80, 0x7FC1, 1],
                                              dtype=torch.int16)
    return {"w": w,
            "b": torch.randn((5,), generator=g).to(torch.bfloat16),
            "f": torch.randn((3, 4), generator=g),
            "i": torch.arange(7, dtype=torch.int32) * (seed + 1),
            "p": PackedArray.pack(torch.randn((70, 3), generator=g),
                                  axis=0),
            "opt": tadamw.OptState(step=torch.tensor(seed, dtype=torch.int32),
                                   m={"w": torch.randn((2,), generator=g)},
                                   v={"w": torch.rand((2,), generator=g)})}


def _assert_bits_equal(a, b):
    fa, ta = tree.flatten(a)
    fb, tb = tree.flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        if isinstance(x, PackedArray):
            assert (x.length, x.axis) == (y.length, y.axis)
            x, y = x.words, y.words
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y)


def test_bf16_roundtrip_bit_for_bit(tmp_path):
    t = _bf16_tree(1)
    path = save(str(tmp_path), 1, t)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    # sorted keys b, f, i, opt(step, m/w, v/w), p, w: the bf16 leaves
    assert meta["leaf_dtypes"] == {"0": "bfloat16", "7": "bfloat16"}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert z["leaf_0"].dtype == np.uint16
        assert z["leaf_6"].dtype == np.uint32     # the packed words
    got, _ = restore(str(tmp_path), _bf16_tree(2))
    _assert_bits_equal(got, t)
    # a tree with no bf16 leaf keeps the reference's meta exactly
    path = save(str(tmp_path), 2, {"f": t["f"]})
    with open(os.path.join(path, "meta.json")) as f:
        assert "leaf_dtypes" not in json.load(f)


def test_bf16_async_checkpointer(tmp_path):
    t = _bf16_tree(3)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(5, t, extra={"step": 5})
    t["w"].fill_(0)          # the trainer overwrites its tensor at once
    ck.wait()
    got, meta = restore(str(tmp_path), _bf16_tree(4))
    assert meta["extra"]["step"] == 5
    _assert_bits_equal(got, _bf16_tree(3))


@pytest.mark.parametrize("offset,check", [(0, "fingerprint"),
                                          (5000, "sha256")])
def test_bf16_corruption_raises(tmp_path, offset, check):
    t = {"w": torch.randn(4096).to(torch.bfloat16)}
    path = save(str(tmp_path), 1, t)
    npz = os.path.join(path, "arrays.npz")
    with np.load(npz) as z:
        arrs = {n: z[n].copy() for n in z.files}
    arrs["leaf_0"].view(np.uint8)[offset] ^= 0x10
    np.savez(npz, **arrs)
    with pytest.raises(ChecksumError, match=check):
        restore(str(tmp_path), t)
