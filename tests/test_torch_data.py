"""The port's image data stream against the reference's, bit for bit.

``repro_torch.data`` is a numpy copy of ``repro.data.images`` (and of
the splitmix64 counter hash of ``repro.data.pipeline``): the global and
sharded batches, the eval stream, the class prototypes and the
iterator's resumed stream must equal the reference's exactly, and both
CIFAR-10 loaders must read the same pickle batches (and return None
without a local copy: nothing is downloaded).
"""
import pickle

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import images as jimages  # noqa: E402
from repro.data.pipeline import _splitmix64 as jsplitmix  # noqa: E402
from repro_torch.data import images as timages  # noqa: E402
from repro_torch.data.pipeline import _splitmix64 as tsplitmix  # noqa: E402

# the reference's tiny training data (tests/test_train.py) and a wider,
# noisier stream with another seed
CONFIGS = [dict(num_classes=4, height=4, width=4, channels=2,
                global_batch=16, seed=1, flip_prob=0.02),
           dict(num_classes=10, height=6, width=5, channels=3,
                global_batch=12, seed=7, flip_prob=0.3, mag_lo=0.2,
                mag_hi=2.0)]


def _cfgs(i):
    return (jimages.ImageDataConfig(**CONFIGS[i]),
            timages.ImageDataConfig(**CONFIGS[i]))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


def test_splitmix64_equal():
    x = np.arange(10_000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(tsplitmix(x), jsplitmix(x))


@pytest.mark.parametrize("cfg", [0, 1])
@pytest.mark.parametrize("step", [0, 1, 37])
def test_image_and_eval_batches_equal(cfg, step):
    jc, tc = _cfgs(cfg)
    _equal(timages.image_batch_at(tc, step), jimages.image_batch_at(jc, step))
    _equal(timages.eval_batch_at(tc, step), jimages.eval_batch_at(jc, step))


@pytest.mark.parametrize("cfg", [0, 1])
def test_prototypes_and_shards_equal(cfg):
    jc, tc = _cfgs(cfg)
    np.testing.assert_array_equal(timages.class_prototypes(tc),
                                  jimages.class_prototypes(jc))
    for shard in range(4):
        _equal(timages.image_shard_batch_at(tc, 3, shard, 4),
               jimages.image_shard_batch_at(jc, 3, shard, 4))


@pytest.mark.parametrize("cfg", [0, 1])
def test_resumed_iterator_stream_equal(cfg):
    """Three steps, the cursor saved, a new iterator from it: the port's
    resumed stream equals the reference's uninterrupted one."""
    jc, tc = _cfgs(cfg)
    it = timages.ImageIterator(tc)
    for _ in range(3):
        next(it)
    state = it.state_dict()
    assert state == {"step": 3, "shard": 0, "n_shards": 1}
    resumed = timages.ImageIterator.from_state(tc, state, shard=0,
                                               n_shards=1)
    ref = jimages.ImageIterator(jc, start_step=0)
    for _ in range(3):
        next(ref)
    for _ in range(4):
        _equal(next(resumed), next(ref))


def test_load_cifar10_offline_and_from_pickles(tmp_path, monkeypatch):
    monkeypatch.delenv("CIFAR10_DIR", raising=False)
    assert timages.load_cifar10() is None
    assert timages.load_cifar10(str(tmp_path)) is None
    rng = np.random.default_rng(0)
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 256, (3, 3072), dtype=np.uint8),
             b"labels": list(rng.integers(0, 10, 3))}
        with open(base / name, "wb") as f:
            pickle.dump(d, f)
    for split in ("train", "test"):
        _equal(timages.load_cifar10(str(tmp_path), split),
               jimages.load_cifar10(str(tmp_path), split))
    monkeypatch.setenv("CIFAR10_DIR", str(tmp_path))
    assert timages.load_cifar10()["image"].shape == (15, 32, 32, 3)
