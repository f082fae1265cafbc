"""Deterministic synthetic image-classification dataset (+ optional
real CIFAR-10) for the BNN training loop.

The port's copy of ``repro.data.images`` (numpy only): every batch
equals the reference's bit for bit (tests/test_torch_data.py).  Every
batch is a pure function of (seed, step, shard) through the
order-preserving counter -> splitmix64 scheme, so resume-at-step-k
reproduces the uninterrupted stream and re-sharding repartitions the
identical global batch.

The synthetic task is *separable by construction*: each class owns a
deterministic +-1 prototype pattern; a sample is its label's prototype
with per-pixel sign flips at ``flip_prob`` and a continuous magnitude
jitter in [mag_lo, mag_hi].  The jitter keeps pixel values off exact
zero and keeps convolution sums off exact zero, so the serving
datapath's strict ``x > 0`` binarize convention never lands on a tie —
the train->fold->compile->serve sign-identity gate needs that.  With
small flip_prob the classes are recoverable from pixel *signs* alone,
which is exactly the information a binarized first layer can see.

``load_cifar10`` reads the standard python-pickle batches when a local
copy exists (CIFAR10_DIR or an explicit root) and returns None
otherwise — offline hosts self-skip, nothing downloads.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.data.pipeline import _splitmix64

__all__ = ["ImageDataConfig", "ImageIterator", "image_batch_at",
           "image_shard_batch_at", "class_prototypes", "load_cifar10"]

# disjoint counter tags so the prototype, flip, and magnitude streams
# never collide for the same (seed, pixel) — and a huge step offset so
# an eval stream never reuses a training sample
_PROTO_TAG = np.uint64(0xA076_1D64_78BD_642F)
_FLIP_TAG = np.uint64(0xE703_7ED1_A0B4_28DB)
_MAG_TAG = np.uint64(0x8EBC_6AF0_9C88_C6E3)
EVAL_STEP_OFFSET = 1 << 40


@dataclass(frozen=True)
class ImageDataConfig:
    num_classes: int
    height: int
    width: int
    channels: int
    global_batch: int
    seed: int = 0
    flip_prob: float = 0.05     # per-pixel label-noise (sign flips)
    mag_lo: float = 0.6         # continuous magnitude jitter bounds
    mag_hi: float = 1.4

    @property
    def n_pixels(self) -> int:
        return self.height * self.width * self.channels

    @property
    def image_shape(self):
        return (self.height, self.width, self.channels)


def _uniform(h: np.ndarray) -> np.ndarray:
    """splitmix64 words -> float64 uniforms in [0, 1)."""
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def class_prototypes(cfg: ImageDataConfig) -> np.ndarray:
    """The deterministic +-1 prototype of every class,
    [num_classes, H, W, C]."""
    cls = np.arange(cfg.num_classes, dtype=np.uint64)[:, None]
    pix = np.arange(cfg.n_pixels, dtype=np.uint64)[None, :]
    seed_mix = np.uint64((cfg.seed * 0x9E3779B97F4A7C15) % (1 << 64))
    h = _splitmix64(cls * np.uint64(cfg.n_pixels) + pix + _PROTO_TAG
                    + seed_mix)
    proto = np.where(_uniform(h) < 0.5, -1.0, 1.0).astype(np.float32)
    return proto.reshape(cfg.num_classes, *cfg.image_shape)


def image_batch_at(cfg: ImageDataConfig, step: int) -> Dict[str, np.ndarray]:
    """The full global batch for a step — the reference the sharded
    slices and the resume/reshard property tests are defined against."""
    b = cfg.global_batch
    sample = np.arange(b, dtype=np.uint64) + np.uint64(step) * np.uint64(b)
    label = (sample % np.uint64(cfg.num_classes)).astype(np.int32)
    proto = class_prototypes(cfg).reshape(cfg.num_classes, -1)[label]
    pix = np.arange(cfg.n_pixels, dtype=np.uint64)[None, :]
    idx = sample[:, None] * np.uint64(cfg.n_pixels) + pix \
        + np.uint64((cfg.seed * 0x2545F4914F6CDD1D) % (1 << 64))
    flip = np.where(_uniform(_splitmix64(idx + _FLIP_TAG)) < cfg.flip_prob,
                    -1.0, 1.0)
    mag = cfg.mag_lo + (cfg.mag_hi - cfg.mag_lo) \
        * _uniform(_splitmix64(idx + _MAG_TAG))
    imgs = (proto * flip * mag).astype(np.float32)
    return {"image": imgs.reshape(b, *cfg.image_shape), "label": label}


def image_shard_batch_at(cfg: ImageDataConfig, step: int, shard: int,
                         n_shards: int) -> Dict[str, np.ndarray]:
    """This DP shard's contiguous slice of the global batch."""
    assert cfg.global_batch % n_shards == 0
    per = cfg.global_batch // n_shards
    g = image_batch_at(cfg, step)
    sl = slice(shard * per, (shard + 1) * per)
    return {k: v[sl] for k, v in g.items()}


class ImageIterator:
    """Stateful cursor over the image stream — same checkpointable
    state_dict/from_state contract as pipeline.DataIterator, so the
    training checkpoint's data cursor is layout-independent."""

    def __init__(self, cfg: ImageDataConfig, shard: int = 0,
                 n_shards: int = 1, start_step: int = 0):
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step

    def __iter__(self) -> "ImageIterator":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = image_shard_batch_at(self.cfg, self.step, self.shard,
                                     self.n_shards)
        self.step += 1
        return batch

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "shard": self.shard,
                "n_shards": self.n_shards}

    @classmethod
    def from_state(cls, cfg: ImageDataConfig, state: Dict[str, int],
                   shard: int, n_shards: int) -> "ImageIterator":
        return cls(cfg, shard=shard, n_shards=n_shards,
                   start_step=int(state["step"]))


def eval_batch_at(cfg: ImageDataConfig, step: int) -> Dict[str, np.ndarray]:
    """A held-out batch: same distribution, sample counters offset far
    past any training step, so eval never sees a training sample."""
    return image_batch_at(cfg, step + EVAL_STEP_OFFSET)


# ------------------------------------------------------------------ #
# optional real CIFAR-10 (self-skips offline)                          #
# ------------------------------------------------------------------ #
def load_cifar10(root: Optional[str] = None, split: str = "train"
                 ) -> Optional[Dict[str, np.ndarray]]:
    """Load the standard CIFAR-10 python pickle batches from a local
    directory (``root`` or $CIFAR10_DIR, optionally containing the
    extracted ``cifar-10-batches-py``).  Returns {"image": float32
    NHWC in [-1, 1], "label": int32} or None when no local copy exists
    — callers self-skip on None; nothing is
    ever downloaded."""
    root = root or os.environ.get("CIFAR10_DIR")
    if not root:
        return None
    base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = root
    names = [f"data_batch_{i}" for i in range(1, 6)] \
        if split == "train" else ["test_batch"]
    paths = [os.path.join(base, n) for n in names]
    if not all(os.path.isfile(p) for p in paths):
        return None
    imgs, labels = [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], np.uint8))
        labels.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x = x.astype(np.float32) / 127.5 - 1.0
    y = np.concatenate(labels).astype(np.int32)
    return {"image": x, "label": y}
