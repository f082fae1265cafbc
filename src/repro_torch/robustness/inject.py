"""Seeded data-fault injection for the packed BNN datapath.

The counterpart of ``repro.robustness.inject``, with the same two
physical fault models and the same numpy draws, so one seed faults the
same bits in both packages:

* **SEU bit flips** (``flip_bits`` / ``flip_params``): a single-event
  upset flips one stored bit.  One weight is one bit of a 32-bit word,
  so an SEU is an XOR of a single-bit mask into one word.  Flips are
  sampled over *logical* bit positions only: pad bits (positions >=
  ``length`` on the pack axis) encode nothing.
* **Analog-margin noise** (``perturb_thresholds``): additive
  ``round(N(0, sigma))`` integer noise on every per-channel ``t``
  vector, the device variation of TULIP's threshold comparator.

``seu_curve`` / ``threshold_curve`` sweep these over a compiled network
and report logit / argmax degradation against the fault-free forward.

The port's words are int32 tensors holding the uint32 pattern: a flip
XORs a host uint32 copy (``packed.as_uint32``) and the new words go back
to the input's device (``packed.from_uint32``).  Leaves are taken in
jax's flatten order (``repro_torch.tree``, where a PackedArray is a
leaf); ``perturb_thresholds`` walks dicts in insertion order, as the
reference does, so it draws the reference's noise only on a tree that
keeps the reference's key order (``convert.params_from_numpy`` does).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.kernels.packed import PackedArray, as_uint32, from_uint32

__all__ = [
    "flip_bits",
    "flip_params",
    "perturb_thresholds",
    "seu_curve",
    "threshold_curve",
]

Seed = Union[int, np.random.Generator]


def _rng(seed: Seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def _is_packed(x: Any) -> bool:
    return isinstance(x, PackedArray)


def flip_bits(pa: PackedArray, n_flips: int, seed: Seed = 0) -> PackedArray:
    """XOR ``n_flips`` distinct, uniformly-sampled logical bits of
    ``pa`` (the SEU model).  Pad bits are never touched: positions are
    drawn from the logical shape, then mapped to (word, bit-in-word)
    on the pack axis.  ``n_flips`` is clamped to the number of logical
    bits; 0 flips returns ``pa`` unchanged.  The result's words lie on
    ``pa``'s device."""
    total = int(np.prod(pa.shape))
    n = min(int(n_flips), total)
    if n < 0:
        raise ValueError(f"n_flips must be >= 0, got {n_flips}")
    if n == 0:
        return pa
    flat = _rng(seed).choice(total, size=n, replace=False)
    idx = list(np.unravel_index(flat, pa.shape))
    ax = pa.words.ndim + pa.axis  # axis is stored negative
    bit = idx[ax].astype(np.uint32)
    idx[ax] = bit // np.uint32(32)
    mask = (np.uint32(1) << (bit % np.uint32(32))).astype(np.uint32)
    words = as_uint32(pa.words).copy()  # host copy to mutate
    # ufunc.at accumulates duplicates — distinct bits can share a word
    np.bitwise_xor.at(words, tuple(idx), mask)
    return pa.with_words(from_uint32(words, pa.words.device))


def flip_params(tree: Any, n_flips: int, seed: Seed = 0) -> Any:
    """Distribute ``n_flips`` SEUs over every :class:`PackedArray`
    leaf of a parameter tree, multinomially weighted by each leaf's
    logical bit count (a uniform draw over all stored weight bits).
    Non-packed leaves (float latent weights, integer thresholds) are
    untouched — they are not 1-bit storage."""
    rng = _rng(seed)
    flat, treedef = _tree.flatten(tree)
    packed = [i for i, leaf in enumerate(flat) if _is_packed(leaf)]
    if not packed:
        raise ValueError("no PackedArray leaves to inject into")
    sizes = np.array([np.prod(flat[i].shape) for i in packed], dtype=float)
    counts = rng.multinomial(int(n_flips), sizes / sizes.sum())
    for i, c in zip(packed, counts):
        if c:
            flat[i] = flip_bits(flat[i], int(c), rng)
    return _tree.unflatten(treedef, flat)


def _is_int_vector(v: Any) -> bool:
    return isinstance(v, torch.Tensor) and not v.is_floating_point() \
        and not v.is_complex() and v.dtype != torch.bool


def perturb_thresholds(tree: Any, sigma: float, seed: Seed = 0) -> Any:
    """Add ``round(N(0, sigma))`` integer noise to every per-channel
    threshold vector (the ``"t"`` entries the BN-fold produces) — the
    analog-margin variation model for the mixed-signal comparator.  The
    noise is added on the vector's own device, in its dtype.  Non-integer
    ``t`` entries (a FoldedThreshold, rewritten later at bind time) are
    left alone.  A NamedTuple is rebuilt field by field (the reference
    hands its fields to the constructor as one generator, which raises
    on a FoldedThreshold)."""
    rng = _rng(seed)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "t" and _is_int_vector(v):
                    noise = np.rint(rng.normal(0.0, sigma, tuple(v.shape)))
                    out[k] = v + torch.as_tensor(noise, dtype=v.dtype,
                                                 device=v.device)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


def _degradation(base: np.ndarray, logits: np.ndarray) -> Dict[str, float]:
    delta = np.abs(logits - base)
    return {
        "argmax_match": float(np.mean(logits.argmax(-1) == base.argmax(-1))),
        "mean_abs_logit_delta": float(delta.mean()),
        "max_abs_logit_delta": float(delta.max()),
    }


def _host(out: torch.Tensor) -> np.ndarray:
    return out.detach().cpu().numpy()


def _baseline(compiled, params, x) -> np.ndarray:
    out = compiled.apply(params, x)
    if isinstance(out, PackedArray):
        raise ValueError(
            "fault curves need float logits — compile a Logits-terminated "
            f"spec, got a packed output from {compiled.spec.name!r}"
        )
    return _host(out)


def seu_curve(
    compiled,
    params,
    x,
    flip_counts: Sequence[int],
    seed: int = 0,
    baseline: Optional[np.ndarray] = None,
) -> List[Dict[str, float]]:
    """Sweep SEU counts over a compiled network: for each ``n`` in
    ``flip_counts``, flip ``n`` seeded weight bits and measure logit /
    argmax degradation vs the fault-free forward.  Each sweep point
    draws from an independent ``(seed, n)`` stream, so adding points
    never reshuffles existing ones."""
    base = _baseline(compiled, params, x) if baseline is None else baseline
    rows = []
    for n in flip_counts:
        faulted = flip_params(params, n, np.random.default_rng([seed, n]))
        logits = _host(compiled.apply(faulted, x))
        rows.append({"n_flips": int(n), **_degradation(base, logits)})
    return rows


def threshold_curve(
    compiled,
    params,
    x,
    sigmas: Sequence[float],
    seed: int = 0,
    baseline: Optional[np.ndarray] = None,
) -> List[Dict[str, float]]:
    """Sweep analog-margin noise: for each ``sigma``, perturb every
    per-channel threshold with seeded integer noise and measure
    degradation vs the clean forward (sigma 0.0 is the identity)."""
    base = _baseline(compiled, params, x) if baseline is None else baseline
    rows = []
    for i, sigma in enumerate(sigmas):
        noisy = perturb_thresholds(
            params, sigma, np.random.default_rng([seed, i])
        )
        logits = _host(compiled.apply(noisy, x))
        rows.append({"sigma": float(sigma), **_degradation(base, logits)})
    return rows
