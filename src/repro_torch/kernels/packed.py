"""PackedArray — the canonical 1-bit tensor — and the backend registry.

The PyTorch counterpart of ``repro.kernels.packed``:

* ``pack_words`` / ``unpack_words`` / ``popcount_u32``: the packing
  loop and its inverses, in plain torch.
* ``PackedArray``: the words plus the static metadata needed to read
  them — the logical bit length (pre-padding), the pack axis (stored
  negative so added leading dims never shift it), and the value
  semantics ({-1,+1} vs {0,1}).
* ``BackendSpec`` registry: ``"cuda"`` runs the hand-written Hopper
  kernels (``kernels/csrc``), ``"torch"`` runs the plain versions;
  ``default_backend()`` is ``"cuda"``.
* ``adopt_packed`` (raw legacy words -> PackedArray, one deprecation
  warning per call site) and ``tree_nbytes`` (a params tree's bytes,
  packed words as stored), for the LLM side.

Words travel as ``torch.int32`` tensors holding the uint32 bit pattern:
torch's CPU uint32 tensors implement neither ``~`` nor the shifts.  On
int32, ``>>`` is an arithmetic shift, so every right shift here is
masked before its bits are used.

Layout contract: bit b of word j along the pack axis holds
``[x[32*j + b] > 0]``; pad bits are 0 (the value -1 under the pm1
convention) and every consumer corrects for them through the logical
``length`` with the closed form ``dot = 2*(pc - (K_padded - K)) - K``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch import tree as _tree

PM1 = "pm1"        # bit 1 <-> +1, bit 0 <-> -1
ZERO_ONE = "01"    # bit is the value

WORD = torch.int32     # the dtype every packed word tensor carries


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def as_uint32(words: torch.Tensor) -> np.ndarray:
    """The words as a host uint32 array (the reference's dtype)."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def from_uint32(a: np.ndarray, device=None) -> torch.Tensor:
    """Host uint32 words -> an int32 tensor with the same bit pattern."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


# ------------------------------------------------------------------ #
# the canonical pack / unpack / popcount                               #
# ------------------------------------------------------------------ #
def pack_words(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack sign bits ``x > 0`` into int32 words along ``axis``, 32 per
    word.  A non-multiple-of-32 axis is zero-padded first (zeros pack
    to bit 0, the pm1 value -1 every consumer corrects for)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    xm = torch.movedim(x, axis, -1)
    if n % 32:
        xm = torch.nn.functional.pad(xm, (0, (-n) % 32))
    bits = (xm > 0).to(WORD).reshape(*xm.shape[:-1], -1, 32)
    shifts = torch.arange(32, dtype=WORD, device=x.device)
    # distinct powers of two: the int32 sum never overflows
    words = torch.sum(bits << shifts, dim=-1, dtype=WORD)
    return torch.movedim(words, -1, axis)


def unpack_words(words: torch.Tensor, axis: int = -1,
                 dtype: torch.dtype = torch.float32, values: str = PM1,
                 length: Optional[int] = None) -> torch.Tensor:
    """Inverse of pack_words; slices the axis to ``length`` bits when
    given (dropping pad bits)."""
    axis = axis % words.ndim
    shifts = torch.arange(32, dtype=WORD, device=words.device)
    w = torch.movedim(words, axis, -1)
    bits = (w[..., None] >> shifts) & 1          # masked: arithmetic >>
    if values == PM1:
        vals = (2 * bits - 1).to(dtype)
    else:
        vals = bits.to(dtype)
    vals = vals.reshape(*w.shape[:-1], w.shape[-1] * 32)
    if length is not None:
        vals = vals[..., :length]
    return torch.movedim(vals, -1, axis)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of values in [0, 2**16): no int32 overflow."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of each int32 word's 32-bit pattern (int32 result).
    The halves are counted apart, so no step can overflow int32 and
    the arithmetic right shift of a negative word is masked off."""
    x = x.to(WORD)
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


# ------------------------------------------------------------------ #
# PackedArray                                                          #
# ------------------------------------------------------------------ #
class PackedArray:
    """1-bit tensor: int32 ``words`` + static (length, axis, values).

    The pack axis is stored negative, so a leading batch dim leaves it
    pointing at the same packed dim."""
    __slots__ = ("words", "length", "axis", "values")

    def __init__(self, words: torch.Tensor, length: int, axis: int = -1,
                 values: str = PM1):
        if words.dtype != WORD:
            raise TypeError(f"packed words must be {WORD} (the uint32 bit "
                            f"pattern), got {words.dtype}")
        if axis >= 0:
            axis -= words.ndim
        self.words = words
        self.length = int(length)
        self.axis = int(axis)
        self.values = values

    @property
    def ndim(self) -> int:
        return self.words.ndim

    @property
    def n_words(self) -> int:
        return self.words.shape[self.axis]

    @property
    def padded_length(self) -> int:
        """Bits along the pack axis, pad bits included."""
        return 32 * self.n_words

    @property
    def shape(self):
        """Logical (unpacked) shape."""
        s = list(self.words.shape)
        s[self.axis] = self.length
        return tuple(s)

    def __repr__(self):
        return (f"PackedArray(shape={self.shape}, axis={self.axis}, "
                f"values={self.values!r}, words{tuple(self.words.shape)})")

    @classmethod
    def pack(cls, x: torch.Tensor, axis: int = -1,
             values: str = PM1) -> "PackedArray":
        """sign+pack: bit = ``[x > 0]``; records ``x.shape[axis]`` as the
        logical length."""
        return cls(pack_words(x, axis=axis), length=x.shape[axis],
                   axis=axis, values=values)

    def unpack(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Back to dense values of ``dtype`` (pad bits sliced off)."""
        return unpack_words(self.words, axis=self.axis, dtype=dtype,
                            values=self.values, length=self.length)

    def with_words(self, words: torch.Tensor) -> "PackedArray":
        return PackedArray(words, self.length, self.axis, self.values)

    def to(self, device) -> "PackedArray":
        return self.with_words(self.words.to(device))

    def pad_to(self, n_bits: int) -> "PackedArray":
        """Zero-pad words so the padded bit count reaches ``n_bits``
        (rounded up to a word); the logical length is unchanged."""
        tgt = round_up(n_bits, 32) // 32
        if tgt <= self.n_words:
            return self
        w = torch.movedim(self.words, self.axis, -1)
        w = torch.nn.functional.pad(w, (0, tgt - self.n_words))
        return self.with_words(torch.movedim(w, -1, self.axis).contiguous())

    def move_pack_axis_last(self) -> "PackedArray":
        """Words with the pack axis last (the row-major GEMM operand
        layout)."""
        if self.axis == -1:
            return self
        return PackedArray(
            torch.movedim(self.words, self.axis, -1).contiguous(),
            self.length, -1, self.values)


# ------------------------------------------------------------------ #
# legacy raw-words adoption                                            #
# ------------------------------------------------------------------ #
_RAW_WORDS_WARNED: set = set()


def adopt_packed(a: Union[PackedArray, torch.Tensor],
                 length: Optional[int] = None, axis: int = -1,
                 context: str = "packed operand") -> PackedArray:
    """THE adoption point for legacy raw-word operands.

    A PackedArray passes through unchanged (its recorded length is
    cross-checked against an explicit ``length``).  Raw int32 words are
    wrapped into a PackedArray over ``axis`` with the given logical
    ``length`` (every bit of the words by default), after ONE
    DeprecationWarning per call-site ``context``: raw words carry no
    layout metadata."""
    if isinstance(a, PackedArray):
        if length is not None and a.length != length:
            raise ValueError(f"{context}: explicit length={length} "
                             f"disagrees with "
                             f"PackedArray.length={a.length}")
        return a
    if context not in _RAW_WORDS_WARNED:
        _RAW_WORDS_WARNED.add(context)
        warnings.warn(
            f"{context}: raw packed words are deprecated — wrap them in "
            f"a PackedArray (repro_torch.kernels.packed) so the logical "
            f"length and pack axis travel with the words",
            DeprecationWarning, stacklevel=3)
    if length is None:
        length = 32 * a.shape[axis]
    return PackedArray(a, length=length, axis=axis)


# ------------------------------------------------------------------ #
# backend registry                                                     #
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """One execution target.

    The Hopper kernels mask their own ragged M, N and K edges, so a
    launch pads K to a whole word and nothing else: the TPU's 128/128/512
    block multiples do not carry over."""
    name: str
    uses_kernels: bool      # hand-written kernels (plain versions on CPU)

    @staticmethod
    def pad_k(k_bits: int) -> int:
        return round_up(k_bits, 32)


_BACKENDS: Dict[str, BackendSpec] = {}


def register_backend(spec: BackendSpec) -> BackendSpec:
    _BACKENDS[spec.name] = spec
    return spec


register_backend(BackendSpec("cuda", uses_kernels=True))
register_backend(BackendSpec("torch", uses_kernels=False))

DEFAULT_BACKEND = "cuda"


def default_backend() -> str:
    """The backend taken when the caller names none: always ``"cuda"``
    (whose wrappers take their plain versions for a CPU tensor).  The
    ``"torch"`` backend runs only where a caller names it, never because
    no card was found."""
    return DEFAULT_BACKEND


def get_backend(name: Optional[str] = None) -> BackendSpec:
    name = name or default_backend()
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{sorted(_BACKENDS)}") from None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for the CPU.  ``None`` means ``"cuda"``, and a CUDA device on
    a host without one raises — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card "
                           "unless the caller passes device='cpu'")
    return dev


# ------------------------------------------------------------------ #
# small tree utilities                                                 #
# ------------------------------------------------------------------ #
def tree_nbytes(tree: Any) -> int:
    """Total bytes of all tensor leaves (a PackedArray counts its words:
    the device-memory footprint, not the logical unpacked one)."""
    total = 0
    for leaf in _tree.leaves(tree):
        if isinstance(leaf, PackedArray):
            leaf = leaf.words
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
