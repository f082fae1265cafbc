"""Packing-domain design rules of the port: the bit-layout contract
(RPL001, RPL003, RPL007).

The counterpart of ``repro.analysis.rules.packing``: there is ONE
packing loop (``kernels/packed.py pack_words``) and one sign convention
per boundary (DESIGN.md §1-§2, §12).  The port's words are int32 tensors
holding the uint32 pattern, so the packing seed it watches for is
``(x > 0).to(int32)`` beside the reference's ``.astype(uint32)``.  The
blessed sites are the reference's, under ``src/repro_torch``: the
canonical loop, the kernel wrappers and their plain versions
(``kernels/ref.py`` and each kernel module's ``*_plain``), which keep
their own copies of the convention and are listed here, not rewritten.
RPL007 single-sources the shared-memory budget of a block in
``kernels/fused_mlp.py`` (``SMEM_BYTES``), the port's counterpart of the
reference's VMEM budget.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from repro_torch.analysis.lint import LintRun, Module, Rule, attr_chain

# the modules allowed to touch bits directly: the canonical torch loop,
# the kernel wrappers (whose plain versions pack their epilogues) and
# the plain oracles
_PACK_BLESSED_SUFFIXES = (
    "kernels/packed.py",
    "kernels/pack.py",
    "kernels/popcount_gemm.py",
    "kernels/packed_conv.py",
    "kernels/fused_mlp.py",
    "kernels/xnor_gemm.py",
    "kernels/ref.py",
)

_SIGN_CHAINS = frozenset(
    {"torch.sign", "np.sign", "numpy.sign", "jnp.sign", "jax.numpy.sign"}
)
_WORD_DTYPES = ("uint32", "int32", "WORD")


def _is_zero(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value in (0, 0.0)


def _is_sign_compare(node: ast.AST) -> bool:
    """A ``x > 0`` / ``x >= 0`` comparison — the binarization seed."""
    return (
        isinstance(node, ast.Compare)
        and len(node.ops) == 1
        and isinstance(node.ops[0], (ast.Gt, ast.GtE))
        and _is_zero(node.comparators[0])
    )


def _chain_endswith(node: ast.AST, leaves: Tuple[str, ...]) -> bool:
    chain = attr_chain(node)
    return chain is not None and chain.split(".")[-1] in leaves


def _check_manual_pack(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    if any(module.endswith(s) for s in _PACK_BLESSED_SUFFIXES):
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain in _SIGN_CHAINS:
            yield (
                node.lineno,
                f"raw `{chain}` — binarization must go through "
                f"kernels.packed (pack_words / PackedArray.pack), not a "
                f"local sign",
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in ("to", "astype")
            and _is_sign_compare(node.func.value)
            and any(_chain_endswith(a, _WORD_DTYPES) for a in node.args)
        ):
            yield (
                node.lineno,
                "manual bit-packing seed `(x > 0).to(int32)` — use "
                "kernels.packed.pack_words / PackedArray.pack",
            )
        elif _chain_endswith(node.func, ("sum",)) and any(
            _chain_endswith(kw.value, _WORD_DTYPES)
            for kw in node.keywords
            if kw.arg == "dtype"
        ):
            if any(
                isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.LShift)
                for a in node.args
                for sub in ast.walk(a)
            ):
                yield (
                    node.lineno,
                    "manual shift-or word packing — the one packing "
                    "loop lives in kernels.packed.pack_words",
                )


# sign-decision sites the port blesses, with the convention each one
# is allowed to spell (DESIGN.md §12's duality table): Gt is the pack
# convention `x > 0`, GtE the post-BN fold compare `s >= 0`
_SIGN_SITES = {
    "kernels/packed.py": (ast.Gt,),
    "kernels/ref.py": (ast.Gt, ast.GtE),
    # the float entry conv's weight sign `w > 0` (sign_weight_conv, the
    # plain version of the entry_conv kernel, which signs as it does)
    "kernels/entry_conv.py": (ast.Gt,),
    # the plain ReActNet reference's RSign `x + b > 0` and weight sign,
    # written from the published equations (it imports nothing of the
    # port, so it spells the pack convention itself)
    "reference/reactnet.py": (ast.Gt,),
    # the plain Bi-Real Net reference's sign, likewise
    "reference/bireal.py": (ast.Gt,),
    "core/binarize.py": (ast.Gt, ast.GtE),
    "core/bnn_layers.py": (ast.Gt, ast.GtE),
    "core/threshold.py": (ast.Gt, ast.GtE),
    "models/quantize.py": (ast.Gt, ast.GtE),
    "train/models.py": (ast.Gt, ast.GtE),
    "train/export.py": (ast.Gt,),
    # the mesh simulator rebuilds +-1 operands from packed words to run
    # binary layers as exact integer popcounts (DESIGN.md §14); it
    # mirrors the pack convention and is gated bit-identical to apply
    "sim/simulator.py": (ast.Gt,),
    # the card's smoke run draws random +-1 operands by the pack
    # convention to hold each kernel against its plain version
    "chip_smoke.py": (ast.Gt,),
    # the quickstart's numpy sign-net oracle spells the pack convention
    # and the fold compare, as the reference's example does
    "examples/torch_quickstart.py": (ast.Gt, ast.GtE),
}

_WHERE_CHAINS = frozenset(
    {"torch.where", "np.where", "numpy.where", "jnp.where", "jax.numpy.where"}
)


def _is_pm1(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return isinstance(node, ast.Constant) and node.value in (1, 1.0)


def _check_sign_convention(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    allowed: Tuple[type, ...] = ()
    for suffix, ops in _SIGN_SITES.items():
        if module.endswith(suffix):
            allowed = ops
            break
    for node in ast.walk(module.tree):
        if not (
            isinstance(node, ast.Call)
            and attr_chain(node.func) in _WHERE_CHAINS
            and len(node.args) == 3
            and _is_sign_compare(node.args[0])
            and _is_pm1(node.args[1])
            and _is_pm1(node.args[2])
        ):
            continue
        op = node.args[0].ops[0]  # type: ignore[attr-defined]
        if isinstance(op, allowed):
            continue
        spelled = ">" if isinstance(op, ast.Gt) else ">="
        yield (
            node.lineno,
            f"sign-decision literal `x {spelled} 0 ? +1 : -1` outside "
            f"its blessed site — pack is `> 0` (kernels/packed.py), "
            f"the folded-BN compare `>= 0` (train/models.py), export "
            f"`w > 0` (models/quantize.py); new sites must be added "
            f"to the §12 convention table, not inlined",
        )


def _check_smem_budget(module: Module, run: LintRun) -> Iterable[Tuple[int, str]]:
    if module.endswith("kernels/fused_mlp.py"):
        return
    for node in ast.walk(module.tree):
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and "SMEM_BYTES" in t.id:
                yield (
                    node.lineno,
                    f"`{t.id}` (re)defined here — the shared memory a "
                    f"block may use is single-sourced in "
                    f"kernels.fused_mlp.SMEM_BYTES; import it",
                )


RULES = [
    Rule(
        "RPL001",
        "binarization/packing only through kernels.packed",
        "DESIGN.md §2",
        _check_manual_pack,
    ),
    Rule(
        "RPL003",
        "sign-convention literals only at blessed sites",
        "DESIGN.md §12",
        _check_sign_convention,
    ),
    Rule(
        "RPL007",
        "shared-memory budget single-sourced in kernels.fused_mlp",
        "DESIGN.md §6",
        _check_smem_budget,
    ),
]
