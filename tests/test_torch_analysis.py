"""The port's design-rule checking (``repro_torch.analysis``): the lint
gate and the auditor behind ``CompiledBNN.audit()``.

Pins: the gate (``python -m repro_torch.analysis --gate``) is clean on
``src/repro_torch`` and ``chip_smoke.py``; every rule of the port's
catalog fires on a corpus file of its own, written here into
``tmp_path`` (``tests/analysis_corpus`` is the reference's); the
catalog keeps the reference's IDs where the meaning is the same, adds
RPL011 (no ``jax``, no ``repro``) and has no RPL008 (the port never
donates); the lint engine imports only the stdlib.  The auditor passes
on BinaryNet and XNOR-AlexNet (its launch and int32-escape checks skip
on the CPU, where the wrappers take their plain versions) and fails on
a shared-memory claim broken after compile; the gpu-marked cases run it
on the card, where it must also fail on a planted int32 output.

    PYTHONPATH=src python -m pytest -q tests/test_torch_analysis.py
"""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis.rules import RULES_BY_ID as REF_RULES  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch.analysis import (lint_files, lint_paths,  # noqa: E402
                                  repo_root)
from repro_torch.analysis.audit import (AuditError,  # noqa: E402
                                        audit_compiled, banned_int32_shapes,
                                        expected_launches)
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID  # noqa: E402
from repro_torch.core.workloads import (alexnet_imagenet,  # noqa: E402
                                        binarynet_cifar10)
from repro_torch.kernels import fused_mlp  # noqa: E402

ROOT = repo_root()
MODELS = {"binarynet": binarynet_cifar10, "alexnet": alexnet_imagenet}

# rule id -> (path under tmp_path, source with one seeded violation)
CORPUS = {
    "RPL001": ("rpl001_manual_pack.py", """
        import torch

        def binarize(x):
            return torch.sign(x)

        def pack(x, shifts):
            bits = (x > 0).to(torch.int32)
            return torch.sum(bits << shifts, dim=-1, dtype=torch.int32)
        """),
    "RPL002": ("serving/loops.py", """
        def _dispatch_loop(self):
            while True:
                try:
                    self._tick()
                except BaseException:
                    continue
        """),
    "RPL003": ("rpl003_sign_literal.py", """
        import torch

        def decide(s):
            return torch.where(s >= 0, 1, -1)
        """),
    "RPL004": ("serving/server.py", """
        import threading

        class BNNServer:
            def __init__(self):
                self._stats_lock = threading.Lock()
                self._qlock = threading.Lock()
                self._n_batches = 0

            def _launch(self):
                with self._qlock:
                    self._n_batches += 1
        """),
    "RPL005": ("rpl005_shim_caller.py", """
        from repro_torch.models.layers import packed_mlp

        def serve(stack, xp, ts):
            return packed_mlp(stack, xp, ts)
        """),
    "RPL006": ("kernels/rpl006_layering.py", """
        from repro_torch.core.bnn_layers import binary_conv
        """),
    "RPL007": ("rpl007_smem_budget.py", """
        SMEM_BYTES = 227 * 1024
        """),
    "RPL009": ("serving/rpl009_wallclock.py", """
        import time

        def deadline(timeout):
            return time.time() + timeout
        """),
    "RPL010": ("rpl010_lock_cycle.py", """
        import threading

        class Engine:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()

            def one(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def two(self):
                with self._b_lock:
                    with self._a_lock:
                        pass
        """),
    "RPL011": ("rpl011_reference_import.py", """
        import jax.numpy as jnp
        from repro.kernels.packed import PackedArray
        """),
}


def _write(tmp_path, rule_id):
    rel, src = CORPUS[rule_id]
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src).lstrip())
    return path


def _gate_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return env


# ------------------------------------------------------------------ #
# the catalog and the gate                                             #
# ------------------------------------------------------------------ #
def test_catalog_is_complete_and_cited():
    assert set(RULES_BY_ID) == set(CORPUS)
    assert "RPL008" not in RULES_BY_ID          # the port never donates
    assert [r.rule_id for r in ALL_RULES] == sorted(RULES_BY_ID)
    for rule in ALL_RULES:
        assert rule.design_ref.startswith("DESIGN.md §"), rule.rule_id
        if rule.rule_id in REF_RULES:           # the reference's meaning
            assert rule.design_ref == REF_RULES[rule.rule_id].design_ref


@pytest.mark.parametrize("rule_id", sorted(CORPUS))
def test_rule_fires_on_its_corpus_file(tmp_path, rule_id):
    path = _write(tmp_path, rule_id)
    findings = lint_files([path], root=tmp_path)
    fired = {f.rule for f in findings}
    assert rule_id in fired, (
        f"{rule_id} stayed silent on {path.name}; fired: {sorted(fired)}")
    for f in findings:
        assert f.line > 0 and f.design_ref.startswith("DESIGN.md §")
        assert f.format().startswith(f"{f.rule} {f.path}:{f.line} ")


def test_tree_is_clean():
    """The gate's promise: zero findings on src/repro_torch,
    chip_smoke.py and the example twins."""
    twins = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(twins) == 4
    findings = lint_paths([ROOT / "src" / "repro_torch",
                           ROOT / "chip_smoke.py", *twins], root=ROOT)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_gate_cli_is_clean_on_the_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--gate"],
        capture_output=True, text=True, cwd=ROOT, env=_gate_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("rule_id", sorted(CORPUS))
def test_gate_cli_rejects_corpus_file(tmp_path, rule_id):
    path = _write(tmp_path, rule_id)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--gate", str(path)],
        capture_output=True, text=True, cwd=ROOT, env=_gate_env())
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert rule_id in proc.stdout and "DESIGN.md §" in proc.stdout


def test_gate_cli_list_rules_and_missing_path(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--list-rules"],
        capture_output=True, text=True, cwd=ROOT, env=_gate_env())
    assert proc.returncode == 0
    assert all(r in proc.stdout for r in CORPUS)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--gate",
         str(tmp_path / "none.py")],
        capture_output=True, text=True, cwd=ROOT, env=_gate_env())
    assert proc.returncode == 2


def test_lint_engine_imports_only_the_stdlib():
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.rules;"
            "bad = [m for m in ('torch', 'numpy', 'jax') if m in "
            "sys.modules]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=_gate_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_rules_keep_their_scope(tmp_path):
    """The sanctioned patterns stay silent: a kill-aware handler, the
    counter under its own lock, a sign literal at a blessed site, a
    layer importing downward, the budget imported."""
    files = {
        "serving/loops.py": """
            def _supervise_loop(self):
                while True:
                    try:
                        self._tick()
                    except BaseException as e:
                        if self._is_kill(e):
                            raise
                        continue
            """,
        "serving/server.py": """
            import threading

            class BNNServer:
                def __init__(self):
                    self._stats_lock = threading.Lock()
                    self._n_batches = 0

                def _launch(self):
                    with self._stats_lock:
                        self._n_batches += 1
            """,
        "core/binarize.py": """
            import torch

            def ste(x):
                return torch.where(x >= 0, 1.0, -1.0)
            """,
        "sim/simulator.py": """
            import torch
            from repro_torch.graph.compile import CompiledBNN

            def pm1(x):
                return torch.where(x > 0, 1, -1)
            """,
        "graph/uses_budget.py": """
            from repro_torch.kernels.fused_mlp import SMEM_BYTES
            """,
    }
    paths = []
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).lstrip())
        paths.append(p)
    assert lint_files(paths, root=tmp_path) == []
    # sim importing the serving layer is not a downward arrow
    bad = tmp_path / "sim" / "bad.py"
    bad.write_text("from repro_torch.serving import BNNServer\n")
    assert {f.rule for f in lint_files([bad], root=tmp_path)} == {"RPL006"}


# ------------------------------------------------------------------ #
# the auditor                                                          #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("model", sorted(MODELS))
def test_audit_passes_on_both_models(model):
    cb = tgraph.compile(MODELS[model](), device="cpu", batch=2)
    report = cb.audit()
    assert report.ok, report.format()
    assert [c.name for c in report.checks] == [
        "launches", "int32-escape", "plan-smem", "trace-bound", "donation"]
    skipped = {c.name for c in report.checks if c.skipped}
    assert skipped == {"launches", "int32-escape", "donation"}
    plan = report.checks[2]
    assert plan.ok and not plan.skipped
    claims = [s.args["smem_bytes"] for s in cb.plan if "smem_bytes" in s.args]
    assert len(claims) == sum(s.kind in ("binary_conv", "fused_stack")
                              for s in cb.plan)
    assert all(0 < c <= fused_mlp.SMEM_BYTES for c in claims)


def test_audit_fails_when_the_smem_claim_breaks(monkeypatch):
    """Shrink the shared memory a block may use after compile: the fused
    stack's claim no longer re-derives, and plan-smem must catch it."""
    cb = tgraph.compile(binarynet_cifar10(), device="cpu", batch=2)
    assert any(s.kind == "fused_stack" for s in cb.plan)
    monkeypatch.setattr(fused_mlp, "SMEM_BYTES", 100_000)
    report = audit_compiled(cb)
    assert [c.name for c in report.failures()] == ["plan-smem"], \
        report.format()
    with pytest.raises(AuditError, match="plan-smem"):
        cb.audit()


def test_audit_fails_on_a_tampered_claim():
    cb = tgraph.compile(alexnet_imagenet(), device="cpu", batch=2)
    i = next(i for i, s in enumerate(cb.plan) if s.kind == "binary_conv")
    cb.plan[i].args["smem_bytes"] = fused_mlp.SMEM_BYTES + 1
    assert "plan-smem" in {c.name for c in audit_compiled(cb).failures()}


def test_banned_shapes_and_launches_derive_from_plan():
    cb = tgraph.compile_dense_stack(64, [64, 48, 16], [True, True, False],
                                    device="cpu", batch=2)
    banned = banned_int32_shapes(cb, 2)
    assert (2, 64) in banned and (2, 48) in banned
    assert (2, 16) not in banned          # the logits head may be int32
    assert expected_launches(cb, 2) == {"fused_binary_mlp": 1,
                                        "popcount_gemm": 1}
    bn = tgraph.compile(binarynet_cifar10(), device="cpu", batch=2)
    assert expected_launches(bn, 256) == {"entry_conv": 1,
                                          "packed_conv2d": 5,
                                          "fused_binary_mlp": 1,
                                          "popcount_gemm": 1}
    assert (2, 32, 32, 128) in banned_int32_shapes(bn, 2)


def test_audit_takes_the_batch_from_x():
    cb = tgraph.compile_dense_stack(64, [48, 16], [True, False],
                                    device="cpu", batch=2)
    params = cb.init(torch.Generator().manual_seed(0))
    from repro_torch.kernels.packed import PackedArray
    x = PackedArray.pack(torch.randn(5, 64))
    assert cb.audit(params, x).batch == 5
    assert cb.audit(batch=3, max_batch=8).batch == 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
def test_gpu_audit_passes_and_fails_on_a_planted_int32(cuda, model,
                                                       monkeypatch):
    import importlib
    compile_mod = importlib.import_module("repro_torch.graph.compile")
    from repro_torch.kernels.ops import binarize_pack
    cb = tgraph.compile(MODELS[model](), device=cuda, batch=32)
    report = cb.audit()
    assert report.ok and not report.checks[0].skipped, report.format()
    assert report.launches == expected_launches(cb, 32)
    orig = compile_mod.binary_conv
    calls = []

    def unpacked(h, wf, fold=None, pack_out=False, backend=None, **kw):
        """The first conv's pack_out forced off: its int32 +-1 output,
        packed after."""
        calls.append(1)
        if len(calls) > 1:
            return orig(h, wf, fold=fold, pack_out=pack_out,
                        backend=backend, **kw)
        y = orig(h, wf, fold=fold, pack_out=False, backend=backend, **kw)
        return binarize_pack(y.to(torch.float32), backend=backend)
    monkeypatch.setattr(compile_mod, "binary_conv", unpacked)
    with pytest.raises(AuditError, match="int32-escape"):
        cb.audit()
