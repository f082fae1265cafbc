"""The port's tuning keys and tuning table (``repro_torch.kernels.autotune``,
``graph.passes.plan_tuning_keys`` / ``batches_tuning_keys``,
``CompiledBNN.tuning_keys_for_batch(es)``).

Pins: with an empty table every launch plan is the kernel's rule and
every plan step's key is the one ``plan_dense_launch`` /
``plan_conv_launch`` compute (the fused stack's is ``("fused_binary_mlp",
"cuda", m, k0, ns)``); a ``put`` entry changes the plan (``describe``
and the kernels' plan functions) and never the output; the keys of a
plan rescaled to another batch equal a fresh ``compile(batch=)``'s (the
reference's no-drift rule); the union over many batches is
deduplicated in first-seen order, like the reference's; an entry the
kernel cannot take raises at ``put`` and at ``load`` (and a bad file
leaves the table as it was); the table round-trips through JSON and the
``REPRO_TORCH_TUNING_TABLE`` variable (a missing path is ignored);
``autotune`` discards each candidate's first call and keeps the
fastest; ``BNNServer(prewarm=True)`` warms its levels' keys before it
captures a graph.  The gpu-marked case holds tuned plans bit for bit
against the rules' on the card.

    PYTHONPATH=src python -m pytest -q tests/test_torch_autotune.py
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import graph as jgraph  # noqa: E402
from repro.core.workloads import binarynet_cifar10 as jbinarynet  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch.core.workloads import (alexnet_imagenet,  # noqa: E402
                                        binarynet_cifar10)
from repro_torch.graph.passes import (batches_tuning_keys,  # noqa: E402
                                      plan_tuning_keys)
from repro_torch.kernels import (autotune, fused_mlp,  # noqa: E402
                                 packed_conv, popcount_gemm, xnor_gemm)
from repro_torch.kernels.ops import (plan_conv_launch,  # noqa: E402
                                     plan_dense_launch)
from repro_torch.kernels.packed import PackedArray  # noqa: E402
from repro_torch.serving import BNNServer, server  # noqa: E402
from repro_torch.serving.bucketing import dispatch_grid  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODELS = {"binarynet": binarynet_cifar10, "alexnet": alexnet_imagenet}
BATCHES = (1, 7, 32, 256)


@pytest.fixture(autouse=True)
def empty_table(monkeypatch):
    """Each test starts and ends with an empty table, and no file in the
    environment."""
    monkeypatch.delenv(autotune.ENV_TABLE, raising=False)
    table = autotune.get_table()
    table.clear()
    yield table
    table.clear()


def _rule_key(cb, step, batch):
    """The key of one plan step, computed from the launch-plan twins."""
    a = step.args
    if step.kind == "binary_conv":
        nd = cb.spec.conv_nodes[a["conv_idx"]]
        return plan_conv_launch(nd.h_in, nd.w_in, nd.c_in, nd.c_out, nd.kh,
                                nd.kw, stride=a["stride"], padding=a["pad"],
                                pack_out=True, impl=a["impl"],
                                nb=batch)["key"]
    dense = cb.spec.dense_nodes
    if step.kind == "dense":
        nd = dense[a["fc_idx"]]
        return plan_dense_launch(batch, nd.n_out, nd.n_in,
                                 pack_out=a["pack_out"])["key"]
    nds = [dense[j] for j in a["fc_indices"]]
    return ("fused_binary_mlp", "cuda", batch, nds[0].n_in,
            tuple(nd.n_out for nd in nds))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_empty_table_keys_and_plans_are_the_rules(model, batch):
    cb = tgraph.compile(MODELS[model](), device="cpu", batch=batch)
    launching = [s for s in cb.plan if s.kind in
                 ("binary_conv", "dense", "fused_stack")]
    assert len(cb.tuning_keys) == len(launching) == \
        cb.launch_count() - 1          # all but the pack
    for step in launching:
        key = _rule_key(cb, step, batch)
        assert step.keys == (key,)
        assert autotune.resolve(key) == autotune.resolve(key, tuned=False)
    # each kernel's plan function: the table changes nothing while empty
    for m, n, k32 in ((batch, 10, 32), (batch * 64, 256, 72)):
        for pack in (False, True):
            assert popcount_gemm.tile_plan(m, n, k32, 132, pack) == \
                popcount_gemm.tile_plan(m, n, k32, 132, pack, tuned=False)
            assert packed_conv.tile_plan(m, n, k32, 132, pack) == \
                packed_conv.tile_plan(m, n, k32, 132, pack, tuned=False)
            for planes in (1, 3):
                assert xnor_gemm.tile_plan(m, n, k32, planes=planes,
                                           pack_out=pack) == \
                    xnor_gemm.tile_plan(m, n, k32, planes=planes,
                                        pack_out=pack, tuned=False)


def test_keys_follow_the_reference_ops():
    """The port's keys name the reference's ops (``+pack`` for a fused
    epilogue) in the same order, the fused stack under its own op."""
    jcb = jgraph.compile(jbinarynet(), backend="xla", batch=4)
    cb = tgraph.compile(binarynet_cifar10(), device="cpu", batch=4)
    jops = [k[0] for k in jcb.tuning_keys]
    ops = [k[0] for k in cb.tuning_keys]
    assert ops[:5] == jops[:5] == ["packed_conv+pack"] * 5
    assert ops[5:] == ["fused_binary_mlp", "popcount_gemm"]
    assert jops[-1] == "popcount_gemm"
    # the port pads nothing: the head's key is the launch's own (M, N,
    # K32), where the reference's carries its TPU padding
    assert cb.tuning_keys[-1][2:] == (4, 10, 32)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_keys_for_a_batch_equal_a_fresh_compile(model):
    cb = tgraph.compile(MODELS[model](), device="cpu", batch=4)
    for b in (1, 2, 3, 4, 5, 17, 64, 256):
        fresh = tgraph.compile(MODELS[model](), device="cpu", batch=b)
        assert cb.tuning_keys_for_batch(b) == fresh.tuning_keys
        assert plan_tuning_keys(cb.spec, cb.plan, b) == fresh.tuning_keys
    assert cb.tuning_keys_for_batch(4) is cb.tuning_keys


def test_union_is_deduplicated_in_first_seen_order():
    cb = tgraph.compile(binarynet_cifar10(), device="cpu", batch=8)
    levels = sorted({v for _, v in dispatch_grid(64)})
    keys = cb.tuning_keys_for_batches(levels + levels[::-1])
    assert len(keys) == len(set(keys))
    want = []
    for b in levels:
        for k in cb.tuning_keys_for_batch(b):
            if k not in want:
                want.append(k)
    assert list(keys) == want
    assert batches_tuning_keys(cb.spec, cb.plan, levels) == keys
    # the conv key's M is the launch's pixels, so levels differ
    assert len(keys) == len(levels) * len(cb.tuning_keys)


def test_a_put_entry_changes_the_plan_and_not_the_output(empty_table):
    cb = tgraph.compile(binarynet_cifar10(), device="cpu", batch=2)
    params = cb.init(torch.Generator().manual_seed(0))
    x = torch.randint(-3, 4, (2, 32, 32, 3)).to(torch.float32)
    want = cb.apply(params, x)
    conv2, fused, head = (cb.tuning_keys[0], cb.tuning_keys[5],
                          cb.tuning_keys[6])
    assert autotune.resolve(conv2)["bm"] == 64     # batch 2: the rule
    empty_table.put(conv2, {"bm": 128, "bn": 128})
    empty_table.put(fused, {"bm": 32, "cs": 8})
    empty_table.put(head, {"bm": 64, "bn": 32, "wk": 2})
    m, f, k32 = conv2[2:]
    assert packed_conv.tile_plan(m, f, k32, 132, True)["bm"] == 128
    assert popcount_gemm.tile_plan(*head[2:], 132)["bn"] == 32
    assert autotune.resolve(fused) == {"bm": 32, "cs": 8}
    retuned = tgraph.compile(binarynet_cifar10(), device="cpu", batch=2)
    assert "tile 128x128" in retuned.describe().splitlines()[3]
    assert retuned.tuning_keys == cb.tuning_keys
    assert torch.equal(retuned.apply(params, x), want)


@pytest.mark.parametrize("key,entry,why", [
    (("packed_conv+pack", "cuda", 64, 128, 36), {"bm": 32, "bn": 128},
     "TILES"),
    (("popcount_gemm+pack", "cuda", 4, 64, 2), {"bm": 16, "bn": 8, "wk": 4},
     ">= 32"),
    (("popcount_gemm", "cuda", 4, 64, 2), {"bm": 16, "bn": 16, "wk": 4},
     "TILES"),
    (("xnor_gemm", "cuda", 128, 4096, 128), {"bm": 64, "bn": 128,
                                              "splits": 9}, "splits"),
    (("fused_binary_mlp", "cuda", 256, 8192, (1024, 1024)),
     {"bm": 64, "cs": 16}, "shared memory"),
    (("fused_binary_mlp", "cuda", 4, 64, (32,) * 9), {"bm": 16, "cs": 16},
     "8 layers"),
    (("packed_conv", "cuda", 64, 128, 36), {"bm": 64}, "entry must be"),
    (("packed_conv", "torch", 64, 128, 36), {"bm": 64, "bn": 64}, "cuda"),
    (("pack", "cuda", 64, 128, 36), {"bm": 64, "bn": 64}, "no tunable"),
])
def test_bad_entries_raise_at_put_and_load(empty_table, tmp_path, key,
                                          entry, why):
    with pytest.raises(ValueError, match=why):
        empty_table.put(key, entry)
    good = ("popcount_gemm", "cuda", 4, 10, 32)
    empty_table.put(good, {"bm": 16, "bn": 8, "wk": 4})
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({
        autotune.key_str(good): {"bm": 64, "bn": 64, "wk": 1},
        autotune.key_str(key): entry}))
    with pytest.raises(ValueError, match=why):
        empty_table.load(str(path))
    # nothing of a refused file is taken
    assert empty_table.get(good) == {"bm": 16, "bn": 8, "wk": 4}
    assert len(empty_table) == 1


def test_table_round_trips_and_loads_from_the_environment(
        empty_table, tmp_path, monkeypatch):
    keys = {("packed_conv+pack", "cuda", 2048, 512, 72): {"bm": 64,
                                                          "bn": 64},
            ("fused_binary_mlp", "cuda", 1, 64, (48,)): {"bm": 16,
                                                        "cs": 8},
            ("xnor_gemm_f32+pack", "cuda", 1, 8192, 256): {
                "bm": 16, "bn": 64, "splits": 4}}
    for k, e in keys.items():
        empty_table.put(k, e)
    path = tmp_path / "t.json"
    empty_table.save(str(path))
    raw = json.loads(path.read_text())
    assert "fused_binary_mlp|cuda|1|64|48," in raw
    empty_table.clear()
    empty_table.load(str(path))
    assert {k: empty_table.get(k) for k in keys} == keys
    # a fresh table reads the variable on first use; a missing path is
    # ignored, a malformed file raises
    monkeypatch.setenv(autotune.ENV_TABLE, str(path))
    fresh = autotune.TuningTable()
    assert fresh.get(next(iter(keys))) == {"bm": 64, "bn": 64}
    monkeypatch.setenv(autotune.ENV_TABLE, str(tmp_path / "none.json"))
    assert autotune.TuningTable().get(next(iter(keys))) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv(autotune.ENV_TABLE, str(bad))
    with pytest.raises(json.JSONDecodeError):
        autotune.TuningTable().get(next(iter(keys)))
    with pytest.raises(ValueError, match="malformed"):
        empty_table._entries.clear()
        bad.write_text(json.dumps({"popcount_gemm|cuda": {}}))
        empty_table.load(str(bad))


def test_reference_variable_is_never_read(empty_table, tmp_path,
                                          monkeypatch):
    path = tmp_path / "ref.json"
    path.write_text(json.dumps({"popcount_gemm|pallas|8|128|4":
                                {"bm": 8, "bn": 128, "bk32": 4}}))
    monkeypatch.setenv("REPRO_TUNING_TABLE", str(path))
    assert len(autotune.TuningTable()) == 0


def test_candidates_are_what_the_kernel_takes():
    assert all(c["bn"] >= 32 for c in autotune.candidates(
        ("popcount_gemm+pack", "cuda", 4, 64, 2)))
    assert len(autotune.candidates(("popcount_gemm", "cuda", 4, 64, 2))) \
        == len(popcount_gemm.TILES)
    fused = autotune.candidates(("fused_binary_mlp", "cuda", 256, 8192,
                                 (1024, 1024)))
    assert {(c["bm"], c["cs"]) for c in fused} == {
        (bm, cs) for bm in (16, 32) for cs in fused_mlp.CLUSTERS}
    xn = autotune.candidates(("xnor_gemm", "cuda", 1, 8192, 256))
    assert {c["splits"] for c in xn} == set(range(1, 9))
    assert all(-(-256 // c["splits"]) >= xnor_gemm.MIN_SPLIT_WORDS
               for c in xn)


def test_autotune_discards_the_first_call_and_keeps_the_fastest(
        empty_table):
    key = ("popcount_gemm", "cuda", 4, 10, 32)
    calls = []

    def runner(e):
        calls.append(tuple(e.values()))
        if e["bm"] == 64:
            time.sleep(0.002)
    res = autotune.autotune(key, runner, iters=2, reps=3)
    assert res.entry["bm"] == 16 and empty_table.get(key) == res.entry
    assert len(res.times) == len(popcount_gemm.TILES)
    for t in popcount_gemm.TILES:
        assert calls.count(t) == 1 + 2 * 3
    slow = [ms for e, ms in res.times if e["bm"] == 64]
    assert min(slow) >= 2.0 > res.ms
    with pytest.raises(ValueError, match="TILES"):
        autotune.autotune(key, runner, entries=[{"bm": 1, "bn": 1,
                                                 "wk": 1}])


def test_prewarm_warms_every_level_before_any_capture(monkeypatch):
    cb = tgraph.compile_dense_stack(64, [48, 16], [True, False],
                                    device="cpu", batch=4)
    params = cb.init(torch.Generator().manual_seed(0))
    seen = []

    def warm(keys, device=None):
        seen.append((tuple(keys), device, len(srv_graphs)))
        return {}
    srv_graphs = []
    orig = server.GraphedApply

    def graphed(*a, **kw):
        srv_graphs.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(server, "warm", warm)
    monkeypatch.setattr(server, "GraphedApply", graphed)
    srv = BNNServer(cb, params, max_batch=8, prewarm=True, device="cpu")
    levels = sorted({v for _, v in dispatch_grid(8)})
    assert seen == [(cb.tuning_keys_for_batches(levels),
                     torch.device("cpu"), 0)]
    assert srv.jit_traces() == srv.trace_bound() == len(srv_graphs)
    xp = PackedArray.pack(torch.randn(3, 64))
    assert torch.equal(srv.apply_batch(xp), cb.apply(params, xp))


def test_tuner_cli_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is here: the CLI would tune")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.autotune", "--out",
         "unused.json"], capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MODELS))
def test_gpu_tuned_apply_equals_the_rules(cuda, empty_table, model):
    """Every key of the plan at batches 1 and 32 put to a plan that is
    not the rule's: the logits are bit for bit the rules'."""
    params = None
    for batch in (1, 32):
        cb = tgraph.compile(MODELS[model](), device=cuda, batch=batch)
        if params is None:
            params = cb.init(torch.Generator().manual_seed(0))
        h, w, c = cb.spec.input_shape
        x = torch.randint(-3, 4, (batch, h, w, c)).to(torch.float32).cuda()
        want = cb.apply(params, x)
        for key in cb.tuning_keys:
            rule = autotune.resolve(key, cuda, tuned=False)
            other = [e for e in autotune.candidates(key) if e != rule]
            if other:
                empty_table.put(key, other[-1])
        assert torch.equal(cb.apply(params, x), want)
        empty_table.clear()
