"""The port's serving engine on the CPU, against the reference's.

``repro_torch.serving.BNNServer`` with ``device="cpu"`` serves the same
params (carried across by ``params_from_numpy``) and the same requests
as ``repro.serving.BNNServer`` on the jax CPU backend: words and logits
must be equal bit for bit, and the counters of ``stats()`` equal but
for its timings.  Also: the bucketing copy equals the reference's for
every ``max_batch`` in 1..512, masked ``apply(valid_rows=)`` equals the
reference's, graphs stay within ``trace_bound``, the caller's buffer is
never written, the queue drains, and ``stop`` resolves what is in
flight.

    PYTHONPATH=src python -m pytest -q tests/test_torch_serving.py
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import graph as jgraph  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.kernels.ops import binarize_pack as jbinarize_pack  # noqa: E402
from repro.kernels.packed import PackedArray as JPacked  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.graph.replay import GraphedApply, kind_of  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ops import binarize_pack  # noqa: E402
from repro_torch.kernels.packed import PackedArray, as_uint32  # noqa: E402
from repro_torch.serving import BNNServer  # noqa: E402


def np_tree(tree):
    """The reference params with every leaf as numpy."""
    if isinstance(tree, JPacked):
        return {"words": np.asarray(tree.words), "length": tree.length,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


def _mlp(max_batch=8, backend="torch", d0=256, hidden=(128, 64), **kw):
    """The reference's and the port's servers over one dense stack and
    the same params: (jax compiled, jax params, jax server, port
    compiled, port params, port server)."""
    jcb = jgraph.compile(jgraph.from_dense_stack(d0, list(hidden),
                                                 name="srv_mlp"),
                         backend="xla", batch=4)
    jparams = jcb.init(jax.random.PRNGKey(0))
    jsrv = jserving.BNNServer(jcb, jparams, max_batch=max_batch, **kw)
    tcb = tgraph.compile(tgraph.from_dense_stack(d0, list(hidden),
                                                 name="srv_mlp"),
                         backend=backend, device="cpu", batch=4)
    tparams = params_from_numpy(np_tree(jparams), "cpu")
    tsrv = BNNServer(tcb, tparams, max_batch=max_batch, device="cpu", **kw)
    return jcb, jparams, jsrv, tcb, tparams, tsrv


def _pair(rng, rows, d0=256):
    """The same packed request for both servers (the two packers agree
    bit for bit, which is asserted)."""
    x = rng.normal(size=(rows, d0)).astype(np.float32)
    jx = jbinarize_pack(jnp.asarray(x), backend="xla")
    tx = binarize_pack(torch.from_numpy(x), backend="torch")
    np.testing.assert_array_equal(as_uint32(tx.words), np.asarray(jx.words))
    return jx, tx


def _same_words(got, want):
    np.testing.assert_array_equal(as_uint32(got.words),
                                  np.asarray(want.words))
    assert got.length == want.length and got.axis == want.axis


def _small_conv(g):
    """A narrow conv spec: float entry conv, binary convs, a pool, a
    fused dense stack and a logits head (integer images keep the float
    entry conv exact in any order)."""
    nodes = [g.IntegerEntry("conv1", 3, 3, 3, 32, 8, 8, 8, 8, 1, 1),
             g.Binarize("binarize@conv2"),
             g.BinaryConv("conv2", 3, 3, 32, 64, 8, 8, 8, 8, 1, 1),
             g.BNThreshold("conv2.bn", 64),
             g.MaxPool("pool@conv2", 2, 2),
             g.BinaryConv("conv3", 3, 3, 64, 32, 4, 4, 4, 4, 1, 1),
             g.BNThreshold("conv3.bn", 32),
             g.BinaryDense("fc1", 512, 48), g.BNThreshold("fc1.bn", 48),
             g.BinaryDense("fc2", 48, 40), g.BNThreshold("fc2.bn", 40),
             g.BinaryDense("fc3", 40, 10), g.Logits("logits", 10)]
    spec = g.BNNSpec("small", (8, 8, 3), tuple(nodes))
    spec.validate()
    return spec


@pytest.fixture(scope="module")
def conv_pair():
    jcb = jgraph.compile(_small_conv(jgraph), backend="xla", batch=4)
    jparams = jcb.init(jax.random.PRNGKey(3))
    tcb = tgraph.compile(_small_conv(tgraph), backend="torch", device="cpu",
                         batch=4)
    return jcb, jparams, tcb, params_from_numpy(np_tree(jparams), "cpu")


def _images(rng, n):
    return rng.integers(-3, 4, size=(n, 8, 8, 3)).astype(np.float32)


# ------------------------------------------------------------------ #
# the bucketing copy                                                   #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("max_batch", range(1, 513))
def test_bucketing_equals_reference(max_batch):
    mb = tserving.pow2_ceil(max_batch)
    assert mb == jserving.pow2_ceil(max_batch)
    assert tserving.bucket_sizes(mb) == jserving.bucket_sizes(mb)
    assert tserving.dispatch_grid(mb) == jserving.dispatch_grid(mb)
    for ragged in (False, True):
        assert tserving.trace_bound(mb, ragged) == \
            jserving.trace_bound(mb, ragged)
    for b in tserving.bucket_sizes(mb):
        assert tserving.mask_step(b) == jserving.mask_step(b)
        assert tserving.mask_levels(b) == jserving.mask_levels(b)
    for n in range(1, mb + 1):
        b = tserving.bucket_for(n, mb)
        assert b == jserving.bucket_for(n, mb)
        assert tserving.ragged_valid(n, b) == jserving.ragged_valid(n, b)
    for n in (1, max_batch, max_batch + 1, 3 * max_batch + 2):
        assert tserving.split_rows(n, max_batch) == \
            jserving.split_rows(n, max_batch)
    for fn, args in ((tserving.bucket_for, (mb + 1, mb)),
                     (tserving.split_rows, (0, max_batch)),
                     (tserving.ragged_valid, (0, mb))):
        with pytest.raises(ValueError):
            fn(*args)


# ------------------------------------------------------------------ #
# masked apply and the graphed apply's CPU entry point                 #
# ------------------------------------------------------------------ #
def test_masked_apply_equals_reference():
    jcb, jparams, _, tcb, tparams, _ = _mlp()
    jx, tx = _pair(np.random.default_rng(9), 8)
    for r in (1, 3, 5, 8):
        _same_words(tcb.apply(tparams, tx, valid_rows=r),
                    jcb.apply(jparams, jx, valid_rows=r))


def test_masked_conv_apply_equals_reference(conv_pair):
    jcb, jparams, tcb, tparams = conv_pair
    x = _images(np.random.default_rng(2), 4)
    want = np.asarray(jcb.apply(jparams, x, valid_rows=3))
    got = tcb.apply(tparams, torch.from_numpy(x), valid_rows=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_graphed_apply_on_the_cpu_pads_and_masks(conv_pair):
    _, _, tcb, tparams = conv_pair
    x = torch.from_numpy(_images(np.random.default_rng(4), 5))
    g = GraphedApply(tcb, tparams, batch=8, valid_rows=6)
    assert g.graph is None and g.kind == kind_of(x)
    got = g(x)
    assert got.shape == (6, 10)
    padded = torch.cat([x, torch.zeros(3, 8, 8, 3)])
    assert torch.equal(got, tcb.apply(tparams, padded, valid_rows=6))
    assert torch.equal(got[:5], tcb.apply(tparams, x))
    with pytest.raises(ValueError):
        g(torch.zeros(7, 8, 8, 3))                  # more than valid_rows
    with pytest.raises(ValueError):
        g(torch.zeros(2, 8, 8, 3, dtype=torch.float64))


def test_with_backend_recompiles_same_spec():
    cb = tgraph.compile(tgraph.from_dense_stack(64, [32], name="wb"),
                        device="cpu", batch=2)
    assert cb.backend == "cuda"
    assert cb.with_backend("cuda") is cb and cb.with_backend(None) is cb
    fb = cb.with_backend("torch")
    assert fb.backend == "torch" and fb.spec is cb.spec
    assert fb.batch == cb.batch and fb.device == cb.device


# ------------------------------------------------------------------ #
# the port's server against the reference's                          #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_apply_batch_equals_reference_server(backend):
    _, _, jsrv, _, _, tsrv = _mlp(backend=backend)
    rng = np.random.default_rng(0)
    for rows in (1, 3, 8, 5, 11, 17):
        jx, tx = _pair(rng, rows)
        _same_words(tsrv.apply_batch(tx), jsrv.apply_batch(jx))
    assert tsrv.jit_traces() <= tsrv.trace_bound()


def _counters(st):
    """stats() without its timings (``host_ns`` is the port's alone),
    and without ``jit_traces``: the reference reads that from jax's jit
    cache, which may key one level twice (a numpy and a jax array of
    the same shape); the port's graphs are held against the reference's
    own set of dispatched levels instead (``_same_levels``)."""
    return {k: v for k, v in st.items()
            if k not in ("latency_s", "queue_wait_s", "host_ns",
                         "straggler_flags", "straggler_median_s",
                         "jit_traces")}


def _same_levels(tsrv, jsrv):
    """One graph per (bucket, valid) level the reference dispatched
    (its trace keys also hold the input kind, which is one per spec)."""
    assert tsrv.jit_traces() == len(jsrv._traced)
    assert sorted(tsrv._graphs) == sorted((b, v) for b, v, _ in jsrv._traced)


def test_submit_flush_and_stats_equal_reference_server():
    _, _, jsrv, _, _, tsrv = _mlp()
    rng = np.random.default_rng(5)
    pairs = [_pair(rng, r) for r in (2, 2, 2, 2, 5, 3, 8, 1, 11, 4)]
    jf = [jsrv.submit(j) for j, _ in pairs]
    tf = [tsrv.submit(t) for _, t in pairs]
    assert tsrv.flush() == jsrv.flush()
    for a, b in zip(tf, jf):
        _same_words(a.result(timeout=5), b.result(timeout=5))
    for rows in (3, 8, 1):                          # and synchronous calls
        jx, tx = _pair(rng, rows)
        _same_words(tsrv.apply_batch(tx), jsrv.apply_batch(jx))
    tst, jst = tsrv.stats(), jsrv.stats()
    assert _counters(tst) == _counters(jst)
    _same_levels(tsrv, jsrv)
    assert tst["hbm_bytes"] > 0 and tst["jit_traces"] > 0


def test_conv_server_logits_equal_reference(conv_pair):
    jcb, jparams, tcb, tparams = conv_pair
    jsrv = jserving.BNNServer(jcb, jparams, max_batch=4)
    tsrv = BNNServer(tcb, tparams, max_batch=4, device="cpu")
    rng = np.random.default_rng(6)
    xs = [_images(rng, r) for r in (1, 3, 4, 6)]
    for x in xs:
        np.testing.assert_array_equal(
            tsrv.apply_batch(torch.from_numpy(x)).numpy(),
            np.asarray(jsrv.apply_batch(x)))
    tf = [tsrv.submit(torch.from_numpy(x)) for x in xs]
    jf = [jsrv.submit(x) for x in xs]
    tsrv.flush()
    jsrv.flush()
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a.result().numpy(),
                                      np.asarray(b.result()))
    assert _counters(tsrv.stats()) == _counters(jsrv.stats())
    _same_levels(tsrv, jsrv)


# ------------------------------------------------------------------ #
# bounds, chunking, accounting                                         #
# ------------------------------------------------------------------ #
def test_graphs_bounded_by_dispatch_grid():
    _, _, _, _, _, srv = _mlp()
    rng = np.random.default_rng(1)
    for rows in (1, 2, 3, 4, 5, 6, 7, 8, 1, 5, 8):
        srv.apply_batch(_pair(rng, rows)[1])
    assert srv.stats()["buckets_traced"] == [1, 2, 4, 8]
    assert srv.jit_traces() <= srv.trace_bound() == \
        tserving.trace_bound(8, ragged=True)
    before = srv.jit_traces()
    for rows in range(1, 9):
        srv.apply_batch(_pair(rng, rows)[1])
    assert srv.jit_traces() == before
    assert srv.stats()["bucket_hits"] >= 8


def test_oversized_request_chunks_through_max_batch():
    _, _, _, tcb, tparams, srv = _mlp(max_batch=4)
    _, tx = _pair(np.random.default_rng(2), 11)     # 4 + 4 + 3
    got = srv.apply_batch(tx)
    assert torch.equal(got.words, tcb.apply(tparams, tx).words)
    st = srv.stats()
    assert st["batches"] == 3 and st["rows"] == 11
    assert srv.jit_traces() <= tserving.trace_bound(4, ragged=True)


def test_stats_occupancy_and_traffic_accounting():
    _, _, _, tcb, _, srv = _mlp()
    srv.apply_batch(_pair(np.random.default_rng(3), 3)[1])  # bucket 4
    st = srv.stats()
    assert st["padded_rows"] == 4 and st["real_rows"] == 3
    assert st["valid_rows"] == 3
    assert st["occupancy"] == pytest.approx(0.75)
    assert st["compute_occupancy"] == pytest.approx(1.0)
    assert st["hbm_bytes"] == tcb.traffic(batch=3)["packed_bytes"]
    assert st["devices"] == 1 and st["latency_s"]["max"] > 0


def test_prewarm_captures_every_dispatch_level():
    _, _, _, _, _, srv = _mlp(prewarm=True)
    assert srv.jit_traces() == srv.trace_bound() == \
        len(tserving.dispatch_grid(8))
    assert srv.stats()["buckets_traced"] == [1, 2, 4, 8]
    srv.apply_batch(_pair(np.random.default_rng(4), 5)[1])
    assert srv.jit_traces() == srv.trace_bound()    # a hit, no capture
    assert srv.stats()["bucket_hits"] == 1


# ------------------------------------------------------------------ #
# buffers and placement                                                #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("rows", [8, 5, 11])
def test_caller_buffer_never_written(rows):
    _, _, _, tcb, tparams, srv = _mlp()
    _, tx = _pair(np.random.default_rng(10), rows)
    before = tx.words.clone()
    ref = tcb.apply(tparams, tx)
    srv.apply_batch(tx)
    fut = srv.submit(tx)
    srv.flush()
    assert torch.equal(tx.words, before)
    assert torch.equal(fut.result().words, ref.words)
    assert torch.equal(srv.apply_batch(tx).words, ref.words)


def test_placement_is_one_device():
    """Without a mesh, placement moves trees to one device; a mesh that
    is not a Mesh is refused everywhere."""
    x = torch.arange(8, dtype=torch.int32)
    tree = {"a": x, "b": [PackedArray(x.clone(), 200)],
            "c": np.arange(3)}
    cp = tserving.ensure_owned(tree)
    assert cp["a"] is not x and torch.equal(cp["a"], x)
    assert cp["a"].data_ptr() != x.data_ptr()
    assert cp["b"][0].length == 200
    moved = tserving.replicate(tree, torch.device("cpu"))
    assert torch.equal(moved["c"], torch.arange(3))
    assert tserving.shard_batch(x, torch.device("cpu")) is x
    for fn in (tserving.replicate, tserving.shard_batch):
        with pytest.raises(TypeError, match="Mesh"):
            fn(tree, torch.device("cpu"), mesh=object())
    cb = tgraph.compile(tgraph.from_dense_stack(64, [32]), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        BNNServer(cb, cb.init(torch.Generator().manual_seed(0)),
                  mesh=object(), device="cpu")


CPU4 = [torch.device("cpu")] * 4                   # 4 slots, one device


def test_placement_on_a_mesh_holds_pieces_and_copies():
    mesh = tserving.data_mesh(devices=CPU4)
    assert mesh.shape == {"data": 4, "model": 1} and mesh.size == 4
    x = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    xp = PackedArray(x.clone(), 96)
    pieces = tserving.shard_batch({"x": x, "p": [xp]}, mesh=mesh)
    assert len(pieces) == 4
    for i, piece in enumerate(pieces):
        assert torch.equal(piece["x"], x[2 * i:2 * i + 2])
        assert torch.equal(piece["p"][0].words, x[2 * i:2 * i + 2])
        assert piece["p"][0].length == 96
    # rows the mesh does not divide are replicated: every slot, all rows
    assert all(torch.equal(p, x[:3])
               for p in tserving.shard_batch(x[:3], mesh=mesh))
    # 2 x 2: rows split over "data" only, copies along "model"
    mesh22 = tserving.data_mesh(model=2, devices=CPU4)
    assert mesh22.shape == {"data": 2, "model": 2}
    got = [p.tolist() for p in tserving.shard_batch(x, mesh=mesh22)]
    assert got == [x[:4].tolist()] * 2 + [x[4:].tolist()] * 2
    copies = tserving.replicate({"w": x, "p": xp}, mesh=mesh)
    assert list(copies) == [torch.device("cpu")]       # one per device
    assert torch.equal(copies[torch.device("cpu")]["p"].words, x)
    with pytest.raises(ValueError, match="model=3"):
        tserving.data_mesh(model=3, devices=CPU4)


def _mesh_dense_server(max_batch=8):
    jcb, jparams, _, tcb, tparams, _ = _mlp(max_batch=max_batch,
                                            backend="cuda")
    mesh = tserving.data_mesh(devices=CPU4)
    srv = BNNServer(tcb, tparams, max_batch=max_batch, mesh=mesh,
                    device="cpu")
    return jcb, jparams, tcb, tparams, srv


def test_sharded_packed_words_bit_identical():
    """The reference's sharded test on a 4-slot CPU mesh: the dense
    stack's packed words at 1, 2, 3, 4, 8 and 11 rows (3 and 11 do not
    divide the mesh) equal the single-device apply of both packages."""
    jcb, jparams, tcb, tparams, srv = _mesh_dense_server()
    one = BNNServer(tcb, tparams, max_batch=8, device="cpu")
    rng = np.random.default_rng(7)
    for rows in (1, 2, 3, 4, 8, 11):
        jx, tx = _pair(rng, rows)
        got = srv.apply_batch(tx)
        assert torch.equal(got.words, tcb.apply(tparams, tx).words)
        assert torch.equal(got.words, one.apply_batch(tx).words)
        _same_words(got, jcb.apply(jparams, jx))
    assert srv.stats()["devices"] == srv.mesh.size == 4
    assert srv.jit_traces() <= srv.trace_bound()
    # 1 and 2 rows run whole on slot 0; 3 and 4 one row a slot; 8 two;
    # 11 = 8 + 3
    assert [s["rows"] for s in srv.slots()] == [10, 7, 7, 5]
    assert srv.split(2) == [(0, 0, 2, 2, 2)]
    assert [p[:3] for p in srv.split(3)] == [(0, 0, 1), (1, 1, 2),
                                             (2, 2, 3)]
    assert [p[:3] for p in srv.split(7)] == [(0, 0, 2), (1, 2, 4),
                                             (2, 4, 6), (3, 6, 7)]
    assert all(p[3] == 2 and 1 <= p[4] <= 2 for p in srv.split(7))


def test_sharded_binarynet_logits_bit_identical():
    """BinaryNet through a 4-slot CPU mesh at max_batch 4: 3 rows (one
    a slot, the fourth slot idle) equal the single-device apply of both
    packages exactly, one dispatch level captured."""
    from repro.core.workloads import binarynet_cifar10 as jbinarynet
    from repro_torch.core.workloads import binarynet_cifar10
    jcb = jgraph.compile(jbinarynet(), backend="xla", batch=4)
    jparams = jcb.init(jax.random.PRNGKey(0))
    tcb = tgraph.compile(binarynet_cifar10(), device="cpu", batch=4)
    tparams = params_from_numpy(np_tree(jparams), "cpu")
    srv = BNNServer(tcb, tparams, max_batch=4,
                    mesh=tserving.data_mesh(devices=CPU4), device="cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, 32, 32, 3),
                                   jnp.float32))
    got = srv.apply_batch(torch.from_numpy(x))
    assert torch.equal(got, tcb.apply(tparams, torch.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcb.apply(jparams, x)))
    assert srv.jit_traces() <= 1
    assert [s["rows"] for s in srv.slots()] == [1, 1, 1, 0]


def test_mesh_server_queue_and_degraded_step():
    """Submitted requests coalesce and split over the mesh like
    synchronous ones; a forced backend fault takes the degraded step
    whole on the first slot."""
    from repro_torch.robustness import ChaosMonkey
    jcb, jparams, tcb, tparams, _ = _mesh_dense_server()
    chaos = ChaosMonkey()
    srv = BNNServer(tcb, tparams, max_batch=8, chaos=chaos,
                    mesh=tserving.data_mesh(devices=CPU4), device="cpu")
    rng = np.random.default_rng(11)
    pairs = [_pair(rng, r) for r in (2, 5, 1, 8, 3)]
    futs = [srv.submit(t) for _, t in pairs]
    srv.flush()
    for f, (jx, tx) in zip(futs, pairs):
        _same_words(f.result(timeout=5), jcb.apply(jparams, jx))
    chaos.fail_next(tserving.BackendFault("forced"))
    jx, tx = pairs[1]
    fut = srv.submit(tx)
    srv.flush()
    _same_words(fut.result(timeout=5), jcb.apply(jparams, jx))
    assert srv.stats()["faults"]["backend_fallbacks"] == 1


def test_mesh_server_refusals():
    cb = tgraph.compile(tgraph.from_dense_stack(64, [32]), device="cpu")
    params = cb.init(torch.Generator().manual_seed(0))
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="shape-only"):
        BNNServer(cb, params, mesh=make_production_mesh(), device="cpu")
    mesh = tserving.data_mesh(devices=CPU4)
    with pytest.raises(ValueError, match="runs on"):
        BNNServer(tgraph.compile(tgraph.from_dense_stack(64, [32]),
                                 device="meta"), params, mesh=mesh)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _counts_of(fn):
    """The port's kernel launches one call of ``fn`` makes on the card."""
    _build.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in _build.launch_counts().items() if v}


def _mesh_twin(srv, cb, params, xs):
    """Every payload through the (prewarmed) mesh server equals
    ``cb.apply`` on the card bit for bit, and each flight launches one
    forward's kernels on every slot that received rows."""
    for x in xs:
        rows = int((x.words if isinstance(x, PackedArray) else x).shape[0])
        want = cb.apply(params, x)
        one = _counts_of(lambda: cb.apply(params, x))
        got = []
        counts = _counts_of(lambda: got.append(srv.apply_batch(x)))
        wt = want.words if isinstance(want, PackedArray) else want
        gt = got[0].words if isinstance(got[0], PackedArray) else got[0]
        assert gt.device == wt.device and torch.equal(gt, wt), rows
        assert counts == {k: v * len(srv.split(rows))
                          for k, v in one.items()}, rows


@pytest.mark.gpu
def test_gpu_sharded_packed_words_bit_identical(cuda):
    cb = tgraph.compile(tgraph.from_dense_stack(256, [128, 64]),
                        device=cuda, batch=4)
    params = cb.init(torch.Generator().manual_seed(0))
    srv = BNNServer(cb, params, max_batch=8, prewarm=True,
                    mesh=tserving.data_mesh(devices=[cuda] * 4))
    gen = torch.Generator().manual_seed(7)
    xs = [binarize_pack(torch.randn(rows, 256, generator=gen).to(cuda))
          for rows in (1, 2, 3, 4, 8)]
    _mesh_twin(srv, cb, params, xs)
    x11 = binarize_pack(torch.randn(11, 256, generator=gen).to(cuda))
    assert torch.equal(srv.apply_batch(x11).words,
                       cb.apply(params, x11).words)
    assert srv.stats()["devices"] == 4
    assert srv.jit_traces() <= srv.trace_bound()


@pytest.mark.gpu
def test_gpu_sharded_binarynet_logits_bit_identical(cuda):
    from repro_torch.core.workloads import binarynet_cifar10
    cb = tgraph.compile(binarynet_cifar10(), device=cuda, batch=4)
    params = cb.init(torch.Generator().manual_seed(0))
    srv = BNNServer(cb, params, max_batch=4, prewarm=True,
                    mesh=tserving.data_mesh(devices=[cuda] * 4))
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    _mesh_twin(srv, cb, params, [x.to(cuda)])
    assert srv.jit_traces() == srv.trace_bound()    # prewarmed, no more
    assert [s["rows"] for s in srv.slots()] == [1, 1, 1, 0]


@pytest.mark.gpu
def test_gpu_mesh_over_two_cards(cuda):
    """A mesh over two cards: each piece's kernels launch on its own
    card (``Kernel.launch`` sets the runtime's device), and the gathered
    logits equal one card's apply."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core.workloads import binarynet_cifar10
    cb = tgraph.compile(binarynet_cifar10(), device=cuda, batch=8)
    params = cb.init(torch.Generator().manual_seed(0))
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    srv = BNNServer(cb, params, max_batch=8, prewarm=True,
                    mesh=tserving.data_mesh(devices=cards * 2))
    x = torch.randn(7, 32, 32, 3,
                    generator=torch.Generator().manual_seed(2)).to(cuda)
    _mesh_twin(srv, cb, params, [x])
    assert [s["device"] for s in srv.slots()] == \
        ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert all(s["rows"] for s in srv.slots())


def test_server_and_graphs_need_a_card_unless_cpu(monkeypatch):
    cb = tgraph.compile(tgraph.from_dense_stack(64, [32]), device="cpu")
    params = cb.init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BNNServer(cb, params)                       # device=None: the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BNNServer(cb, params, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraph.compile(tgraph.from_dense_stack(64, [32]))
    assert BNNServer(cb, params, device="cpu").device.type == "cpu"


def test_launch_counts_capture_recording_and_launch_error(monkeypatch):
    """Kernel.launch on a stand-in entry point (no card here): a launch
    counts once per kernel, a capture's launches go to its recording
    and not to the counts, a replay adds them, and a refused launch
    raises LaunchError (a RuntimeError)."""
    class Lib:
        @staticmethod
        def repro_cuda_error_string(err):
            return b"invalid argument"

    class Stream:
        cuda_stream = 0

    codes = []
    k = _build.Kernel("pack", "pack", "pack_launch", [])
    k._fn = (Lib, lambda *args: codes.pop() if codes else 0)
    monkeypatch.setattr(_build, "KERNELS", (k,))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    dev = torch.device("cuda", 0)
    k.launch(dev)
    assert _build.launch_counts() == {"pack": 1}
    with _build.recording() as rec:
        k.launch(dev, kernels=2)
    assert rec == {"pack": 2} and _build.launch_counts() == {"pack": 1}
    _build.add_launches(rec)                        # one replay
    assert _build.launch_counts() == {"pack": 3}
    codes.append(1)
    with pytest.raises(_build.LaunchError, match="invalid argument"):
        k.launch(dev)
    assert issubclass(_build.LaunchError, RuntimeError)
    assert _build.launch_counts() == {"pack": 3}
    _build.reset_launch_counts()
    assert _build.launch_counts() == {"pack": 0}


# ------------------------------------------------------------------ #
# the continuously-batched queue                                       #
# ------------------------------------------------------------------ #
def test_queue_drain_bursty_arrival():
    _, _, _, tcb, tparams, srv = _mlp()
    rng = np.random.default_rng(5)
    sizes = (2, 2, 2, 2, 5, 3, 8, 1)
    xs = [_pair(rng, r)[1] for r in sizes]
    refs = [tcb.apply(tparams, x) for x in xs]
    futs = [srv.submit(x) for x in xs]
    assert srv.queue_depth() == len(sizes)
    assert srv.flush() < len(sizes)
    assert srv.queue_depth() == 0
    for fut, ref in zip(futs, refs):
        assert torch.equal(fut.result(timeout=5).words, ref.words)
    st = srv.stats()
    assert st["requests"] == len(sizes) and st["queue_wait_s"]["p50"] >= 0


def test_mismatched_request_does_not_fail_neighbors():
    _, _, _, tcb, tparams, srv = _mlp()
    rng = np.random.default_rng(8)
    good1, bad, good2 = (_pair(rng, 2)[1], _pair(rng, 2, d0=64)[1],
                         _pair(rng, 2)[1])
    f1, fb, f2 = srv.submit(good1), srv.submit(bad), srv.submit(good2)
    srv.flush()
    for fut, x in ((f1, good1), (f2, good2)):
        assert torch.equal(fut.result(timeout=5).words,
                           tcb.apply(tparams, x).words)
    with pytest.raises(tserving.PoisonRequest):
        fb.result(timeout=5)
    assert srv.jit_traces() == 1                    # no graph for the bad kind


def test_admission_joins_open_batch_only_while_device_busy():
    _, _, _, _, _, srv = _mlp()
    srv.admit_window_s = 0.5
    rng = np.random.default_rng(11)
    srv.submit(_pair(rng, 2)[1])
    t0 = time.perf_counter()
    taken = srv._admit()
    assert len(taken) == 1 and taken[0].rows == 2
    assert time.perf_counter() - t0 < 0.25
    srv._inflight_n = 1
    try:
        srv.submit(_pair(rng, 2)[1])
        late_x = _pair(rng, 3)[1]
        late = threading.Thread(
            target=lambda: (time.sleep(0.05), srv.submit(late_x)))
        late.start()
        taken = srv._admit()
        late.join()
    finally:
        srv._inflight_n = 0
    assert len(taken) == 2 and sum(r.rows for r in taken) == 5
    assert srv.queue_depth() == 0


def test_worker_threads_equal_reference_server():
    _, _, jsrv, _, _, tsrv = _mlp()
    rng = np.random.default_rng(6)
    pairs = [_pair(rng, r) for r in (1, 4, 3, 8, 2, 13)]
    tsrv.start()
    try:
        futs = [tsrv.submit(t) for _, t in pairs]
        for fut, (jx, _) in zip(futs, pairs):
            _same_words(fut.result(timeout=60), jsrv.apply_batch(jx))
    finally:
        tsrv.stop()
    assert tsrv.queue_depth() == 0
    assert tsrv.jit_traces() <= tsrv.trace_bound()


def test_stop_resolves_batches_in_flight():
    _, _, _, tcb, tparams, srv = _mlp(max_batch=4)
    rng = np.random.default_rng(12)
    xs = [_pair(rng, 3)[1] for _ in range(6)]
    refs = [tcb.apply(tparams, x) for x in xs]
    srv.start()
    futs = [srv.submit(x) for x in xs]
    srv.stop()
    for fut, ref in zip(futs, refs):
        assert fut.done() and torch.equal(fut.result().words, ref.words)
    st = srv.stats()
    assert st["inflight_batches"] == 0 and st["inflight_peak"] >= 1
    assert st["queue_depth"] == 0
    assert {"p50", "p95", "p99"} <= set(st["latency_s"])
    assert {"p50", "p95", "p99"} <= set(st["queue_wait_s"])
    srv.start()                                     # restart after stop
    fut = srv.submit(xs[0])
    assert torch.equal(fut.result(timeout=60).words, refs[0].words)
    srv.stop()
