"""The port's recovery ladder on the CPU, driven by its ChaosMonkey.

Mirrors the reference's fault-tolerance tests (tests/test_robustness.py)
on ``repro_torch.serving.BNNServer`` with ``device="cpu"`` and the
port's copy of ``ChaosMonkey``: deadlines are shed, a bounded queue
rejects, a poison request is bisected out, a transient fault is
retried, a backend fault falls back to ``"torch"`` with the reference's
words, an exhausted ladder raises a typed error, the straggler flag
fires, killed loops are restarted, and no future is lost under a chaos
storm.  Also the port's own classes of fault: a refused kernel launch
(``LaunchError``) falls back, a CUDA error reported at synchronisation
is neither retried nor bisected, and a failed capture reaches its
requests as is.

    PYTHONPATH=src python -m pytest -q tests/test_torch_chaos.py
"""
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
from repro.robustness import ChaosMonkey as JChaosMonkey  # noqa: E402
from repro_torch import graph as tgraph  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.graph.replay import CaptureError  # noqa: E402
from repro_torch.kernels._build import LaunchError  # noqa: E402
from repro_torch.kernels.ops import binarize_pack  # noqa: E402
from repro_torch.kernels.packed import as_uint32  # noqa: E402
from repro_torch.robustness import (ChaosConfig, ChaosMonkey,  # noqa: E402
                                    PoisonError, ThreadKill, TransientFault)
from repro_torch.runtime.straggler import WatchdogConfig  # noqa: E402
from repro_torch.serving import (BackendFault, BNNServer,  # noqa: E402
                                 PoisonRequest, RequestTimeout,
                                 ServerOverloaded, ServingError)


def np_tree(tree):
    if isinstance(tree, JPacked):
        return {"words": np.asarray(tree.words), "length": tree.length,
                "axis": tree.axis}
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def ref():
    """The reference's dense stack and params (shared: tracing the
    reference is the slow part)."""
    cb = jgraph.compile(jgraph.from_dense_stack(256, [128, 64],
                                                name="robust_mlp"),
                        backend="xla", batch=4)
    return cb, cb.init(jax.random.PRNGKey(0))


def _server(ref, backend="torch", max_batch=8, **kw):
    """The port's server over the reference's params; (compiled, params,
    server)."""
    cb = tgraph.compile(tgraph.from_dense_stack(256, [128, 64],
                                                name="robust_mlp"),
                        backend=backend, device="cpu", batch=4)
    params = params_from_numpy(np_tree(ref[1]), "cpu")
    kw.setdefault("retry_backoff_s", 0.0)
    return cb, params, BNNServer(cb, params, max_batch=max_batch,
                                 device="cpu", **kw)


def _packed(rng, rows, d0=256):
    x = rng.normal(size=(rows, d0)).astype(np.float32)
    return binarize_pack(torch.from_numpy(x), backend="torch")


def _words(pa):
    return as_uint32(pa.words)


# ------------------------------------------------------------------ #
# the copied taxonomy and chaos                                        #
# ------------------------------------------------------------------ #
def test_error_taxonomy():
    for err in (ServerOverloaded, RequestTimeout, PoisonRequest,
                BackendFault):
        assert issubclass(err, ServingError)
    assert issubclass(RequestTimeout, TimeoutError)
    assert issubclass(BackendFault, RuntimeError)
    assert issubclass(ThreadKill, BaseException)
    assert not issubclass(ThreadKill, Exception)
    assert issubclass(PoisonError, ValueError)
    assert issubclass(TransientFault, RuntimeError)
    assert issubclass(LaunchError, RuntimeError)
    assert not issubclass(LaunchError, ServingError)


def test_chaos_storm_draws_equal_reference():
    """The same seed fires the same faults and spikes in the same
    order as the reference's ChaosMonkey."""
    from repro.robustness import ChaosConfig as JChaosConfig
    cfg = dict(seed=3, fault_rate=0.3, latency_spike_rate=0.2,
               latency_spike_s=0.0)
    mine, theirs = ChaosMonkey(ChaosConfig(**cfg)), \
        JChaosMonkey(JChaosConfig(**cfg))

    def fired(monkey):
        out = []
        for i in range(64):
            try:
                monkey.on_flight([i], fallback=i % 5 == 0)
                out.append(None)
            except Exception as e:
                out.append(type(e).__name__)
        return out, monkey.events

    assert fired(mine) == fired(theirs)


# ------------------------------------------------------------------ #
# deadlines + backpressure                                             #
# ------------------------------------------------------------------ #
def test_expired_deadline_sheds_before_launch(ref):
    rng = np.random.default_rng(3)
    _, _, srv = _server(ref)
    expired = srv.submit(_packed(rng, 2), deadline_s=0.0)
    live = srv.submit(_packed(rng, 2), deadline_s=60.0)
    srv.flush()
    assert isinstance(expired.exception(), RequestTimeout)
    assert live.result() is not None
    st = srv.stats()
    assert st["faults"]["timeouts"] == 1 and st["requests"] == 1


def test_bounded_queue_rejects_and_flush_terminates(ref):
    rng = np.random.default_rng(4)
    _, _, srv = _server(ref, max_queue_rows=8)
    futs = [srv.submit(_packed(rng, 2)) for _ in range(4)]
    assert srv.health()["overloaded"] and not srv.health()["healthy"]
    with pytest.raises(ServerOverloaded):
        srv.submit(_packed(rng, 1))
    assert srv.flush() >= 1
    for f in futs:
        assert f.result() is not None
    assert srv.stats()["faults"]["rejected"] == 1
    h = srv.health()
    assert h["healthy"] and not h["overloaded"] and h["queued_rows"] == 0
    srv.submit(_packed(rng, 2)).cancel()


# ------------------------------------------------------------------ #
# the recovery ladder                                                  #
# ------------------------------------------------------------------ #
def test_poison_row_never_fails_healthy_neighbors(ref):
    rng = np.random.default_rng(5)
    chaos = ChaosMonkey()
    cb, params, srv = _server(ref, chaos=chaos)
    good = [_packed(rng, 2) for _ in range(3)]
    bad = _packed(rng, 2)
    refs = [cb.apply(params, g) for g in good]
    chaos.poison(bad)
    futs = [srv.submit(good[0]), srv.submit(bad),
            srv.submit(good[1]), srv.submit(good[2])]
    assert srv.flush() == 1
    err = futs[1].exception()
    assert isinstance(err, PoisonRequest)
    assert isinstance(err.__cause__, PoisonError)
    for f, want in zip([futs[0], futs[2], futs[3]], refs):
        np.testing.assert_array_equal(_words(f.result()), _words(want))
    st = srv.stats()["faults"]
    assert st["flights"] == 1 and st["poisoned_requests"] == 1
    assert st["bisections"] >= 1 and st["retries"] == 0


def test_transient_fault_recovers_by_retry(ref):
    rng = np.random.default_rng(6)
    chaos = ChaosMonkey()
    cb, params, srv = _server(ref, chaos=chaos)
    x = _packed(rng, 3)
    chaos.fail_next(TransientFault("flaky"))
    fut = srv.submit(x)
    srv.flush()
    np.testing.assert_array_equal(_words(fut.result()),
                                  _words(cb.apply(params, x)))
    st = srv.stats()["faults"]
    assert st["flights"] == 1 and st["retries"] == 1
    assert st["backend_fallbacks"] == 0 and st["bisections"] == 0


@pytest.mark.parametrize("fault", [BackendFault("kernel launch failed"),
                                   LaunchError("pack: CUDA error 1")],
                         ids=["BackendFault", "LaunchError"])
def test_backend_fault_falls_back_with_the_reference_words(ref, fault):
    """The "cuda" backend (its wrappers' plain versions on the CPU)
    faults; the flight re-executes on "torch" and gives the reference
    server's words, counted once."""
    rng = np.random.default_rng(7)
    chaos = ChaosMonkey()
    _, _, srv = _server(ref, backend="cuda", chaos=chaos)
    x = rng.normal(size=(5, 256)).astype(np.float32)
    want = jserving.BNNServer(*ref, max_batch=8).apply_batch(
        jbinarize_pack(jnp.asarray(x), backend="xla"))
    chaos.fail_next(fault)
    fut = srv.submit(binarize_pack(torch.from_numpy(x), backend="torch"))
    srv.flush()
    np.testing.assert_array_equal(_words(fut.result()),
                                  np.asarray(want.words))
    st = srv.stats()["faults"]
    assert st["backend_fallbacks"] == 1 and st["retries"] == 0
    assert srv._fallback.backend == "torch"
    assert srv._fallback.device == srv.device


def test_exhausted_recovery_surfaces_typed_backend_fault(ref):
    rng = np.random.default_rng(8)
    chaos = ChaosMonkey()
    _, _, srv = _server(ref, chaos=chaos, fallback_backend=None,
                        max_retries=2)
    chaos.fail_next(BackendFault("down"), times=3)
    fut = srv.submit(_packed(rng, 2))
    srv.flush()
    err = fut.exception()
    assert isinstance(err, BackendFault) and not isinstance(
        err, PoisonRequest)
    st = srv.stats()["faults"]
    assert st["retries"] == 2 and st["backend_fallbacks"] == 0


def test_sticky_cuda_error_is_neither_retried_nor_bisected(ref):
    """A CUDA error reported at synchronisation poisons the context:
    with no fallback, every request of the flight fails with a typed
    BackendFault at once."""
    rng = np.random.default_rng(13)
    chaos = ChaosMonkey()
    _, _, srv = _server(ref, chaos=chaos, fallback_backend=None)
    chaos.fail_next(RuntimeError("CUDA error: an illegal memory access "
                                 "was encountered"))
    futs = [srv.submit(_packed(rng, 2)) for _ in range(3)]
    assert srv.flush() == 1
    for f in futs:
        err = f.exception()
        assert isinstance(err, BackendFault)
        assert "illegal memory access" in str(err.__cause__)
    st = srv.stats()["faults"]
    assert st["flights"] == 1 and st["retries"] == 0
    assert st["bisections"] == 0 and st["poisoned_requests"] == 0


def test_sticky_cuda_error_falls_back_once(ref):
    rng = np.random.default_rng(14)
    chaos = ChaosMonkey()
    cb, params, srv = _server(ref, chaos=chaos)
    x = _packed(rng, 4)
    chaos.fail_next(RuntimeError("CUDA error: unspecified launch failure"))
    fut = srv.submit(x)
    srv.flush()
    np.testing.assert_array_equal(_words(fut.result()),
                                  _words(cb.apply(params, x)))
    st = srv.stats()["faults"]
    assert st["backend_fallbacks"] == 1 and st["retries"] == 0


def test_failed_capture_reaches_its_requests(ref):
    rng = np.random.default_rng(15)
    chaos = ChaosMonkey()
    _, _, srv = _server(ref, chaos=chaos)
    chaos.fail_next(CaptureError("capture refused"))
    futs = [srv.submit(_packed(rng, 1)) for _ in range(2)]
    srv.flush()
    for f in futs:
        assert isinstance(f.exception(), CaptureError)
    st = srv.stats()["faults"]
    assert st["flights"] == 1 and st["backend_fallbacks"] == 0
    assert st["retries"] == 0 and st["bisections"] == 0


# ------------------------------------------------------------------ #
# straggler watchdog wiring                                            #
# ------------------------------------------------------------------ #
def test_straggler_flag_fires_on_latency_spike(ref):
    rng = np.random.default_rng(9)
    chaos = ChaosMonkey()
    _, _, srv = _server(ref, chaos=chaos,
                        watchdog_cfg=WatchdogConfig(min_samples=4))
    for _ in range(5):
        srv.submit(_packed(rng, 2))
        srv.flush()
    chaos.spike_next(0.3)
    srv.submit(_packed(rng, 2))
    srv.flush()
    st = srv.stats()
    assert 5 in st["straggler_flags"]
    assert 0.0 < st["straggler_median_s"] < 0.3


# ------------------------------------------------------------------ #
# supervised threads, health, shutdown under fault                     #
# ------------------------------------------------------------------ #
def test_killed_loops_are_restarted_and_keep_serving(ref):
    rng = np.random.default_rng(10)
    chaos = ChaosMonkey()
    _, _, srv = _server(ref, chaos=chaos, supervise_interval_s=0.01)
    assert srv.health()["healthy"] and not srv.health()["running"]
    srv.start()
    assert srv.health()["running"]
    chaos.kill("dispatcher")
    chaos.kill("completer")
    futs = [srv.submit(_packed(rng, 1 + i % 3)) for i in range(8)]
    for f in futs:
        assert f.result(timeout=60) is not None
    srv.stop()
    st = srv.stats()
    assert st["faults"]["thread_restarts"] >= 2
    assert chaos.events["kills"] == 2
    h = srv.health()
    assert not h["running"] and h["queue_depth"] == 0
    assert h["thread_restarts"] == st["faults"]["thread_restarts"]


def test_zero_lost_futures_under_chaos_storm_and_stop(ref):
    rng = np.random.default_rng(11)
    chaos = ChaosMonkey(ChaosConfig(
        seed=0, fault_rate=0.4, latency_spike_rate=0.4,
        latency_spike_s=0.002))
    cb, params, srv = _server(ref, backend="cuda", chaos=chaos,
                              retry_backoff_s=0.001,
                              supervise_interval_s=0.01)
    srv.start()
    chaos.kill("dispatcher")
    chaos.kill("completer")
    payloads = [_packed(rng, 1 + i % 4) for i in range(12)]
    refs = [cb.apply(params, p) for p in payloads]
    chaos.poison(payloads[5])
    futs = [srv.submit(p) for p in payloads]
    expired = srv.submit(_packed(rng, 2), deadline_s=0.0)
    srv.stop()
    assert all(f.done() for f in futs) and expired.done()
    assert isinstance(expired.exception(), RequestTimeout)
    for i, (f, want) in enumerate(zip(futs, refs)):
        if i == 5:
            assert isinstance(f.exception(), PoisonRequest)
        else:
            np.testing.assert_array_equal(_words(f.result()), _words(want))
    st = srv.stats()["faults"]
    assert st["poisoned_requests"] == 1 and st["timeouts"] == 1
    assert srv.health()["queued_rows"] == 0


def test_stop_is_idempotent_and_restartable_after_chaos(ref):
    rng = np.random.default_rng(12)
    chaos = ChaosMonkey()
    _, _, srv = _server(ref, chaos=chaos, supervise_interval_s=0.01)
    srv.start()
    chaos.kill("completer")
    assert srv.submit(_packed(rng, 2)).result(timeout=60) is not None
    srv.stop()
    srv.stop()
    srv.start()
    assert srv.submit(_packed(rng, 2)).result(timeout=60) is not None
    srv.stop()


def test_ladder_counters_equal_reference(ref):
    """The same scripted faults on the same requests move the same
    fault counters in both servers."""
    rng = np.random.default_rng(16)
    xs = [rng.normal(size=(r, 256)).astype(np.float32) for r in (2, 3, 1)]
    jchaos, tchaos = JChaosMonkey(), ChaosMonkey()
    jsrv = jserving.BNNServer(*ref, max_batch=8, chaos=jchaos,
                              retry_backoff_s=0.0)
    _, _, tsrv = _server(ref, chaos=tchaos)
    jx = [jbinarize_pack(jnp.asarray(x), backend="xla") for x in xs]
    tx = [binarize_pack(torch.from_numpy(x), backend="torch") for x in xs]
    jchaos.poison(jx[1])
    tchaos.poison(tx[1])
    from repro.serving import BackendFault as JBackendFault
    for monkey, fault in ((jchaos, JBackendFault), (tchaos, BackendFault)):
        monkey.fail_next(TransientFault("flaky"))
        monkey.fail_next(fault("down"))
    jf = [jsrv.submit(x) for x in jx]
    tf = [tsrv.submit(x) for x in tx]
    jsrv.flush()
    tsrv.flush()
    for i, (a, b) in enumerate(zip(tf, jf)):
        if i == 1:
            assert isinstance(a.exception(), PoisonRequest)
        else:
            np.testing.assert_array_equal(_words(a.result()),
                                          np.asarray(b.result().words))
    assert tsrv.stats()["faults"] == jsrv.stats()["faults"]
