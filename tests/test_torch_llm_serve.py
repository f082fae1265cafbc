"""The port's decode Engine against the reference's.

On reduced float32 qwen1.5-0.5b (2 layers), with the reference's params
carried across (``params_from_numpy``) and the same numpy-seeded
prompts, the port's ``Engine`` emits exactly the reference ``Engine``'s
tokens, dense and packed, and packed equals dense.  Prefill is built
once per power-of-two bucket (``prefill_traces``), bucketing changes no
token, and the recurrent and enc-dec stacks use exact lengths.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.packed import PackedArray  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import init_params as tinit  # noqa: E402
from test_torch_models import np_tree  # noqa: E402

ARCH = "qwen1.5-0.5b"
LENS = [5, 9, 7, 8, 12, 3]


def _cfgs(arch=ARCH):
    kw = dict(dtype="float32", num_layers=2)
    return (jconfigs.reduced(jconfigs.get_arch(arch)).replace(**kw),
            tconfigs.reduced(tconfigs.get_arch(arch)).replace(**kw))


@pytest.fixture(scope="module")
def qwen():
    cfg_j, cfg_t = _cfgs()
    pj = jinit(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, pj, np_tree(pj)


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(mod, cfg, params, packed, slots=2, max_new=5, bucketed=None,
           **kw):
    eng = mod.Engine(cfg, params, batch_slots=slots, capacity=24,
                     packed=packed, **kw)
    if bucketed is not None:
        eng._bucketed = bucketed
    reqs = [mod.Request(i, p, max_new)
            for i, p in enumerate(_prompts(cfg.vocab_size))]
    eng.run(reqs, log=lambda *_: None)
    assert all(r.done and len(r.out) == max_new for r in reqs)
    return eng, [r.out for r in reqs]


@pytest.mark.parametrize("packed", [False, True])
def test_engine_tokens_equal_reference(qwen, packed):
    cfg_j, cfg_t, pj, pnp = qwen
    _, want = _serve(jserve, cfg_j, pj, packed)
    eng, got = _serve(tserve, cfg_t, params_from_numpy(pnp, "cpu"), packed,
                      device="cpu")
    assert got == want
    assert eng.device.type == "cpu"
    leaves = [v for blk in eng.params["decoder"]["layers"]
              for v in blk["attn"].values()]
    assert any(isinstance(v, PackedArray) for v in leaves) == packed


def test_packed_equals_dense_and_is_smaller(qwen):
    _, cfg_t, _, pnp = qwen
    params = params_from_numpy(pnp, "cpu")
    eng_d, dense = _serve(tserve, cfg_t, params, False, device="cpu")
    eng_p, packed = _serve(tserve, cfg_t, params, True, device="cpu")
    assert dense == packed
    assert eng_p.param_bytes < eng_d.param_bytes


def test_prefill_built_once_per_bucket(qwen):
    """Prompts of 3..12 tokens land in buckets 4, 8 and 16: three
    prefills built, the tokens those of exact-length prefill."""
    _, cfg_t, _, pnp = qwen
    params = params_from_numpy(pnp, "cpu")
    eng_b, out_b = _serve(tserve, cfg_t, params, False, device="cpu")
    assert eng_b.prefill_traces == 3
    assert sorted(eng_b._prefill_cache) == [4, 8, 16]
    eng_e, out_e = _serve(tserve, cfg_t, params, False, device="cpu",
                          bucketed=False)
    assert eng_e.prefill_traces == len(set(LENS))
    assert out_b == out_e


@pytest.mark.parametrize("arch,bucketed", [
    ("falcon-mamba-7b", False), ("recurrentgemma-2b", False),
    ("whisper-large-v3", False), ("qwen1.5-0.5b", True),
    ("mixtral-8x22b", True)])
def test_recurrent_and_encdec_stacks_use_exact_lengths(arch, bucketed):
    _, cfg_t = _cfgs(arch)
    params = tinit(torch.Generator().manual_seed(0), cfg_t, device="cpu")
    eng = tserve.Engine(cfg_t, params, batch_slots=1, capacity=24,
                        device="cpu")
    assert eng._bucketed is bucketed
    assert eng._prefill_len(5) == (8 if bucketed else 5)
    assert eng._prefill_len(30) == 30


def test_recurrent_engine_tokens_equal_reference():
    """falcon-mamba (exact-length prefill, SSM state spliced per slot)
    serves the reference's tokens."""
    cfg_j, cfg_t = _cfgs("falcon-mamba-7b")
    pj = jinit(jax.random.PRNGKey(1), cfg_j)
    _, want = _serve(jserve, cfg_j, pj, False, max_new=4)
    _, got = _serve(tserve, cfg_t, params_from_numpy(np_tree(pj), "cpu"),
                    False, max_new=4, device="cpu")
    assert got == want


def test_engine_runs_on_the_card_by_default(qwen):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg_t, _, pnp = qwen
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.Engine(cfg_t, params_from_numpy(pnp, "cpu"), batch_slots=1,
                      capacity=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_gpu_engine_tokens_equal_the_cpu_engine(qwen, cuda, packed):
    """The Engine on the card serves the CPU Engine's tokens (reduced
    float32 qwen, the reference's params) and launches no port kernel
    (its float x packed-weight products are unpack -> matmul)."""
    from repro_torch.kernels import _build
    _, cfg_t, _, pnp = qwen
    params = params_from_numpy(pnp, "cpu")
    _, want = _serve(tserve, cfg_t, params, packed, device="cpu")
    _build.reset_launch_counts()
    eng, got = _serve(tserve, cfg_t, params, packed, device=cuda)
    assert eng.device.type == "cuda"
    assert sum(_build.launch_counts().values()) == 0
    assert got == want
