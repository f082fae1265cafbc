"""The float entry conv that packs its signs in its epilogue
(``kernels.entry_conv``, ``csrc/entry_conv.cu``) and the compiled
forward's dispatch to it.

On the CPU: which convs the kernel takes (from the shapes alone), the
plain version against the two steps it replaces (``sign_weight_conv``,
then the pack with ``scale=alpha``), and which convs of which plans
``CompiledBNN.apply`` sends to it (an op recorded through a
monkeypatch).  The tests marked ``gpu`` hold the kernel on the card bit
for bit against the two steps, and skip, inside the ``cuda`` fixture, on
a host without a CUDA device; run them on a GPU host with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_entry_conv.py
"""
import itertools
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on one host: one torch thread each
torch.set_num_threads(1)

from repro_torch import graph  # noqa: E402
from repro_torch.analysis.audit import expected_launches  # noqa: E402
from repro_torch.core.workloads import (alexnet_imagenet,  # noqa: E402
                                        binarynet_cifar10)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import entry_conv as kentry  # noqa: E402
from repro_torch.kernels.ops import conv_padding  # noqa: E402

# the shapes the kernel takes: K, stride, C_in, F, padding
TAKEN = list(itertools.product((3, 5), (1, 2), (1, 3, 4), (32, 128, 256),
                               (0, "same")))
# (H, W, C, F, K, stride, padding) it refuses
REFUSED = [(13, 13, 17, 32, 3, 1, 1),      # C > 16
           (13, 13, 3, 32, 9, 1, 4),       # K > 7
           (13, 13, 3, 32, 3, 3, 1),       # stride 3
           (13, 13, 3, 48, 3, 1, 1),       # F % 32 != 0
           (13, 13, 3, 32, 3, 1, 3),       # a pad as wide as the window
           (2, 2, 3, 32, 5, 1, 0),         # no output pixel
           (64, 64, 16, 256, 7, 1, 3)]     # more shared memory than a block has


def _small_spec(entry_stride=1, pool_after_entry=False):
    """An integer entry conv (3 -> 32, 3x3), a binarize, a binary conv
    and a dense head; with ``pool_after_entry`` a float max-pool sits
    between the entry conv and the binarize, as in AlexNet."""
    g = graph
    h = 9 if entry_stride == 3 else 8
    ho = 3 if entry_stride == 3 else 8
    pad = 0 if entry_stride == 3 else 1
    nodes = [g.IntegerEntry("conv1", 3, 3, 3, 32, h, h, ho, ho,
                            entry_stride, pad)]
    if pool_after_entry:
        nodes.append(g.MaxPool("pool@conv1", 2, 2))
        ho //= 2
    nodes += [g.Binarize("binarize@conv2"),
              g.BinaryConv("conv2", 3, 3, 32, 32, ho, ho, ho, ho, 1, 1),
              g.BNThreshold("conv2.bn", 32),
              g.BinaryDense("fc1", ho * ho * 32, 10), g.Logits("logits", 10)]
    spec = g.BNNSpec("small", (h, h, 3), tuple(nodes))
    spec.validate()
    return spec


def _images(n, shape, seed=0):
    """8-bit integer pixels: every float32 partial sum is exact."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *shape), generator=g).to(torch.float32)


def _operands(n, h, w, c, f, k, seed=0, device="cpu", integer=True):
    """x [n, h, w, c] (8-bit integer pixels, or normal floats), latent
    weights [k, k, c, f] with exact zeros, alpha = mean|w| with a zero
    channel."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (n, h, w, c), generator=g).to(torch.float32) \
        if integer else torch.randn(n, h, w, c, generator=g)
    wt = torch.randn(k, k, c, f, generator=g)
    wt[0, 0, 0, : min(3, f)] = 0.0
    alpha = wt.abs().mean(dim=(0, 1, 2))
    alpha[min(5, f - 1)] = 0.0
    return x.to(device), wt.to(device), alpha.to(device)


def _two_steps(x, wt, alpha, stride, padding, backend):
    """Today's path: the float conv, then the pack with alpha as its
    scale."""
    y = kentry.sign_weight_conv(x, wt, stride=stride, padding=padding)
    return ops.binarize_pack(y, backend=backend, scale=alpha).words


# ------------------------------------------------------------------ #
# the CPU: shapes, plain version, dispatch                            #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("k,stride,c,f,padding", TAKEN)
def test_plan_takes_the_shapes_of_the_entry_convs(k, stride, c, f, padding):
    pad_h, pad_w = conv_padding(padding, k, k)
    p = kentry.plan(13, 13, c, f, k, k, stride, pad_h, pad_w)
    assert p is not None and (f // 32) % p["wb"] == 0
    assert p["ho"] == (13 + 2 * pad_h - k) // stride + 1
    assert p["smem"] <= kentry.SMEM_BYTES
    assert kentry.supports((2, 13, 13, c), (k, k, c, f), stride, padding)


@pytest.mark.parametrize("h,w,c,f,k,stride,pad", REFUSED)
def test_plan_refuses_what_the_kernel_does_not_take(h, w, c, f, k, stride,
                                                    pad):
    assert kentry.plan(h, w, c, f, k, k, stride, pad, pad) is None
    x, wt, alpha = _operands(1, h, w, c, f, k)
    with pytest.raises(ValueError, match="does not take"):
        kentry.entry_conv(x, wt, alpha, stride=stride, padding=pad)


def test_plan_of_binarynet_conv1():
    """Four words a block (all of conv1's 128 channels), whole rows of
    32 pixels: a tile's words are one contiguous run of the output."""
    p = kentry.plan(32, 32, 3, 128, 3, 3, 1, 1, 1)
    assert (p["wb"], p["tw"], p["ho"], p["wo"]) == (4, 32, 32, 32)


@pytest.mark.parametrize("n,h,c,f,k,stride,padding", [
    (5, 32, 3, 128, 3, 1, 1),            # BinaryNet's conv1
    (3, 13, 1, 32, 5, 2, 0), (2, 13, 4, 256, 3, 2, "same"),
    (2, 9, 3, 96, 3, 1, 1)])
def test_plain_version_is_the_two_steps(n, h, c, f, k, stride, padding):
    x, wt, alpha = _operands(n, h, h, c, f, k)
    got = kentry.entry_conv(x, wt, alpha, stride=stride, padding=padding)
    want = _two_steps(x, wt, alpha, stride, padding, "torch")
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(kentry.entry_conv_plain(x, wt, alpha, stride,
                                               padding), want)


def _record(monkeypatch):
    """Record the fused op's alphas and binarize_pack's scales."""
    fused, packs = [], []
    real_fused, real_pack = kentry.entry_conv, ops.binarize_pack

    def fused_op(x, w, alpha, stride=1, padding="same"):
        fused.append(alpha)
        return real_fused(x, w, alpha, stride=stride, padding=padding)

    def pack_op(x, backend=None, scale=None):
        packs.append(scale)
        return real_pack(x, backend=backend, scale=scale)

    monkeypatch.setattr(kentry, "entry_conv", fused_op)
    monkeypatch.setattr(ops, "binarize_pack", pack_op)
    return fused, packs


@pytest.mark.parametrize("spec", ["small", "binarynet"])
def test_apply_runs_the_entry_conv_where_a_binarize_follows(monkeypatch,
                                                            spec):
    """On the "cuda" backend the entry conv before binarize@conv2 is
    one fused op with the conv's alpha, no binarize_pack runs, and the
    logits equal the "torch" backend's (today's two steps)."""
    s = _small_spec() if spec == "small" else binarynet_cifar10()
    batch = 5
    cb = graph.compile(s, device="cpu", batch=batch)
    params = cb.init(torch.Generator().manual_seed(0))
    x = _images(batch, cb.spec.input_shape)
    want = cb.with_backend("torch").apply(params, x)
    fused, packs = _record(monkeypatch)
    got = cb.apply(params, x)
    assert len(fused) == 1 and fused[0] is params["conv"][0]["alpha"]
    assert packs == []
    assert torch.equal(got, want)
    assert torch.equal(cb.apply(params, x, valid_rows=batch - 1),
                       want[:batch - 1])


@pytest.mark.parametrize("case", ["pool_after_entry", "split_head",
                                  "torch_backend", "unsupported_shape"])
def test_apply_keeps_the_two_steps_elsewhere(monkeypatch, case):
    """A float pool after the entry conv (AlexNet), a head cut off by
    ``split``, the "torch" backend and a shape the kernel does not take
    keep the float conv and the pack: the fused op never runs."""
    spec = _small_spec(entry_stride=3 if case == "unsupported_shape"
                       else 1, pool_after_entry=case == "pool_after_entry")
    cb = graph.compile(spec, backend="torch" if case == "torch_backend"
                       else "cuda", device="cpu", batch=3)
    params = cb.init(torch.Generator().manual_seed(0))
    x = _images(3, spec.input_shape)
    alpha = params["conv"][0]["alpha"]
    if case == "split_head":
        cb, _ = cb.split("binarize@conv2")
    assert not any(s.args.get("epilogue") == "entry_conv" for s in cb.plan)
    fused, packs = _record(monkeypatch)
    if case == "split_head":
        h = cb.apply(params, x)
        assert h.dtype == torch.float32 and packs == []
    else:
        cb.apply(params, x)
        # the pool's conv keeps its alpha multiply; the others leave it
        # to the pack
        assert packs[0] is (None if case == "pool_after_entry" else alpha)
    assert fused == []


@pytest.mark.parametrize("workload,launches,packs_entry", [
    (binarynet_cifar10, {"entry_conv": 1, "packed_conv2d": 5,
                         "fused_binary_mlp": 1, "popcount_gemm": 1}, True),
    (alexnet_imagenet, {"pack": 1, "packed_conv2d": 3,
                        "fused_binary_mlp": 1, "popcount_gemm": 1}, False)])
def test_launches_and_plan_are_unchanged(workload, launches, packs_entry):
    """The fused kernel takes the place of the pack's launch: 8 launches
    a BinaryNet forward, as before; the plan keeps its steps and
    names; AlexNet never engages it."""
    cb = graph.compile(workload(), device="cpu", batch=4)
    assert expected_launches(cb, 4) == launches
    assert cb.launch_count() == sum(launches.values())
    assert ([s.args["epilogue"] for s in cb.plan
             if s.kind == "integer_conv"][0] == "entry_conv") is packs_entry
    assert "integer_conv" in [s.kind for s in cb.plan]
    assert ("entry_conv kernel" in cb.describe()) is packs_entry


@pytest.mark.parametrize("case,epilogues,binarize", [
    ("binarynet_cuda", ["entry_conv"], (True, None, ())),
    ("binarynet_torch", ["alpha_to_pack"], (False, 0, ("pack",))),
    ("alexnet", ["alpha", "alpha"], (False, None, ("pack",))),
    ("split_head", ["alpha"], None)])
def test_build_plan_records_the_entry_epilogue(case, epilogues, binarize):
    """The plan decides each integer conv's epilogue once, and the
    first binarize's (packed, scale_conv, launches) with it; the audit's
    expected launches are the steps' ``launches`` counted."""
    workload = alexnet_imagenet if case == "alexnet" else binarynet_cifar10
    cb = graph.compile(workload(), backend="torch" if case ==
                       "binarynet_torch" else "cuda", device="cpu", batch=4)
    if case == "split_head":
        cb, _ = cb.split("binarize@conv2")
    assert [s.args["epilogue"] for s in cb.plan
            if s.kind == "integer_conv"] == epilogues
    first = [(s.args["packed"], s.args["scale_conv"], s.launches)
             for s in cb.plan if s.kind == "binarize"][:1]
    assert first == ([binarize] if binarize else [])
    launches = Counter(name for s in cb.plan for name in s.launches)
    assert expected_launches(cb, 4) == launches
    assert cb.launch_count() == sum(launches.values())


def test_train_eval_forward_runs_the_serving_entry_conv(monkeypatch):
    """The training eval forward computes a fused entry conv with the
    same op as the served forward, so the exported net stays
    sign-identical on the card; on the CPU its +-1 values are the two
    steps'."""
    from repro_torch import train
    from repro_torch.kernels.packed import unpack_words
    spec = _small_spec()
    params, bn = train.init_train_state(torch.Generator().manual_seed(0),
                                        spec, device="cpu")
    x = torch.randn(3, *spec.input_shape,
                    generator=torch.Generator().manual_seed(1))
    fused, _ = _record(monkeypatch)
    train.train_forward(spec, params, bn, x, train=False)
    assert len(fused) == 1
    w = params["conv"][0]["w"]
    alpha = w.abs().mean(dim=(0, 1, 2))
    got = unpack_words(kentry.entry_conv(x, w, alpha, 1, 1))
    want = torch.where(kentry.sign_weight_conv(x, w, 1, 1) * alpha > 0,
                       1.0, -1.0)
    assert torch.equal(got, want)


# ------------------------------------------------------------------ #
# the card                                                             #
# ------------------------------------------------------------------ #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 7, 256, 2048])
def test_kernel_bits_at_binarynet_conv1(cuda, batch):
    x, wt, alpha = _operands(batch, 32, 32, 3, 128, 3, seed=batch,
                             device=cuda)
    got = kentry.entry_conv(x, wt, alpha, stride=1, padding=1)
    want = _two_steps(x, wt, alpha, 1, 1, "cuda")
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k,stride,c,f,padding", TAKEN)
def test_kernel_bits_across_shapes(cuda, k, stride, c, f, padding):
    x, wt, alpha = _operands(3, 13, 13, c, f, k, seed=k * c + f,
                             device=cuda)
    got = kentry.entry_conv(x, wt, alpha, stride=stride, padding=padding)
    assert torch.equal(got, _two_steps(x, wt, alpha, stride, padding,
                                       "cuda"))


@pytest.mark.gpu
def test_kernel_on_a_valid_rows_view(cuda):
    """The served forward hands the kernel the first rows of a padded
    bucket (a view): the words are those of the rows alone."""
    x, wt, alpha = _operands(9, 32, 32, 3, 128, 3, seed=3, device=cuda)
    got = kentry.entry_conv(x[:6], wt, alpha, stride=1, padding=1)
    assert torch.equal(got, _two_steps(x[:6].clone(), wt, alpha, 1, 1,
                                       "cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_on_float_inputs_against_float64(cuda, stride):
    """Non-integer inputs: wherever the float64 sum is farther from 0
    than float32 summation can move it (1e-5 of the window's sum of
    |x|), the bit is the float64 sign's (alpha > 0 there)."""
    x, wt, alpha = _operands(16, 32, 32, 3, 128, 3, seed=5, device=cuda,
                             integer=False)
    alpha = alpha.clamp_min(0.1)
    got = kentry.entry_conv(x, wt, alpha, stride=stride, padding=1)
    bits = ((got[..., None] >> torch.arange(32, device=cuda)) & 1) \
        .reshape(*got.shape[:-1], -1).bool()
    xd = x.double().permute(0, 3, 1, 2)
    wd = torch.where(wt > 0, 1.0, -1.0).double().permute(3, 2, 0, 1)
    acc = torch.nn.functional.conv2d(xd, wd, stride=stride, padding=1)
    mag = torch.nn.functional.conv2d(xd.abs(), wd.abs(), stride=stride,
                                     padding=1)
    acc, mag = acc.permute(0, 2, 3, 1), mag.permute(0, 2, 3, 1)
    clear = acc.abs() > 1e-5 * mag
    assert clear.float().mean() > 0.99
    assert torch.equal(bits[clear], (acc > 0)[clear])


@pytest.mark.gpu
def test_kernel_refuses_a_shape_it_does_not_take(cuda):
    x, wt, alpha = _operands(2, 13, 13, 17, 32, 3, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        kentry.entry_conv(x, wt, alpha, stride=1, padding=1)


@pytest.mark.gpu
def test_kernel_counts_one_launch_per_call(cuda):
    x, wt, alpha = _operands(4, 32, 32, 3, 128, 3, device=cuda)
    _build.reset_launch_counts()
    kentry.entry_conv(x, wt, alpha, stride=1, padding=1)
    kentry.entry_conv(x, wt, alpha, stride=1, padding=1)
    torch.cuda.synchronize()
    assert _build.launch_counts()["entry_conv"] == 2


@pytest.mark.gpu
def test_graphed_binarynet_logits_unchanged(cuda):
    """BinaryNet replayed from its CUDA graph on 8-bit pixels: the
    logits equal the "torch" backend's (cuDNN's conv, then the pack), and
    a replay runs the fused kernel once and no pack."""
    from repro_torch.graph.replay import GraphedApply
    cb = graph.compile(binarynet_cifar10(), batch=64)
    params = cb.init(torch.Generator().manual_seed(0))
    x = _images(64, cb.spec.input_shape, seed=9).to(cuda)
    want = cb.with_backend("torch").apply(params, x)
    g = GraphedApply(cb, params, 64)
    assert g.launches.get("entry_conv") == 1 and "pack" not in g.launches
    _build.reset_launch_counts()
    got = g(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _build.launch_counts()["entry_conv"] == 1
