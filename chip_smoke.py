#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi``), torch and CUDA versions, and builds
   the four Hopper kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc (timed);
2. holds each kernel — pack, packed_conv2d, fused_binary_mlp,
   popcount_gemm — against its plain torch version on the card, bit for
   bit, at the BinaryNet main path's shapes (batch 256) and at edge
   shapes (odd N and F, valid_n masking, scalar and per-channel
   thresholds, pack_out on and off, stride 2, valid padding), and times
   kernel, plain version and, where one exists, the single PyTorch call
   that computes the same function (``library_ms``, never used by the
   port) with CUDA events;
3. runs full-width BinaryNet CIFAR-10 through the port's entry points
   (``graph.compile(...).init/apply``) at batches 1, 32 and 256, with
   random weights from a seeded generator: the ``"cuda"`` logits must
   equal the ``"torch"`` backend's on the card exactly (and, at batch 1,
   the CPU's), and each forward must launch exactly 1 pack, 5
   packed_conv2d, 1 fused_binary_mlp and 1 popcount_gemm; prints
   images/s and peak device memory.

Any failure raises and exits non-zero; no phase catches its own
failure.  The last line is the device summary JSON; the line before it
the card's name and power limit; before that the ``kernels`` JSON.
Results also go to ``chiprun_out/chip_smoke.json``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
MEM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT8_OPS = 1979e12         # H100 SXM int8 tensor-core peak, dense ops/s
FP32_OPS = 67e12           # H100 SXM float32 outside the tensor cores
BATCH = 256                # the batch kernel shapes are taken at


def bound(nbytes, ops, rate):
    """Least time for the work, ms: the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_b, t_o = nbytes / MEM_BPS * 1e3, ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_ms(fn, iters=10, warmup=2):
    """Mean device time of one call, by CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {tuple(a.shape)} "
                             f"{a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_equal(name, got, want):
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


class Rand:
    """Seeded inputs made on the card."""

    def __init__(self, seed, device):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def normal(self, *shape):
        return torch.randn(shape, generator=self.g, device=self.device)

    def pm1(self, *shape):
        return torch.where(self.normal(*shape) > 0, 1.0, -1.0)

    def ints(self, lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=self.g,
                             device=self.device, dtype=torch.int32)


# ------------------------------------------------------------------ #
# kernel phases                                                        #
# ------------------------------------------------------------------ #
def check_pack(rnd, rec):
    from repro_torch.kernels.pack import pack, pack_plain
    edge = rnd.normal(37, 100)
    edge[0, :4] = torch.tensor([float("nan"), -0.0, 0.0, 1.0])
    err = check_equal("pack edge 37x100", pack(edge), pack_plain(edge))
    x = rnd.normal(BATCH * 1024, 128)      # binarize@conv2
    err = max(err, check_equal("pack main", pack(x), pack_plain(x)))
    m, k = x.shape
    b, by = bound(4 * m * k + 4 * m * k // 32, m * k, FP32_OPS)
    rec.append(dict(name="pack", route="cuda",
                    source="src/repro_torch/kernels/csrc/pack.cu",
                    replaces="src/repro/kernels/pack.py:40",
                    max_abs_err=err, ms=time_ms(lambda: pack(x), 20),
                    plain_ms=time_ms(lambda: pack_plain(x), 3),
                    bound_ms=b, bound_by=by, library_ms=None))


def conv_inputs(rnd, nb, h, w, c, f, k, s, pad):
    from repro_torch.kernels.ops import conv_padding
    from repro_torch.kernels.packed import pack_words
    from repro_torch.kernels.packed_conv import out_size, pad_words_spatial
    ph, pw = conv_padding(pad, k, k)
    x = rnd.pm1(nb, h, w, c)
    wt = rnd.pm1(k, k, c, f)
    xw = pad_words_spatial(pack_words(x, -1), ph, pw).contiguous()
    ww = pack_words(wt, 2).reshape(k * k * xw.shape[-1], f).contiguous()
    geo = dict(kh=k, kw=k, c=c, stride=s, ho=out_size(h, k, s, ph),
               wo=out_size(w, k, s, pw))
    return x, wt, xw, ww, geo, (ph, pw)


def check_conv(rnd, rec):
    import torch.nn.functional as F

    from repro_torch.kernels.packed_conv import (packed_conv2d,
                                                 packed_conv2d_plain)
    from repro_torch.kernels.ref import full_fp32
    err = 0
    for nb, h, w, c, f, k, s, pad, thr, pack_out in [
            (2, 8, 8, 33, 20, 3, 1, "same", None, False),
            (1, 9, 9, 64, 32, 3, 2, "same", "scalar", True),
            (1, 9, 9, 64, 32, 3, 2, "same", "scalar", False),
            (1, 7, 7, 16, 10, 5, 1, "valid", "vector", False),
            (2, 6, 6, 3, 40, 3, 1, "same", "vector", True),
            (2, 6, 6, 50, 33, 3, 1, "same", "vector", True)]:
        _, _, xw, ww, geo, _ = conv_inputs(rnd, nb, h, w, c, f, k, s, pad)
        kw = dict(geo, pack_out=pack_out,
                  threshold=2 if thr == "scalar" else None,
                  threshold_vec=rnd.ints(-4, 4, f) if thr == "vector"
                  else None)
        err = max(err, check_equal(f"packed_conv2d edge {nb}x{h}x{w}x{c}"
                                   f"->{f} s{s} {pad} {thr} {pack_out}",
                                   packed_conv2d(xw, ww, **kw),
                                   packed_conv2d_plain(xw, ww, **kw)))
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    ops_t = bytes_t = 0.0
    # conv2..conv6 of BinaryNet at batch 256: (H, C, F)
    for name, hw, c, f in [("conv2", 32, 128, 128), ("conv3", 16, 128, 256),
                           ("conv4", 16, 256, 256), ("conv5", 8, 256, 512),
                           ("conv6", 8, 512, 512)]:
        x, wt, xw, ww, geo, (ph, pw) = conv_inputs(
            rnd, BATCH, hw, hw, c, f, 3, 1, "same")
        tvec = rnd.ints(-3, 4, f)
        kw = dict(geo, threshold_vec=tvec, pack_out=True)
        err = max(err, check_equal(f"packed_conv2d {name}",
                                   packed_conv2d(xw, ww, **kw),
                                   packed_conv2d_plain(xw, ww, **kw)))
        ms = time_ms(lambda: packed_conv2d(xw, ww, **kw))
        plain = time_ms(lambda: packed_conv2d_plain(xw, ww, **kw), 2, 1)
        xf = F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), value=-1.0)
        wf = wt.permute(3, 2, 0, 1).contiguous()
        with full_fp32():
            lib = time_ms(lambda: F.conv2d(xf, wf))
        m = BATCH * geo["ho"] * geo["wo"]
        nbytes = 4 * (xw.numel() + ww.numel() + f + m * f // 32)
        ops = 2 * m * f * 9 * c
        b, _ = bound(nbytes, ops, INT8_OPS)
        print(f"packed_conv2d {name} B={BATCH}: kernel_ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={b:.5f}")
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", b),
                       ("library_ms", lib)):
            tot[key] += v
        ops_t += ops
        bytes_t += nbytes
    rec.append(dict(name="packed_conv2d", route="cuda",
                    source="src/repro_torch/kernels/csrc/packed_conv.cu",
                    replaces="src/repro/kernels/packed_conv.py:187",
                    max_abs_err=err, **tot,
                    bound_by=bound(bytes_t, ops_t, INT8_OPS)[1]))


def packed_rows(rnd, m, k):
    from repro_torch.kernels.packed import pack_words
    return pack_words(rnd.pm1(m, k), -1).contiguous()


def check_fused(rnd, rec):
    from repro_torch.kernels.fused_mlp import (fused_mlp_words,
                                               fused_mlp_words_plain)
    err = 0
    for m, k0, ns, thr in [(37, 50, [20, 33], [2, "vector"]),
                           (301, 97, [300, 65, 40],
                            ["vector", 1, "vector"]),
                           (5, 64, [32], ["vector"])]:
        x = packed_rows(rnd, m, k0)
        ws, ks, ts, k = [], [], [], k0
        for n, t in zip(ns, thr):
            ws.append(packed_rows(rnd, n, k))
            ks.append(k)
            ts.append(rnd.ints(-5, 5, n) if t == "vector" else t)
            k = n
        err = max(err, check_equal(f"fused_mlp edge m={m} {k0}->{ns}",
                                   fused_mlp_words(x, ws, ks, ts),
                                   fused_mlp_words_plain(x, ws, ks, ts)))
    # fc1 + fc2 of BinaryNet at batch 256
    x = packed_rows(rnd, BATCH, 8192)
    ws = [packed_rows(rnd, 1024, 8192), packed_rows(rnd, 1024, 1024)]
    ks = [8192, 1024]
    ts = [rnd.ints(-3, 4, 1024), rnd.ints(-3, 4, 1024)]
    err = max(err, check_equal("fused_mlp main",
                               fused_mlp_words(x, ws, ks, ts),
                               fused_mlp_words_plain(x, ws, ks, ts)))
    nbytes = 4 * (x.numel() + sum(w.numel() for w in ws) + 2048
                  + BATCH * 32)
    b, by = bound(nbytes, 2 * BATCH * (8192 * 1024 + 1024 * 1024),
                  INT8_OPS)
    rec.append(dict(name="fused_binary_mlp", route="cuda",
                    source="src/repro_torch/kernels/csrc/fused_mlp.cu",
                    replaces="src/repro/kernels/fused_mlp.py:143",
                    max_abs_err=err,
                    ms=time_ms(lambda: fused_mlp_words(x, ws, ks, ts), 20),
                    plain_ms=time_ms(
                        lambda: fused_mlp_words_plain(x, ws, ks, ts), 2, 1),
                    bound_ms=b, bound_by=by, library_ms=None))


def check_gemm(rnd, rec):
    from repro_torch.kernels.packed import unpack_words
    from repro_torch.kernels.popcount_gemm import (popcount_gemm,
                                                   popcount_gemm_plain)
    err = 0
    for m, k, n, thr, pack_out in [(37, 50, 20, "scalar", True),
                                   (5, 97, 33, "vector", True),
                                   (64, 128, 96, "vector", False),
                                   (3, 33, 65, None, False),
                                   (300, 2000, 70, "scalar", False),
                                   (130, 2000, 70, "vector", True)]:
        xp, wp = packed_rows(rnd, m, k), packed_rows(rnd, n, k)
        kw = dict(threshold=2 if thr == "scalar" else None,
                  threshold_vec=rnd.ints(-5, 5, n) if thr == "vector"
                  else None, pack_out=pack_out)
        err = max(err, check_equal(f"popcount_gemm edge {m}x{k}x{n} "
                                   f"{thr} {pack_out}",
                                   popcount_gemm(xp, wp, k, **kw),
                                   popcount_gemm_plain(xp, wp, k, **kw)))
    # fc3, the classifier head of BinaryNet at batch 256
    xp, wp = packed_rows(rnd, BATCH, 1024), packed_rows(rnd, 10, 1024)
    err = max(err, check_equal("popcount_gemm main",
                               popcount_gemm(xp, wp, 1024),
                               popcount_gemm_plain(xp, wp, 1024)))
    xf = unpack_words(xp, -1)
    wf = unpack_words(wp, -1).t().contiguous()
    if not torch.equal(torch.matmul(xf, wf).to(torch.int32),
                       popcount_gemm(xp, wp, 1024)):
        raise AssertionError("float32 matmul yardstick disagrees")
    b, by = bound(4 * (xp.numel() + wp.numel() + BATCH * 10),
                  2 * BATCH * 10 * 1024, INT8_OPS)
    rec.append(dict(name="popcount_gemm", route="cuda",
                    source="src/repro_torch/kernels/csrc/popcount_gemm.cu",
                    replaces="src/repro/kernels/popcount_gemm.py:144",
                    max_abs_err=err,
                    ms=time_ms(lambda: popcount_gemm(xp, wp, 1024), 20),
                    plain_ms=time_ms(
                        lambda: popcount_gemm_plain(xp, wp, 1024), 5),
                    bound_ms=b, bound_by=by,
                    library_ms=time_ms(lambda: torch.matmul(xf, wf), 20)))


# ------------------------------------------------------------------ #
# the main path                                                        #
# ------------------------------------------------------------------ #
PER_FORWARD = {"pack": 1, "packed_conv2d": 5, "fused_binary_mlp": 1,
               "popcount_gemm": 1}


def to_cpu(tree):
    from repro_torch.kernels.packed import PackedArray
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    if isinstance(tree, PackedArray):
        return tree.to("cpu")
    return tree.cpu()


def main_path(launches):
    from repro_torch import graph
    from repro_torch.core.workloads import binarynet_cifar10
    from repro_torch.kernels import _build
    spec = graph.from_workload(binarynet_cifar10())
    out = {}
    for batch in (1, 32, 256):
        cb = graph.compile(spec, device="cuda", batch=batch)
        if batch == 1:
            print(cb.describe())
            params = cb.init(torch.Generator().manual_seed(0))
        if cb.launch_count() != sum(PER_FORWARD.values()):
            raise AssertionError(f"plan has {cb.launch_count()} launches")
        # integer-valued images: the float entry conv then sums exactly
        # in any order, so every backend and device agrees bit for bit
        gen = torch.Generator().manual_seed(batch)
        x = torch.randint(-3, 4, (batch, 32, 32, 3), generator=gen
                          ).to(torch.float32).to("cuda")

        _build.reset_launch_counts()
        logits = cb.apply(params, x)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        if counts != PER_FORWARD:
            raise AssertionError(f"batch {batch}: launches {counts}, "
                                 f"expected {PER_FORWARD}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

        if logits.shape != (batch, 10) or not torch.isfinite(logits).all():
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        ref = graph.compile(spec, backend="torch", device="cuda"
                            ).apply(params, x)
        if not torch.equal(logits, ref):
            raise AssertionError(f"batch {batch}: cuda logits differ from "
                                 f"the torch backend's")
        if batch == 1:
            cpu = graph.compile(spec, backend="torch", device="cpu"
                                ).apply(to_cpu(params), x.cpu())
            if not torch.equal(logits.cpu(), cpu):
                raise AssertionError("card logits differ from the CPU's")

        iters = 20 if batch < 256 else 10
        cb.apply(params, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            cb.apply(params, x)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out[batch] = dict(images_per_s=batch * iters / dt,
                          ms_per_forward=dt / iters * 1e3,
                          peak_mem_bytes=peak)
        print(f"BinaryNet B={batch}: {batch * iters / dt:.1f} images/s, "
              f"{dt / iters * 1e3:.3f} ms/forward, peak device memory "
              f"{peak / 2**20:.1f} MiB, launches {counts}, logits equal "
              f"to the torch backend")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # the matmul yardstick
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.2f} s (nvcc, sm_90a, parallel)")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}")

    rec = []
    rnd = Rand(1234, "cuda")
    for phase in (check_pack, check_conv, check_fused, check_gemm):
        phase(rnd, rec)
        torch.cuda.synchronize()
        r = rec[-1]
        print(f"{r['name']}: bit-identical to its plain version "
              f"(max_abs_err {r['max_abs_err']}); kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")

    launches = {}
    perf = main_path(launches)
    for r in rec:
        r["launches"] = launches[r["name"]]
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} never launched")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{k: r[k] for k in keys} for r in rec]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": build_s,
         "kernels": kernels, "binarynet": perf, "device": device},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
