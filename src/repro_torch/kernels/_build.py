"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>.<hash>.so csrc/<name>.cu

into ``kernels/_build/`` (listed in ``.gitignore``), one ``nvcc`` per
source, all started together.  The file name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale library is
never loaded.  The libraries export a plain C interface, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.

Every C entry point launches on the stream it is given and returns the
CUDA error code of the launch; :meth:`Kernel.launch` raises
:class:`LaunchError` on anything but 0 and otherwise adds the kernels
the call launched (one, unless the caller says more) to the kernel's
launch count — the count that shows a run really went through the
kernel.  A launch recorded into a CUDA graph runs when the graph is
replayed: a capture collects its thread's launches apart
(:func:`recording`), and every replay adds them to the counts
(:func:`add_launches`), so the counts are kernels run on the card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("pack", "popcount_gemm", "packed_conv", "fused_mlp", "xnor_gemm",
           "entry_conv", "stem_conv", "shortcut_conv")

_libs: Dict[str, ctypes.CDLL] = {}
_build_log: Dict[str, str] = {}
_sms: Dict[int, int] = {}
_count_lock = threading.Lock()
_local = threading.local()


class LaunchError(RuntimeError):
    """A kernel launch the CUDA runtime refused (the error code of the
    C entry point): the backend failed, not the payload."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "host with the CUDA toolkit")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{source}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{source}.{h.hexdigest()[:12]}.so"


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source started
    together; returns ``{source: compiler output}`` (the ``-Xptxas -v``
    register and shared-memory report).  Raises with the compiler's
    output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src}.cu")]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for src, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        _build_log[src] = log
        if p.returncode != 0:
            failed.append(f"--- {src}.cu (nvcc rc {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)           # atomic: a reader never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return dict(_build_log)


def _load(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device pointer for ctypes (None stays NULL)."""
    return None if t is None else t.data_ptr()


class Kernel:
    """One C entry point of one kernel library, with its launch count.

    ``argtypes`` lists the ctypes of the arguments before the trailing
    stream argument, which :meth:`launch` appends."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = _load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn

    def launch(self, device: torch.device, *args, kernels: int = 1) -> None:
        """Launch on ``device``'s current stream; raise on a CUDA error
        (a refused launch never runs, and a later synchronize would not
        report it).  ``kernels``: the CUDA kernels the entry point
        launches for these arguments, all added to the count."""
        lib, fn = self._bind()
        cur = torch.cuda.current_device()
        if device.index is None or device.index == cur:
            err = fn(*args, torch.cuda.current_stream(cur).cuda_stream)
        else:
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                err = fn(*args, stream)
        if err != 0:
            msg = lib.repro_cuda_error_string(err).decode()
            raise LaunchError(f"{self.name}: CUDA error {err} ({msg})")
        rec = getattr(_local, "rec", None)
        if rec is not None:
            rec[self.name] = rec.get(self.name, 0) + kernels
            return
        with _count_lock:
            self.launches += kernels


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

PACK = Kernel("pack", "pack", "pack_launch", [P, P, P, I, I, I, I, I])
POPCOUNT_GEMM = Kernel("popcount_gemm", "popcount_gemm",
                       "popcount_gemm_launch",
                       [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I])
PACKED_CONV = Kernel("packed_conv2d", "packed_conv", "packed_conv2d_launch",
                     [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I,
                      I, I, I, I])
# the fused residual half-step (ReActNet): packed_conv's mainloop and
# the residual epilogue in one kernel
RESIDUAL_CONV = Kernel("residual_conv", "packed_conv",
                       "packed_conv2d_residual_launch",
                       [P, P, P, P, P, P, P] + [I] * 16)
FUSED_MLP = Kernel("fused_binary_mlp", "fused_mlp", "fused_mlp_launch",
                   [P, P, I, I, I, P, P, P, P, P, P, I, I, I])

XNOR_GEMM = Kernel("xnor_gemm", "xnor_gemm", "xnor_gemm_launch",
                   [P, I, P, P, P, P, I, I, I, I, F, I, I, I, I, I, P])

ENTRY_CONV = Kernel("entry_conv", "entry_conv", "entry_conv_launch",
                    [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I, I,
                     I, I])

STEM_CONV = Kernel("stem_conv", "stem_conv", "stem_conv_launch",
                   [P, P, P, P, P] + [I] * 15)
# Bi-Real Net's 7x7 stem with its max pool: another entry point of the
# same library, counted as the stem
STEM_CONV_POOL = Kernel("stem_conv", "stem_conv", "stem_conv_pool_launch",
                        [P, P, P, P, P] + [I] * 6)
SHORTCUT_CONV = Kernel("shortcut_conv", "shortcut_conv",
                       "shortcut_conv_launch", [P, P, P, P] + [I] * 5)

KERNELS = (PACK, PACKED_CONV, FUSED_MLP, POPCOUNT_GEMM, XNOR_GEMM,
           ENTRY_CONV, STEM_CONV, STEM_CONV_POOL, RESIDUAL_CONV,
           SHORTCUT_CONV)


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches; entry points of one name add up."""
    out: Dict[str, int] = {}
    for k in KERNELS:
        out[k.name] = out.get(k.name, 0) + k.launches
    return out


def reset_launch_counts() -> None:
    with _count_lock:
        for k in KERNELS:
            k.launches = 0


@contextlib.contextmanager
def recording():
    """Collect the launches this thread makes inside the block in the
    dict it yields (kernel name -> launches), leaving the counts alone:
    a CUDA graph's capture records launches that run only when the
    graph is replayed."""
    prev = getattr(_local, "rec", None)
    _local.rec = rec = {}
    try:
        yield rec
    finally:
        _local.rec = prev


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the launch counts: a
    CUDA graph's replay adds the launches its capture recorded."""
    by_name: Dict[str, Kernel] = {}
    for k in KERNELS:
        by_name.setdefault(k.name, k)
    with _count_lock:
        for name, n in counts.items():
            by_name[name].launches += n


def device_sms(device: torch.device) -> int:
    """The card's SM count, which the launch plans round blocks to."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sms[idx]


def require_cuda_tensor(t: torch.Tensor, what: str) -> None:
    """The wrappers take the plain version only for a CPU tensor; any
    other device that is not CUDA is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"device {t.device}")
