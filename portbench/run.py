"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run it from the root of a checkout.  The cells, their configurations
and metrics are in ``BENCHMARK.json``; ``portbench/harness.py`` says
what a run does.  It measures ``repro_torch`` (the PyTorch/CUDA port
under ``src/``) on one CUDA card and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``, then ``checks``: each number the check compared, with
its limit, which are also the last lines of standard error.  Without a
CUDA card it prints no result and exits with 2.

The kernel libraries build into ``src/repro_torch/kernels/_build/``
inside the checkout at the first run and are loaded from there after.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root (for ``portbench``) and ``src`` (for the port),
# not this file's folder, whose data folders would shadow module names
sys.path[:] = [str(ROOT), str(ROOT / "src")] + \
    [p for p in sys.path[1:] if Path(p or ".").resolve() != ROOT / "portbench"]


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _smi(fields: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def _state() -> str:
    return _smi("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
                "clocks_throttle_reasons.active")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    if args.seconds <= 0:
        ap.error("--seconds must be positive")

    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} CUDA card(s); this host has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    _log(f"card: {_smi('name,power.limit')}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}")
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_PROCESS, log=_log,
                              probe=_state)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
