"""The check's control: the reference in a lower precision, put in the
program's place, has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3
        [--precisions tf32 bf16 fp8 int4]

For each seed it makes the run's data (weights and input pool, on the
card), draws a sample of requests as a run's check does (the traffic's
``check_requests`` sizes from its size block, plus its largest size),
and compares the reference in each precision with the reference itself
by the run's own comparison (``systems/<family>.py::compare``).  Each
line names the seed, the precision, the numbers and whether the run's
limit passes them; the configuration's ``control`` precision must fail
on every seed.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + \
    [p for p in sys.path[1:] if Path(p or ".").resolve() != ROOT / "portbench"]


def sample_requests(traffic, pool_rows, seed):
    """(offset, size) of a check's sample: ``check_requests`` sizes
    drawn from the traffic's size block, plus its largest size."""
    import numpy as np

    from portbench import clients

    rng = np.random.default_rng([seed, 3])
    stream = clients.SizeStream(clients.size_levels(traffic["sizes"]),
                                pool_rows, rng)
    reqs = [stream.next() for _ in range(int(traffic["check_requests"]))]
    n = clients.max_size(traffic["sizes"])
    reqs.append((int(rng.integers(0, pool_rows - n + 1)), n))
    return reqs


def readings(root: Path, cell_name: str, seed: int, precisions, device: str):
    """One line a precision: the control's numbers for one seed."""
    from portbench import harness

    cell = harness.load_cell(root, cell_name)
    config = cell.config
    adapter = harness.load_module(
        root / "portbench" / "systems" / f"{config['family']}.py",
        f"portbench_system_{config['family']}")
    weights, pool = adapter.make_data(config, cell.traffic, seed, device)
    reqs = sample_requests(cell.traffic, int(pool.shape[0]), seed)
    sample = [(off, n, None) for off, n in reqs]
    out = []
    for p in precisions:
        t = time.perf_counter()
        found = adapter.compare(config["layers"], weights, pool, sample, p)
        limit = config["check"]["mismatch_share_limit"]
        out.append({"workload": cell_name, "seed": seed, "precision": p,
                    "control": p == config["control"],
                    "mismatch_share": found["mismatch_share"],
                    "limit": limit,
                    "correct": found["mismatch_share"] <= limit,
                    "images": found["images"],
                    "max_abs_diff": found["max_abs_diff"],
                    "seconds": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precisions", nargs="+",
                    default=["tf32", "bf16", "fp8", "int4"])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for line in readings(ROOT, args.workload, seed, args.precisions,
                             "cuda"):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
