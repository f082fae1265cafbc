"""The tuning table: launch plans chosen by timing on the card.

The counterpart of ``repro.kernels.autotune``.  Each kernel picks its
launch plan by a rule (``packed_conv.tile_plan``,
``popcount_gemm.tile_plan``, ``xnor_gemm.tile_plan``,
``fused_mlp.launch_config``); each rule asks this table first and falls
back to itself on a miss.  An entry is the port's launch plan for one
key, not the reference's ``BlockConfig``:

========================  ======================  ======================
op of the key             shape of the key        entry
========================  ======================  ======================
``packed_conv[+pack]``    (M, F, K32)             ``{bm, bn}``
``popcount_gemm[+pack]``  (M, N, K32)             ``{bm, bn, wk}``
``xnor_gemm[_f32][+pack]``  (M, N, K32)           ``{bm, bn, splits}``
``fused_binary_mlp``      (M, K0, (N_1, ...))     ``{bm, cs}``
========================  ======================  ======================

A key is ``(op, backend, *shape)``, the one the launch plans compute
(``ops.plan_dense_launch`` / ``plan_conv_launch``, the fused stack's
``passes.plan_tuning_keys``); M counts the launch's rows (a conv's
N*HO*WO pixels).  Fused pack epilogues keep a distinct ``"+pack"`` op,
as in the reference: a popcount tile of 8 columns cannot pack.
``xnor_gemm_f32`` is a float32 x, which runs three MMA planes.

Entries come from ``put`` (e.g. ``autotune``) or a JSON file (``load``,
or the path in ``REPRO_TORCH_TUNING_TABLE`` on first use), keyed on
``op|backend|shape`` with a tuple of widths written ``1024,1024``.  A
missing path is ignored (tuning is an optimization, not a dependency);
a malformed file raises, and so does an entry the kernel cannot take
(a tile not in its ``TILES``, a ``+pack`` popcount tile narrower than
32 columns, a fused config over ``fused_mlp.SMEM_BYTES``): it is never
clamped quietly.  An empty table gives exactly the rules' plans; a miss
is not memoized, so ``save`` writes only tuned entries.  The reference's
``REPRO_TUNING_TABLE`` holds ``BlockConfig``s and is never read here.

The table is process-global.  A CUDA graph keeps the plan it was
captured with: a table changed after capture changes no replay.

    python -m repro_torch.kernels.autotune --model binarynet alexnet \\
        --batches 1 32 256 --out chiprun_out/tuning.json

times every candidate of every key of those plans, and of
``binary_dense`` at the decode GEMMs, on the card, and prints each
key's rule plan and time beside the best.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional
from typing import Sequence, Tuple

import torch

__all__ = ["ENV_TABLE", "Tuned", "TuningTable", "autotune", "candidates",
           "check_entry", "decode_runners", "get_table", "key_str",
           "resolve", "time_entry", "warm", "xnor_constants"]

ENV_TABLE = "REPRO_TORCH_TUNING_TABLE"

Key = Tuple[Any, ...]           # (op, backend, *shape)
Entry = Dict[str, int]

_FIELDS = {"packed_conv": ("bm", "bn"),
           "popcount_gemm": ("bm", "bn", "wk"),
           "xnor_gemm": ("bm", "bn", "splits"),
           "xnor_gemm_f32": ("bm", "bn", "splits"),
           "fused_binary_mlp": ("bm", "cs")}


def _op_parts(op: str) -> Tuple[str, bool]:
    """(base op, pack epilogue) of a key's op."""
    pack = op.endswith("+pack")
    base = op[:-len("+pack")] if pack else op
    if base not in _FIELDS or (pack and base == "fused_binary_mlp"):
        raise ValueError(f"no tunable kernel op {op!r}; ops: "
                         f"{sorted(_FIELDS)} (+pack)")
    return base, pack


def _check_key(key: Key) -> Tuple[str, bool]:
    if not isinstance(key, tuple) or len(key) < 3:
        raise ValueError(f"a tuning key is (op, backend, *shape), got "
                         f"{key!r}")
    base, pack = _op_parts(key[0])
    if key[1] != "cuda":
        raise ValueError(f"{key!r}: only the 'cuda' backend runs kernels")
    shape = key[2:]
    if base == "fused_binary_mlp":
        ok = len(shape) == 3 and all(isinstance(v, int) and v > 0
                                     for v in shape[:2]) \
            and isinstance(shape[2], tuple) and shape[2] \
            and all(isinstance(v, int) and v > 0 for v in shape[2])
    else:
        ok = len(shape) == 3 and all(isinstance(v, int) and v > 0
                                     for v in shape)
    if not ok:
        raise ValueError(f"{key!r}: bad shape for {key[0]}")
    return base, pack


def check_entry(key: Key, entry: Any) -> Entry:
    """The entry as the kernel takes it, or ValueError where the kernel
    cannot take it at this key."""
    from repro_torch.kernels import (fused_mlp, packed_conv, popcount_gemm,
                                     xnor_gemm)
    base, pack = _check_key(key)
    fields = _FIELDS[base]
    if not isinstance(entry, dict) or set(entry) != set(fields) or \
            not all(isinstance(entry[f], int) and not isinstance(
                entry[f], bool) for f in fields):
        raise ValueError(f"{key!r}: entry must be {{{', '.join(fields)}}} "
                         f"of ints, got {entry!r}")
    e = {f: int(entry[f]) for f in fields}
    if base == "packed_conv":
        if (e["bm"], e["bn"]) not in packed_conv.TILES:
            raise ValueError(f"{key!r}: tile {e} not in packed_conv.TILES "
                             f"{packed_conv.TILES}")
    elif base == "popcount_gemm":
        t = (e["bm"], e["bn"], e["wk"])
        if t not in popcount_gemm.TILES:
            raise ValueError(f"{key!r}: tile {t} not in popcount_gemm."
                             f"TILES {popcount_gemm.TILES}")
        if pack and e["bn"] < 32:
            raise ValueError(f"{key!r}: a pack_out tile needs >= 32 "
                             f"columns, got {t}")
    elif base.startswith("xnor_gemm"):
        if (e["bm"], e["bn"]) not in xnor_gemm.TILES or \
                not 1 <= e["splits"] <= xnor_gemm.MAX_SPLITS:
            raise ValueError(f"{key!r}: tile {e} not (BM, BN) in "
                             f"{tuple(xnor_gemm.TILES)} with 1 <= splits "
                             f"<= {xnor_gemm.MAX_SPLITS}")
    else:
        m, k0, ns = key[2:]
        if e["bm"] not in fused_mlp.ROW_TILES or \
                e["cs"] not in fused_mlp.CLUSTERS:
            raise ValueError(f"{key!r}: config {e} not BM in "
                             f"{fused_mlp.ROW_TILES}, CS in "
                             f"{fused_mlp.CLUSTERS}")
        if len(ns) > fused_mlp.MAX_LAYERS:
            raise ValueError(f"{key!r}: one launch takes at most "
                             f"{fused_mlp.MAX_LAYERS} layers")
        buf = fused_mlp.stack_plan(m, k0, list(ns))["buf_words"]
        smem = fused_mlp.smem_bytes(e["bm"], buf)
        if smem > fused_mlp.SMEM_BYTES:
            raise ValueError(f"{key!r}: config {e} needs {smem} B of "
                             f"shared memory a block, more than "
                             f"{fused_mlp.SMEM_BYTES}")
    return e


def key_str(key: Key) -> str:
    def part(v):
        if isinstance(v, tuple):
            return ",".join(str(x) for x in v) + ("," if len(v) == 1
                                                  else "")
        return str(v)
    return "|".join(part(p) for p in key)


def _parse_key(s: str) -> Key:
    parts = s.split("|")
    if len(parts) < 3:
        raise ValueError(f"malformed tuning key {s!r}")
    shape = []
    for p in parts[2:]:
        if "," in p:
            shape.append(tuple(int(v) for v in p.split(",") if v))
        else:
            shape.append(int(p))
    return (parts[0], parts[1], *shape)


class TuningTable:
    """Tuned launch plans keyed on (op, backend, shape), with JSON
    persistence; every entry is checked against its kernel."""

    def __init__(self):
        self._entries: Dict[Key, Entry] = {}
        self._loaded_env = False

    def _ensure_env_loaded(self) -> None:
        if self._loaded_env:
            return
        self._loaded_env = True
        path = os.environ.get(ENV_TABLE)
        if path and os.path.exists(path):
            self.load(path)

    def get(self, key: Key) -> Optional[Entry]:
        self._ensure_env_loaded()
        hit = self._entries.get(key)
        return None if hit is None else dict(hit)

    def put(self, key: Key, entry: Entry) -> Entry:
        self._entries[key] = check_entry(key, entry)
        return dict(self._entries[key])

    def load(self, path: str) -> None:
        """Merge the entries of a saved table; the whole file is checked
        before any entry is taken."""
        with open(path) as f:
            raw = json.load(f)
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: a tuning table is a JSON object")
        parsed = {}
        for k, v in raw.items():
            key = _parse_key(k)
            parsed[key] = check_entry(key, v)
        self._entries.update(parsed)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({key_str(k): v for k, v in
                       sorted(self._entries.items(), key=lambda kv:
                              key_str(kv[0]))}, f, indent=1)

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        self._ensure_env_loaded()
        return len(self._entries)


_TABLE = TuningTable()


def get_table() -> TuningTable:
    return _TABLE


def _sms(device: Optional[torch.device]) -> int:
    from repro_torch.kernels import _build, packed_conv
    if device is not None and torch.device(device).type == "cuda":
        return _build.device_sms(torch.device(device))
    return packed_conv.H100_SMS


def resolve(key: Key, device: Any = None, tuned: bool = True) -> Entry:
    """The plan a launch at ``key`` takes on ``device`` (None or a CPU
    device: an H100's SMs and cluster counts): the table's entry, or
    with ``tuned=False`` (or on a miss) the kernel's rule."""
    from repro_torch.kernels import (fused_mlp, packed_conv, popcount_gemm,
                                     xnor_gemm)
    base, pack = _check_key(key)
    sms = _sms(device)
    if base == "packed_conv":
        p = packed_conv.tile_plan(*key[2:], sms, pack_out=pack, tuned=tuned)
    elif base == "popcount_gemm":
        p = popcount_gemm.tile_plan(*key[2:], sms, pack_out=pack,
                                    tuned=tuned)
    elif base.startswith("xnor_gemm"):
        p = xnor_gemm.tile_plan(*key[2:], sms,
                                planes=3 if base.endswith("f32") else 1,
                                pack_out=pack, tuned=tuned)
    else:
        m, k0, ns = key[2:]
        if device is not None and torch.device(device).type == "cuda":
            bm, cs = fused_mlp.launch_config(torch.device(device), m, k0,
                                             list(ns), tuned=tuned)
            return {"bm": bm, "cs": cs}
        hit = _TABLE.get(key) if tuned else None
        if hit is not None:
            return hit
        p = fused_mlp.stack_plan(m, k0, list(ns))
    return {f: int(p[f]) for f in _FIELDS[base]}


def warm(keys: Iterable[Key], device: Any = None) -> Dict[Key, Entry]:
    """Resolve every key's plan now (the table from
    ``REPRO_TORCH_TUNING_TABLE`` loaded, each entry checked, the fused
    stack's cluster occupancy asked of the card) and return them.
    ``BNNServer(prewarm=True)`` calls this with
    ``CompiledBNN.tuning_keys_for_batches`` over its dispatch levels
    before it captures a graph, so no capture is the first to resolve a
    plan."""
    return {k: resolve(k, device) for k in keys}


def candidates(key: Key) -> List[Entry]:
    """Every plan the kernel can take at ``key``."""
    from repro_torch.kernels import (fused_mlp, packed_conv, popcount_gemm,
                                     xnor_gemm)
    base, pack = _check_key(key)
    if base == "packed_conv":
        out = [{"bm": bm, "bn": bn} for bm, bn in packed_conv.TILES]
    elif base == "popcount_gemm":
        out = [{"bm": bm, "bn": bn, "wk": wk}
               for bm, bn, wk in popcount_gemm.TILES
               if not pack or bn >= 32]
    elif base.startswith("xnor_gemm"):
        k32 = key[4]
        out = [{"bm": bm, "bn": bn, "splits": s}
               for bm, bn in xnor_gemm.TILES
               for s in range(1, xnor_gemm.MAX_SPLITS + 1)
               if s == 1 or -(-k32 // s) >= xnor_gemm.MIN_SPLIT_WORDS]
    else:
        out = [{"bm": bm, "cs": cs} for bm in fused_mlp.ROW_TILES
               for cs in fused_mlp.CLUSTERS]
    viable = []
    for e in out:
        try:
            viable.append(check_entry(key, e))
        except ValueError:
            continue
    return viable


class Tuned(NamedTuple):
    """What ``autotune`` found: the best entry, its ms a call, and every
    candidate's (entry, ms) in the order timed."""
    entry: Entry
    ms: float
    times: Tuple[Tuple[Entry, float], ...]


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def time_entry(runner: Callable[[Entry], Any], entry: Entry,
               cuda: bool, iters: int = 5, reps: int = 20) -> float:
    """ms a call of ``runner(entry)``: the first call is discarded (it
    builds and loads the kernel), then the best of ``iters`` runs of
    ``reps`` calls, each run between two synchronizations of the card,
    on the host clock.  On the card the ``reps`` calls are one CUDA
    graph, captured after the first call (its launches recorded and
    added to the counts at every replay, as ``GraphedApply``'s), so a
    run measures the kernels, not the host's launches; the graph's
    first replay is discarded too."""
    from repro_torch.kernels import _build
    runner(entry)
    _sync(cuda)
    if cuda:
        graph = torch.cuda.CUDAGraph()
        with _build.recording() as rec:
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    runner(entry)

        def run():
            graph.replay()
            _build.add_launches(rec)
        run()
        _sync(cuda)
    else:
        def run():
            for _ in range(reps):
                runner(entry)
    best = None
    for _ in range(iters):
        _sync(cuda)
        t0 = time.perf_counter()
        run()
        _sync(cuda)
        dt = (time.perf_counter() - t0) / reps * 1e3
        best = dt if best is None else min(best, dt)
    return best


def autotune(key: Key, runner: Callable[[Entry], Any],
             entries: Optional[Sequence[Entry]] = None,
             device: Any = None, iters: int = 5, reps: int = 20) -> Tuned:
    """Time ``runner(entry)`` (one launch at ``key`` with that plan) over
    ``entries`` (default: every candidate the kernel takes), store the
    fastest in the table and return it with every candidate's time
    (``time_entry``: the first call of each discarded, the card
    synchronized before the clock is read)."""
    cuda = device is not None and torch.device(device).type == "cuda"
    times = []
    for e in (entries if entries is not None else candidates(key)):
        e = check_entry(key, e)
        times.append((e, time_entry(runner, e, cuda, iters, reps)))
    if not times:
        raise ValueError(f"no viable candidates for {key!r}")
    best, ms = min(times, key=lambda t: t[1])
    _TABLE.put(key, best)
    return Tuned(best, ms, tuple(times))


# ------------------------------------------------------------------ #
# the search (needs the card; the models' plans: graph.tuning)         #
# ------------------------------------------------------------------ #
DECODE_SHAPES = ((128, 4096, 4096), (128, 12288, 12288), (1, 8192, 8192))


def words(gen: torch.Generator, *shape) -> torch.Tensor:
    """Random int32 words of ``shape`` from ``gen``, on its device."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device=gen.device, dtype=torch.int64
                         ).to(torch.int32)


def tvec(gen: torch.Generator, n: int, lim: int) -> torch.Tensor:
    """Random per-channel int32 thresholds in [-lim, lim]."""
    return torch.randint(-lim, lim + 1, (n,), generator=gen,
                         device=gen.device, dtype=torch.int32)


def decode_runners(device: torch.device, seed: int = 0
                   ) -> List[Tuple[Key, str, Callable[[Entry], Any]]]:
    """(key, label, runner) of ``binary_dense`` (xnor_gemm) at the decode
    GEMMs, bf16 and float32 x, no epilogue."""
    from repro_torch.kernels import xnor_gemm
    from repro_torch.kernels.ops import plan_dense_launch
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for m, k, n in DECODE_SHAPES:
        wp = words(gen, k // 32, n)
        alpha = torch.rand(n, generator=gen, device=device) + 0.5
        for dt, planes in ((torch.bfloat16, 1), (torch.float32, 3)):
            x = torch.randn(m, k, generator=gen, device=device).to(dt)
            key = plan_dense_launch(m, n, k, op="xnor_gemm",
                                    planes=planes)["key"]

            def run(e, x=x, wp=wp, alpha=alpha):
                return xnor_gemm._launch(
                    x, wp, alpha, (e["bm"], e["bn"], e["splits"]))
            out.append((key, f"binary_dense {m}x{k}x{n} {str(dt)[6:]}",
                        run))
    return out


def xnor_constants(rows: Sequence[dict], sms: int) -> dict:
    """The measured counterparts of ``xnor_gemm``'s cost-model constants
    from the decode keys' whole-K (splits 1) times: MAC_PER_US from the
    64 x 128 / 16 x 128 tiles (relative cost 1.0 in ``TILES``), and each
    tile's cost per multiply-accumulate against that, for bf16 and for
    float32 x (the model's ``TILES[bm, bn][planes > 1]``)."""
    from repro_torch.kernels import xnor_gemm
    mac_per_us, ratio = {}, {}
    for r in rows:
        if not r["key"][0].startswith("xnor_gemm"):
            continue
        m, n, k32 = r["key"][2:]
        planes = 3 if "_f32" in r["key"][0] else 1
        unit = {}
        for e, ms in r["times"]:
            if e["splits"] != 1:
                continue
            waves = -(-(-(-m // e["bm"]) * -(-n // e["bn"])) // sms)
            macs = waves * e["bm"] * e["bn"] * 32 * k32 * planes
            unit[e["bm"], e["bn"]] = ms * 1e3 / macs   # us per modelled MAC
        ref = unit.get((16, 128) if m <= 16 else (64, 128))
        if ref is None:
            continue
        mac_per_us.setdefault(planes, []).append(1.0 / ref)
        for t, u in unit.items():
            ratio.setdefault((t, planes), []).append(u / ref)
    mean = (lambda v: sum(v) / len(v))
    return {"MAC_PER_US": {"model": xnor_gemm.MAC_PER_US,
                           "measured": {p: mean(v) for p, v in
                                        mac_per_us.items()}},
            "TILES": {f"{t[0]}x{t[1]} planes={p}":
                      {"model": xnor_gemm.TILES[t][p > 1],
                       "measured": mean(v)}
                      for (t, p), v in sorted(ratio.items())}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import subprocess
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="Time every launch plan of the models' kernels on the "
                    "card and save the fastest as a tuning table.")
    ap.add_argument("--model", nargs="+", default=["binarynet", "alexnet"],
                    choices=["binarynet", "alexnet"])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 32, 256])
    ap.add_argument("--out", required=True,
                    help="where the table is saved (JSON)")
    ap.add_argument("--no-decode", action="store_true",
                    help="skip binary_dense's decode GEMMs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the tuner times kernels on a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    from repro_torch.graph.tuning import tune_models
    dev = torch.device("cuda")
    _TABLE.clear()
    rows = tune_models(args.model, args.batches, dev,
                       decode=not args.no_decode)
    _TABLE.save(args.out)
    hits = sum(r["rule"] == r["best"] for r in rows)
    print(f"{smi}: the rule's plan is the fastest at {hits} of {len(rows)} "
          f"keys; table of {len(_TABLE)} entries in {args.out}")
    if not args.no_decode:
        from repro_torch.kernels import _build
        c = xnor_constants(rows, _build.device_sms(dev))
        print(f"{smi}: xnor_gemm MAC_PER_US model {c['MAC_PER_US']['model']}"
              f", measured {c['MAC_PER_US']['measured']} (by planes)")
        for t, v in c["TILES"].items():
            print(f"{smi}: xnor_gemm TILES[{t}] model {v['model']}, "
                  f"measured {v['measured']:.3f}")
    return 0


if __name__ == "__main__":
    # run main in the package's module, whose table the tuner fills (this
    # file also runs as __main__, a second module with a table of its own)
    from repro_torch.kernels import autotune as _autotune
    raise SystemExit(_autotune.main())
