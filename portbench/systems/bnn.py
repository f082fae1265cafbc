"""Family ``bnn``: a binarized network served by the port's BNNServer.

The system under test is ``repro_torch``'s serving path as a user
reaches it: ``graph.compile(...)`` with the hand-written kernels, the
params packed by the port's own ``PackedArray.pack``, and
``BNNServer(..., prewarm=True).start()``, driven through ``submit``
(each flight replays one CUDA graph per (bucket, valid rows) level).

The benchmark makes the data, on the device and from the seed, in a few
large calls: float32 normal weights for every layer, int32 thresholds in
[-3, 3] for every thresholded layer, and a pool of 8-bit pixel images
(0..255 as float32 NHWC) that requests slice.  The program gets the
weights packed by its own code; the reference in
``portbench/reference/bnn.py`` gets the same float weights and works out
its signs and alphas itself.
"""
from __future__ import annotations

import gc
from typing import Any, Dict, List, Sequence, Tuple

import torch

from portbench import clients
from portbench.reference import bnn as reference

THRESHOLD_RANGE = 3


def weight_shapes(layers: Sequence[Dict]) -> List[Tuple[Tuple[int, ...],
                                                         int]]:
    """(weight shape, threshold count) of each conv and dense layer in
    order: conv [K, K, C_in, C_out], dense [N_out, N_in]; binary convs
    and every dense layer but the last have thresholds."""
    dense = [ly for ly in layers if ly["op"] == "dense"]
    out = []
    for ly in layers:
        if ly["op"] == "conv":
            shape = (ly["k"], ly["k"], ly["c_in"], ly["c_out"])
            out.append((shape, ly["c_out"] if ly["kind"] == "binary" else 0))
        elif ly["op"] == "dense":
            out.append(((ly["n_out"], ly["n_in"]),
                        0 if ly is dense[-1] else ly["n_out"]))
    return out


def make_data(config: Dict, traffic: Dict, seed: int, device: str
              ) -> Tuple[List[Dict[str, torch.Tensor]], torch.Tensor]:
    """The weights and the input pool of a run, from the seed, on the
    device: one draw of normals for all weights, one of integers for all
    thresholds, one for the pool."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = weight_shapes(config["layers"])
    n_w = sum(torch.Size(s).numel() for s, _ in shapes)
    n_t = sum(t for _, t in shapes)
    flat = torch.randn(n_w, generator=gen, device=device)
    thr = torch.randint(-THRESHOLD_RANGE, THRESHOLD_RANGE + 1, (n_t,),
                        generator=gen, device=device, dtype=torch.int32)
    weights, i, j = [], 0, 0
    for shape, nt in shapes:
        n = torch.Size(shape).numel()
        p = {"w": flat[i:i + n].view(shape)}
        i += n
        if nt:
            p["t"] = thr[j:j + nt]
            j += nt
        weights.append(p)
    rows = pool_rows(traffic)
    pool = torch.randint(0, 256, (rows, *config["input_shape"]),
                         generator=gen, device=device,
                         dtype=torch.uint8).to(torch.float32)
    return weights, pool


def pool_rows(traffic: Dict) -> int:
    """Images in the input pool: room for two of the largest request."""
    return max(1024, 2 * clients.max_size(traffic["sizes"]))


def compare(layers: Sequence[Dict], weights: List[Dict[str, torch.Tensor]],
            pool: torch.Tensor, sample: Sequence[Tuple[int, int, Any]],
            precision: str = "exact") -> Dict[str, float]:
    """Each sampled answer against the reference on the same images: the
    share of images whose logits differ from the reference's anywhere
    (the logits are exact integer dots, so an exact match is the norm),
    and the widest gap of one logit.  With ``precision`` other than
    "exact" the reference in that precision stands in for the answers:
    the control."""
    images = differ = 0
    gap = 0.0
    for off, n, y in sample:
        x = pool[off:off + n]
        want = reference.logits(layers, weights, x)
        got = y if precision == "exact" else \
            reference.logits(layers, weights, x, precision)
        got = got.to(device=want.device, dtype=torch.float32)
        if got.shape != want.shape:
            differ += n
            images += n
            gap = float("inf")
            continue
        d = (got - want).abs()
        differ += int((d.amax(dim=1) > 0).sum())
        images += n
        gap = max(gap, float(d.max()))
    return {"mismatch_share": differ / images if images else 1.0,
            "images": images, "max_abs_diff": gap}


def workload_of(config: Dict) -> Any:
    """The configuration's layer table as the program's paper Workload
    (``graph.compile`` lowers it and infers strides, pads and pools from
    the dims; the reference takes them from the table itself)."""
    from repro_torch.core.workloads import ConvLayer, FCLayer, Workload

    conv = tuple(ConvLayer(ly["name"], ly["c_in"], ly["c_out"], ly["in_hw"],
                           ly["in_hw"], ly["out_hw"], ly["out_hw"], ly["k"],
                           integer=ly["kind"] == "integer",
                           parts=ly.get("parts", 1))
                 for ly in config["layers"] if ly["op"] == "conv")
    fc = tuple(FCLayer(ly["name"], ly["n_in"], ly["n_out"])
               for ly in config["layers"] if ly["op"] == "dense")
    return Workload(config["name"], config.get("dataset", ""), conv, fc)


def port_params(compiled: Any, layers: Sequence[Dict],
                weights: List[Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """The program's parameter tree (``CompiledBNN.init``'s layout) from
    the benchmark's weights, packed by the program's ``PackedArray``."""
    from repro_torch.graph.ir import IntegerEntry
    from repro_torch.kernels.packed import PackedArray

    weighted = [ly for ly in layers if ly["op"] != "maxpool"]
    convs = [w for ly, w in zip(weighted, weights) if ly["op"] == "conv"]
    denses = [w for ly, w in zip(weighted, weights) if ly["op"] == "dense"]
    params: Dict[str, Any] = {"conv": [], "fc": []}
    for nd, p in zip(compiled.spec.conv_nodes, convs):
        if isinstance(nd, IntegerEntry):
            params["conv"].append({"w": p["w"],
                                   "alpha": p["w"].abs().mean(dim=(0, 1, 2))})
        else:
            params["conv"].append({"wf": PackedArray.pack(p["w"], axis=2),
                                   "t": p["t"]})
    for p in denses:
        q = {"wp": PackedArray.pack(p["w"], axis=-1)}
        if "t" in p:
            q["t"] = p["t"]
        params["fc"].append(q)
    return params


class System:
    """The port's server over one configuration, ready for traffic."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str):
        from repro_torch import graph
        from repro_torch.serving import BNNServer

        self.device = device
        self.layers = config["layers"]
        self.weights, self.pool = make_data(config, traffic, seed, device)
        self.pool_rows = int(self.pool.shape[0])
        srv = traffic["server"]
        cb = graph.compile(workload_of(config), backend="cuda",
                           device=device, batch=int(srv["max_batch"]))
        names = [nd.name for nd in cb.spec.conv_nodes] + \
            [nd.name for nd in cb.spec.dense_nodes]
        want = [ly["name"] for ly in self.layers if ly["op"] != "maxpool"]
        if names != want:
            raise ValueError(f"the program's layers {names} are not the "
                             f"table's {want}")
        params = port_params(cb, self.layers, self.weights)
        self.server = BNNServer(
            cb, params, max_batch=int(srv["max_batch"]),
            dispatch_ahead=int(srv.get("dispatch_ahead", 2)),
            admit_window_s=float(srv.get("admit_window_s", 0.002)),
            prewarm=True, device=device)
        self.server.start()

    def payload(self, off: int, n: int) -> torch.Tensor:
        return self.pool[off:off + n]

    def submit(self, x: torch.Tensor) -> Any:
        return self.server.submit(x)

    def stats(self) -> Dict[str, Any]:
        return self.server.stats()

    def memory_peak(self) -> int:
        if self.device != "cuda":
            return 0
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_reserved())

    def device_name(self) -> str:
        return torch.cuda.get_device_name() if self.device == "cuda" \
            else self.device

    def close(self) -> None:
        """Stop the server and free the program's state (graphs, packed
        params), keeping the benchmark's weights, pool and answers."""
        self.server.stop()
        self.server = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, sample: Sequence[Tuple[int, int, Any]]) -> Dict[str, float]:
        return compare(self.layers, self.weights, self.pool, sample)
