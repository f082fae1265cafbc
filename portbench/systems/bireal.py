"""Family ``bireal``: a residual binary network whose half-steps have no
learned activations and whose downsampling shortcuts are float 1x1
convs (Bi-Real Net), served by the port's BNNServer.

The system under test is ``repro_torch``'s serving path as a user
reaches it: the configuration's layer table as the port's IR (a
``RealConv`` that carries the max pool after it, ``ResidualBinaryConv``
with ``rprelu=False``, ``GlobalAvgPool``, ``RealDense``),
``graph.compile(...)`` with the hand-written kernels, the params bound
by the port's own ``CompiledBNN.bind`` (its packing, zero-padding
corrections, neutral tables and projection tables), and
``BNNServer(..., prewarm=True).start()``, driven through ``submit``.

The benchmark makes the data on the device and from the seed, in a few
large calls: one draw of normals for every weight (the projections'
1x1 convs among them), one of uniforms for every per-channel number,
one of 8-bit pixels (0..255 as float32 NHWC) for the pool that
requests slice.  The ranges are the configuration's ``assumed``.  The
program and the reference in ``portbench/reference/bireal.py`` get the
same published-form params.

The check: an image is mismatched where any of its logits differs from
the reference's by more than ``reference.LOGIT_REL_TOL`` times the
largest magnitude of the reference's logits for that image.
"""
from __future__ import annotations

import gc
from typing import Any, Dict, List, Sequence, Tuple

import torch

from portbench import clients
from portbench.reference import bireal as reference

# the variance of one uniform 8-bit pixel, and its mean
PIXEL_VAR = (256.0 ** 2 - 1.0) / 12.0
PIXEL_MEAN = 127.5


def _weighted(layers: Sequence[Dict]) -> List[Dict]:
    return [ly for ly in layers if ly["op"] not in ("avgpool", "maxpool")]


def weight_shapes(layer: Dict) -> List[Tuple[int, ...]]:
    """The normals a layer draws: its weights, and a projection row's
    1x1 conv [c_in, c_out] after them."""
    if layer["op"] == "real_dense":
        return [(layer["n_out"], layer["n_in"])]
    shapes = [(layer["k"], layer["k"], layer["c_in"], layer["c_out"])]
    if layer.get("shortcut") == "projection":
        shapes.append((layer["c_in"], layer["c_out"]))
    return shapes


def _channel_rows(layer: Dict) -> int:
    """Per-channel numbers a layer draws: a conv's batch norm (four), a
    projection's too; a head's bias."""
    if layer["op"] == "real_dense":
        return layer["n_out"]
    n = 4 * layer["c_out"]
    return 2 * n if layer.get("shortcut") == "projection" else n


def make_data(config: Dict, traffic: Dict, seed: int, device: str
              ) -> Tuple[List[Dict[str, torch.Tensor]], torch.Tensor]:
    """The weights (one dict a weighted row, the reference's form) and
    the input pool of a run, from the seed, on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    layers = _weighted(config["layers"])
    shapes = [weight_shapes(ly) for ly in layers]
    flat = torch.randn(sum(torch.Size(s).numel() for ss in shapes
                           for s in ss), generator=gen, device=device)
    uni = torch.rand(sum(_channel_rows(ly) for ly in layers), generator=gen,
                     device=device)
    weights, i, j = [], 0, 0

    def normal(shape):
        nonlocal i
        n = torch.Size(shape).numel()
        w = flat[i:i + n].view(shape)
        i += n
        return w

    def take(n, lo, hi):
        nonlocal j
        u = uni[j:j + n]
        j += n
        return lo + (hi - lo) * u

    def bn(n, var_of_sum, mean_of_sum):
        sd = var_of_sum.sqrt()
        return {"mean": mean_of_sum + take(n, -0.5, 0.5) * sd,
                "var": take(n, 0.5, 2.0) * var_of_sum,
                "gamma": take(n, 0.5, 1.5), "beta": take(n, -0.5, 0.5)}

    for ly, ss in zip(layers, shapes):
        w = normal(ss[0])
        if ly["op"] == "real_conv":
            weights.append({"w": w, **bn(
                ly["c_out"], PIXEL_VAR * (w * w).sum(dim=(0, 1, 2)),
                PIXEL_MEAN * w.sum(dim=(0, 1, 2)))})
        elif ly["op"] == "real_dense":
            weights.append({"w": w / float(ly["n_in"]) ** 0.5,
                            "b": take(ly["n_out"], -0.1, 0.1)})
        else:
            f = ly["c_out"]
            alpha = w.abs().mean(dim=(0, 1, 2))
            p = {"w": w, **bn(f, alpha * alpha * ly["k"] ** 2 * ly["c_in"],
                              torch.zeros_like(alpha))}
            if len(ss) > 1:
                pw = normal(ss[1])
                var = (pw * pw).sum(dim=0)
                p["proj"] = {"w": pw, **bn(f, var, torch.zeros_like(var))}
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
    share of images with a logit further from the reference's than
    ``reference.LOGIT_REL_TOL`` times the image's largest reference logit
    magnitude, the widest gap of one logit, and the widest such gap over
    that magnitude.  With ``precision`` other than "exact" the reference
    in that precision stands in for the answers: the control."""
    tol = reference.LOGIT_REL_TOL
    images = differ = 0
    gap = rel = 0.0
    for off, n, y in sample:
        x = pool[off:off + n]
        want = reference.logits(layers, weights, x)
        got = y if precision == "exact" else \
            reference.logits(layers, weights, x, precision)
        got = got.to(device=want.device, dtype=torch.float32)
        images += n
        if got.shape != want.shape:
            differ += n
            gap = rel = float("inf")
            continue
        d = (got - want).abs().amax(dim=1)
        scale = want.abs().amax(dim=1)
        r = d / scale
        differ += int((~(d <= tol * scale)).sum())
        gap = max(gap, float(d.max()))
        rel = max(rel, float(r.max()))
    return {"mismatch_share": differ / images if images else 1.0,
            "images": images, "max_abs_diff": gap, "max_rel_diff": rel}


def spec_of(config: Dict) -> Any:
    """The configuration's layer table as the program's IR: a
    ``maxpool`` row goes into the ``real_conv`` before it."""
    from repro_torch.graph import ir

    nodes: list = []
    rows = config["layers"]
    for i, ly in enumerate(rows):
        op = ly["op"]
        if op == "real_conv":
            pool = rows[i + 1] if i + 1 < len(rows) and \
                rows[i + 1]["op"] == "maxpool" else None
            out = pool["out_hw"] if pool else ly["out_hw"]
            nodes.append(ir.RealConv(
                ly["name"], ly["k"], ly["k"], ly["c_in"], ly["c_out"],
                ly["in_hw"], ly["in_hw"], out, out, ly["stride"], ly["pad"],
                pool=pool is not None))
        elif op == "maxpool":
            if i == 0 or rows[i - 1]["op"] != "real_conv" or \
                    (ly["window"], ly["stride"], ly["pad"]) != \
                    ir.STEM_POOL:
                raise ValueError(f"{ly['name']}: the program takes the max "
                                 f"pool {ir.STEM_POOL} after the stem")
        elif op == "conv":
            nodes.append(ir.ResidualBinaryConv(
                ly["name"], ly["k"], ly["c_in"], ly["c_out"], ly["in_hw"],
                ly["in_hw"], ly["out_hw"], ly["out_hw"], ly["stride"],
                ly["pad"], ly["shortcut"], rprelu=ly["rprelu"]))
        elif op == "avgpool":
            nodes.append(ir.GlobalAvgPool(ly["name"]))
        elif op == "real_dense":
            nodes += [ir.RealDense(ly["name"], ly["n_in"], ly["n_out"]),
                      ir.Logits("logits", ly["n_out"])]
        else:
            raise ValueError(f"unknown layer op {op!r}")
    spec = ir.BNNSpec(config["name"], tuple(config["input_shape"]),
                      tuple(nodes), dataset=config.get("dataset", ""))
    spec.validate()
    return spec


def published_params(layers: Sequence[Dict],
                     weights: List[Dict[str, torch.Tensor]]
                     ) -> Dict[str, Any]:
    """The benchmark's weights as the program's published-form tree
    (``CompiledBNN.bind`` takes it)."""
    tree: Dict[str, Any] = {"conv": [], "fc": [], "stem": [], "res": [],
                            "head": []}
    key = {"real_conv": "stem", "conv": "res", "real_dense": "head"}
    for ly, w in zip(_weighted(layers), weights):
        tree[key[ly["op"]]].append(w)
    return tree


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
        cb = graph.compile(spec_of(config), backend="cuda", device=device,
                           batch=int(srv["max_batch"]))
        params = cb.bind(published_params(self.layers, self.weights))
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
        """Stop the server and free the program's state (graphs, bound
        params), keeping the benchmark's weights, pool and answers."""
        self.server.stop()
        self.server = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, sample: Sequence[Tuple[int, int, Any]]) -> Dict[str, float]:
        return compare(self.layers, self.weights, self.pool, sample)
