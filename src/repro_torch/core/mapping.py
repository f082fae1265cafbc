"""Mapping BNN layers onto the PE array + input-refetch model (Table III).

A copy of ``repro.core.mapping``: the port imports nothing of the
JAX package.

The paper's architectural schedule: 32 IFMs are resident on-chip (L2);
OFMs are produced in batches sized by the number of parallel units
(32 MACs or 256 TULIP-PEs).  Each OFM batch refetches the resident IFMs
(Z refetches), and when z1 exceeds the resident set, partial sums are
computed in P passes and accumulated on-chip.  MAC units can fetch twice
the IFMs when the kernel is small (k <= 5), halving P for MAC layers.

The product P*Z is the paper's input-refetch metric: TULIP's 256-OFM
batches cut Z by 8x on binary layers, which is where the energy win
comes from (§V-C, Table III).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.workloads import ConvLayer, FCLayer


@dataclass(frozen=True)
class ArchParams:
    name: str
    n_macs: int              # parallel MAC units (integer + YodaNN-binary)
    n_pes: int               # parallel TULIP-PEs (binary layers)
    ifm_resident: int = 32   # IFMs loaded on-chip at a time
    ofm_batch_mac: int = 32
    ofm_batch_pe: int = 256
    mac_double_fetch_k: int = 5   # k <= 5: MACs fetch 2x IFMs (paper §V-C)


YODANN = ArchParams("YodaNN", n_macs=32, n_pes=0)
TULIP = ArchParams("TULIP", n_macs=32, n_pes=256)


@dataclass(frozen=True)
class LayerMapping:
    layer_name: str
    uses_pe: bool
    P: int                   # partial-product passes
    Z: int                   # IFM refetches (OFM batches)
    parts: int               # image parts (buffer capacity, Table III col 2)
    ifm_per_pass: int
    node_inputs: int         # popcount fan-in per unit per pass
    n_units: int
    ofm_batch: int

    @property
    def refetch_product(self) -> int:
        return self.P * self.Z


def map_conv(layer: ConvLayer, arch: ArchParams) -> LayerMapping:
    uses_pe = (not layer.integer) and arch.n_pes > 0
    if uses_pe:
        ifm_per_pass = min(layer.z1, arch.ifm_resident)
        ofm_batch = arch.ofm_batch_pe
        n_units = arch.n_pes
    else:
        double = 2 if layer.k <= arch.mac_double_fetch_k else 1
        ifm_per_pass = min(layer.z1, arch.ifm_resident * double)
        ofm_batch = arch.ofm_batch_mac
        n_units = arch.n_macs
    P = math.ceil(layer.z1 / ifm_per_pass)
    Z = math.ceil(layer.z2 / ofm_batch)
    return LayerMapping(
        layer_name=layer.name, uses_pe=uses_pe, P=P, Z=Z, parts=layer.parts,
        ifm_per_pass=ifm_per_pass, node_inputs=layer.k ** 2 * ifm_per_pass,
        n_units=n_units, ofm_batch=ofm_batch)


def map_fc(layer: FCLayer, arch: ArchParams) -> LayerMapping:
    """FC = 1x1 'convolution' over a single pixel; binary FC runs on the
    PEs in TULIP, on MACs in YodaNN (estimated as element-wise matmul,
    paper §V-A)."""
    uses_pe = (not layer.integer) and arch.n_pes > 0
    n_units = arch.n_pes if uses_pe else arch.n_macs
    ofm_batch = arch.ofm_batch_pe if uses_pe else arch.ofm_batch_mac
    # inputs are streamed; accumulate in chunks of the resident buffer
    chunk = arch.ifm_resident * 32   # 32 IFM-equivalents of 32 values
    P = math.ceil(layer.n_in / chunk)
    Z = math.ceil(layer.n_out / ofm_batch)
    return LayerMapping(
        layer_name=layer.name, uses_pe=uses_pe, P=P, Z=Z, parts=1,
        ifm_per_pass=min(layer.n_in, chunk),
        node_inputs=min(layer.n_in, chunk), n_units=n_units,
        ofm_batch=ofm_batch)


def table3_rows(workload, arch_a: ArchParams = YODANN,
                arch_b: ArchParams = TULIP):
    """Reproduce Table III: per-conv-layer P, Z, P*Z for both designs."""
    rows = []
    for layer in workload.conv:
        ma, mb = map_conv(layer, arch_a), map_conv(layer, arch_b)
        rows.append({
            "layer": layer.name,
            "kind": "Integer" if layer.integer else "Binary",
            "parts": layer.parts,
            f"{arch_a.name}_P": ma.P, f"{arch_a.name}_Z": ma.Z,
            f"{arch_a.name}_PZ": ma.refetch_product,
            f"{arch_b.name}_P": mb.P, f"{arch_b.name}_Z": mb.Z,
            f"{arch_b.name}_PZ": mb.refetch_product,
        })
    return rows
