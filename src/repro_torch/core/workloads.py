"""BNN workload specs used by the paper's evaluation (Tables III-V).

A copy of ``repro.core.workloads``: the port imports nothing of the
JAX package.

Layer dims reconstructed from the cited networks:
  * BinaryNet (Courbariaux et al. [9]) CIFAR-10: 6 conv (128..512, 3x3,
    same-pad, maxpool after every 2nd conv) + 3 FC (1024, 1024, 10).
  * AlexNet (XNOR-Net variant [30]) ImageNet: 5 conv + 3 FC; layers 1-2
    integer, 3-5 binary (paper Table III).

The paper reports 1017/2050 MOp (conv) and 1036/2168 MOp (all); our
reconstruction yields the same FC counts and slightly different conv
counts (pad/stride bookkeeping of the original nets is underspecified);
both designs are evaluated on the *same* spec so all ratios are
apples-to-apples.  benchmarks/table3.py checks the P/Z columns exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ConvLayer:
    name: str
    z1: int          # input feature maps
    z2: int          # output feature maps
    x1: int          # input width
    y1: int          # input height
    x2: int          # output width
    y2: int          # output height
    k: int           # kernel size
    integer: bool    # integer (first) layer vs binary layer
    parts: int = 1   # image split into buffer-sized parts (Table III col 2)

    @property
    def ops(self) -> int:
        """Paper §V-C: 2*z1*k^2*x2*y2*z2 MACs + x2*y2*z2 compares."""
        return 2 * self.z1 * self.k ** 2 * self.x2 * self.y2 * self.z2 \
            + self.x2 * self.y2 * self.z2

    @property
    def node_inputs_per_pass(self) -> int:
        """Products per on-chip pass: kernel window over 32 resident IFMs."""
        return self.k ** 2 * min(self.z1, 32)


@dataclass(frozen=True)
class FCLayer:
    name: str
    n_in: int
    n_out: int
    integer: bool = False

    @property
    def ops(self) -> int:
        return 2 * self.n_in * self.n_out + self.n_out


@dataclass(frozen=True)
class Workload:
    name: str
    dataset: str
    conv: Tuple[ConvLayer, ...]
    fc: Tuple[FCLayer, ...]

    @property
    def conv_ops(self) -> int:
        return sum(ly.ops for ly in self.conv)

    @property
    def total_ops(self) -> int:
        return self.conv_ops + sum(ly.ops for ly in self.fc)


def binarynet_cifar10() -> Workload:
    conv = (
        ConvLayer("conv1", 3, 128, 32, 32, 32, 32, 3, integer=True),
        ConvLayer("conv2", 128, 128, 32, 32, 32, 32, 3, integer=False),
        ConvLayer("conv3", 128, 256, 16, 16, 16, 16, 3, integer=False),
        ConvLayer("conv4", 256, 256, 16, 16, 16, 16, 3, integer=False),
        ConvLayer("conv5", 256, 512, 8, 8, 8, 8, 3, integer=False),
        ConvLayer("conv6", 512, 512, 8, 8, 8, 8, 3, integer=False),
    )
    fc = (
        FCLayer("fc1", 512 * 4 * 4, 1024),
        FCLayer("fc2", 1024, 1024),
        FCLayer("fc3", 1024, 10),
    )
    return Workload("BinaryNet", "CIFAR10", conv, fc)


def alexnet_imagenet() -> Workload:
    """XNOR-Net AlexNet: layers 1-2 integer (Table III), 3-5 binary."""
    conv = (
        ConvLayer("conv1", 3, 96, 227, 227, 55, 55, 11, integer=True,
                  parts=4),
        ConvLayer("conv2", 96, 256, 27, 27, 27, 27, 5, integer=True),
        ConvLayer("conv3", 256, 384, 13, 13, 13, 13, 3, integer=False),
        ConvLayer("conv4", 384, 384, 13, 13, 13, 13, 3, integer=False),
        ConvLayer("conv5", 384, 256, 13, 13, 13, 13, 3, integer=False),
    )
    fc = (
        FCLayer("fc6", 256 * 6 * 6, 4096),
        FCLayer("fc7", 4096, 4096),
        FCLayer("fc8", 4096, 1000),
    )
    return Workload("AlexNet", "Imagenet", conv, fc)


WORKLOADS = {
    "binarynet": binarynet_cifar10(),
    "alexnet": alexnet_imagenet(),
}
