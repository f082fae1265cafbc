"""repro_torch.graph — the BNN IR + compile pipeline on the card.

    from repro_torch import graph
    cb = graph.compile(binarynet_cifar10())     # runs on "cuda"
    params = cb.init(torch.Generator().manual_seed(0))
    logits = cb.apply(params, images)
    print(cb.describe())                        # every lowering decision
"""
from repro_torch.graph.compile import CompiledBNN, compile
from repro_torch.graph.ir import (Binarize, BinaryConv, BinaryDense,
                                  BNNSpec, BNThreshold, IntegerEntry,
                                  Logits, MaxPool, from_dense_stack,
                                  from_workload)
from repro_torch.graph.passes import PlanStep, build_plan

__all__ = ["Binarize", "BinaryConv", "BinaryDense", "BNNSpec",
           "BNThreshold", "CompiledBNN", "IntegerEntry", "Logits",
           "MaxPool", "PlanStep", "build_plan", "compile",
           "from_dense_stack", "from_workload"]
