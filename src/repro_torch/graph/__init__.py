"""repro_torch.graph — the BNN IR + compile pipeline on the card.

    from repro_torch import graph
    cb = graph.compile(binarynet_cifar10())     # runs on "cuda"
    params = cb.init(torch.Generator().manual_seed(0))
    logits = cb.apply(params, images)
    print(cb.describe())                        # every lowering decision
    rows = cb.tulip_mapping()                   # the ASIC schedule model
    g = graph.GraphedApply(cb, params, batch=256)  # one CUDA graph
    logits = g(images)
"""
from repro_torch.graph.compile import (CompiledBNN, compile,
                                       compile_dense_stack,
                                       serve_folded_stack)
from repro_torch.graph.ir import (Binarize, BinaryConv, BinaryDense,
                                  BNNSpec, BNThreshold, IntegerEntry,
                                  Logits, MaxPool, from_dense_stack,
                                  from_workload, spec_to_workload)
from repro_torch.graph.passes import PlanStep, build_plan
from repro_torch.graph.replay import GraphedApply

__all__ = ["Binarize", "BinaryConv", "BinaryDense", "BNNSpec",
           "BNThreshold", "CompiledBNN", "GraphedApply", "IntegerEntry",
           "Logits", "MaxPool", "PlanStep", "build_plan", "compile",
           "compile_dense_stack", "from_dense_stack", "from_workload",
           "serve_folded_stack", "spec_to_workload"]
