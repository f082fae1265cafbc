"""The port's copies of the reference's core modules.

 - workloads.py   the paper's BNN workload specs (Tables III-V)
 - bnn_layers.py  the serving half of the binarized layers: threshold
                  folding, the binary and float entry convs, the OR-pool
"""
