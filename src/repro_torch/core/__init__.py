"""The port's copies of the reference's core modules.

 - workloads.py   the paper's BNN workload specs (Tables III-V)
 - bnn_layers.py  the serving half of the binarized layers: threshold
                  folding, the binary and float entry convs, the OR-pool
 - binarize.py    sign/STE, bit packing (training)
 - threshold.py   threshold-gate algebra (paper §II)
 - isa.py         TULIP-PE micro-op ISA (paper §IV-A, Fig 3)
 - tulip_pe.py    cycle-accurate PE simulator (numpy + a torch twin,
                  batched over the PEs)
 - schedules.py   add / accumulate / compare / maxpool / relu schedules
 - adder_tree.py  popcount decomposition + RPO list scheduler (§III, §IV-B)
 - energy.py      ASIC energy/area/latency model (Tables I, II, IV, V)
 - mapping.py     BNN layer -> PE-array mapping + refetch model (Table III)
"""
