"""repro_torch.sim — cycle/energy-accurate TULIP-PE mesh simulation + DSE.

The port of ``repro.sim``: ``simulate`` runs a compiled BNNSpec on a
configurable mesh (:class:`MeshConfig`), bit-identical to the
``CompiledBNN.apply`` oracle (on the card: the port's Hopper kernels)
and priced by the calibrated core/energy model; ``run_dse``
(``repro_torch.sim.dse``) sweeps the config space and emits the Pareto
frontier the reference committed in benchmarks/BENCH_dse.json.

Layering: sim imports core, graph and kernels; never the serving or
robustness layers.
"""
from repro_torch.sim.mesh import MeshConfig, tree_capacity
from repro_torch.sim.simulator import SimLayer, SimResult, simulate

__all__ = ["MeshConfig", "SimLayer", "SimResult", "simulate",
           "tree_capacity"]
