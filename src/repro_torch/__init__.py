"""repro_torch — the PyTorch/CUDA port of the TULIP BNN serving stack.

The JAX package ``repro`` is the reference; this package runs the same
functions on an NVIDIA H100 with hand-written Hopper kernels and
imports nothing of ``repro`` (nor jax).  Its entry points run on the
card unless the caller passes ``device="cpu"``, where every kernel
wrapper takes its plain torch version.

    from repro_torch import graph
    from repro_torch.core.workloads import binarynet_cifar10
    cb = graph.compile(binarynet_cifar10())          # device="cuda"
    params = cb.init(torch.Generator().manual_seed(0))
    logits = cb.apply(params, images)                # [N, 10] float32

The LLM side (ten architectures with binarized projections, packed
serving weights and a decode engine): ``repro_torch.configs``,
``repro_torch.models`` and ``repro_torch.launch.serve.Engine``.
"""
