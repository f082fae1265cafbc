"""The LLM side: ten architectures' forward, prefill and decode, with
the paper's binarized projections (the port of ``repro.models``;
``loss_fn`` comes with the training path)."""
from repro_torch.models.model import (abstract_params, decode_step, forward,
                                      init_caches, init_params, input_specs,
                                      prefill)

__all__ = ["abstract_params", "decode_step", "forward", "init_caches",
           "init_params", "input_specs", "prefill"]
