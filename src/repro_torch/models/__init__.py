"""The LLM side: ten architectures' forward, train loss, prefill and
decode, with the paper's binarized projections (the port of
``repro.models``)."""
from repro_torch.models.model import (abstract_params, decode_step, forward,
                                      init_caches, init_params, input_specs,
                                      loss_fn, prefill)

__all__ = ["abstract_params", "decode_step", "forward", "init_caches",
           "init_params", "input_specs", "loss_fn", "prefill"]
