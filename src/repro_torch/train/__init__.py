"""repro_torch.train — STE training for the binarized models the
compiler serves, on the card (the port of ``repro.train``).

The closed loop::

    from repro_torch import graph, train
    from repro_torch.data import ImageDataConfig
    from repro_torch.serving import BNNServer

    spec = graph.from_dense_stack(768, [512, 256, 10], logits=True)
    dcfg = ImageDataConfig(10, 16, 16, 3, global_batch=64)
    out = train.fit(spec, dcfg, train.TrainConfig(steps=200),
                    ckpt_dir="ckpts/mlp")                 # device="cuda"
    cb, sparams = train.export_compiled(spec, out["params"], out["bn"])
    train.check_sign_identity(spec, out["params"], out["bn"], x)
    BNNServer(cb, sparams).apply_batch(x)  # the trained checkpoint

Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""

from repro_torch.train.export import (check_sign_identity, export_compiled,
                                      export_serving_params)
from repro_torch.train.loop import (TrainConfig, default_logit_scale,
                                    evaluate, fit, make_train_step)
from repro_torch.train.models import (clip_mask_for, init_train_state,
                                      train_forward)

__all__ = [
    "TrainConfig",
    "check_sign_identity",
    "clip_mask_for",
    "default_logit_scale",
    "evaluate",
    "export_compiled",
    "export_serving_params",
    "fit",
    "init_train_state",
    "make_train_step",
    "train_forward",
]
