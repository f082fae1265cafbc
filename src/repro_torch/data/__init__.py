"""The port's copies of the reference's data streams (numpy,
bit-identical batches): the image stream (``repro.data.images``) and
the synthetic token stream (``repro.data.pipeline``)."""
from repro_torch.data.images import (ImageDataConfig, ImageIterator,
                                     class_prototypes, eval_batch_at,
                                     image_batch_at, image_shard_batch_at,
                                     load_cifar10)
from repro_torch.data.pipeline import (DataConfig, DataIterator,
                                       global_batch_at, shard_batch_at)

__all__ = ["DataConfig", "DataIterator", "ImageDataConfig", "ImageIterator",
           "class_prototypes", "eval_batch_at", "global_batch_at",
           "image_batch_at", "image_shard_batch_at", "load_cifar10",
           "shard_batch_at"]
