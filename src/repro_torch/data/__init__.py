"""The port's copy of the reference's image data stream
(``repro.data.images``): numpy, bit-identical batches."""
from repro_torch.data.images import (ImageDataConfig, ImageIterator,
                                     class_prototypes, eval_batch_at,
                                     image_batch_at, image_shard_batch_at,
                                     load_cifar10)

__all__ = ["ImageDataConfig", "ImageIterator", "class_prototypes",
           "eval_batch_at", "image_batch_at", "image_shard_batch_at",
           "load_cifar10"]
