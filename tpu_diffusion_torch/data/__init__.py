from tpu_diffusion_torch.data.registry import (ArrayDataset, epoch_batches,
                                               get_dataset, infinite_batches,
                                               synthetic_images)

__all__ = ["ArrayDataset", "epoch_batches", "get_dataset",
           "infinite_batches", "synthetic_images"]
