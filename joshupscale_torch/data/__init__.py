"""Dataset pipeline: config-driven op chains producing numpy batches."""

from joshupscale_torch.data.pipeline import (
    DATASET_OPS,
    create_dataset,
    create_train_dataset,
    create_val_dataset,
)

__all__ = [
    "DATASET_OPS",
    "create_dataset",
    "create_train_dataset",
    "create_val_dataset",
]
