"""Datasets, loaders and device-side preprocessing of the port."""

from vitx_torch.data.cifar import CIFAR10
from vitx_torch.data.device_cache import DeviceBatchLoader
from vitx_torch.data.folder import FolderDataset
from vitx_torch.data.loader import BatchLoader
from vitx_torch.data.pipeline import make_preprocess
from vitx_torch.data.procedural import ProceduralShapes
from vitx_torch.data.shards import ShardDataset, write_shards
from vitx_torch.data.synthetic import (SyntheticDataset,
                                        SyntheticMultiLabelDataset)

__all__ = ["BatchLoader", "CIFAR10", "DeviceBatchLoader", "FolderDataset",
           "ProceduralShapes", "ShardDataset", "SyntheticDataset",
           "SyntheticMultiLabelDataset",
           "make_preprocess", "write_shards"]
