"""Datasets of the port (numpy only, as in ``vitx.data``)."""

from vitx_torch.data.synthetic import SyntheticDataset

__all__ = ["SyntheticDataset"]
