"""Host data path: manifests, adapters, decoding, record stores, synthetic
scenes, and augmentation on the host and on the device."""

from m4depth_tpu_torch.data.datasets import DatasetAdapter, get_adapter
from m4depth_tpu_torch.data.pipeline import SequenceDataset

__all__ = ["DatasetAdapter", "SequenceDataset", "get_adapter"]
