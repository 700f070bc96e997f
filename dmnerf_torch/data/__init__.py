# Copied from dmnerf_tpu/data/__init__.py.
from dmnerf_torch.data.base import SceneData, load_dataset

__all__ = ["SceneData", "load_dataset"]
