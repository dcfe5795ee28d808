"""Checkpoint reading for the model ports (counterpart of ``metrics_tpu/models/_io.py``)."""
from typing import Dict

import numpy as np


def load_checkpoint_state(path: str) -> Dict[str, np.ndarray]:
    """Load a flat name -> array state dict from an ``.npz`` or torch ``.pth`` file."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    import torch

    loaded = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(loaded, "state_dict"):
        loaded = loaded.state_dict()
    return {k: v.numpy() for k, v in loaded.items()}
