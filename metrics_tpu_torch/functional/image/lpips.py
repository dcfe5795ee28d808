"""LPIPS (counterpart of ``metrics_tpu/functional/image/lpips.py``); the network and
its weight files are in :mod:`metrics_tpu_torch.models.lpips`."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.models.lpips import load_lpips
from metrics_tpu_torch.utils.data import to_tensor


def _lpips_valid_img(img: Tensor, normalize: bool) -> bool:
    """Shape and value check of the reference's ``_valid_img``."""
    value_check = bool(img.max() <= 1.0 and img.min() >= 0.0) if normalize else True
    return img.ndim == 4 and img.shape[1] == 3 and value_check


def _lpips_invalid_message(img1: Tensor, img2: Tensor, normalize: bool) -> str:
    return (
        "Expected both input arguments to be normalized tensors with shape [N, 3, H, W]."
        f" Got input with shape {tuple(img1.shape)} and {tuple(img2.shape)} and values in range"
        f" {[img1.min(), img1.max()]} and {[img2.min(), img2.max()]} when all values are"
        f" expected to be in the {[0, 1] if normalize else [-1, 1]} range."
    )


def learned_perceptual_image_patch_similarity(
    img1,
    img2,
    net_type: str = "alex",
    reduction: str = "mean",
    normalize: bool = False,
    backbone_weights: Optional[str] = None,
    linear_weights: Optional[str] = None,
    device=None,
) -> Tensor:
    """LPIPS perceptual distance between two NCHW RGB batches (lower = more similar).

    Args:
        img1 / img2: image batches, in [-1, 1] (or [0, 1] with ``normalize=True``);
            arrays that are not tensors go to ``device``.
        net_type: ``"vgg"`` | ``"alex"`` | ``"squeeze"`` backbone.
        reduction: ``"mean"`` or ``"sum"`` over the batch.
        normalize: inputs are in [0, 1].
        backbone_weights / linear_weights: local weight files (see models.lpips).
        device: where non-tensor inputs go; ``cuda`` by default. The network runs on
            the inputs' device.
    """
    img1 = to_tensor(img1, device)
    img2 = to_tensor(img2, img1.device)
    if not (_lpips_valid_img(img1, normalize) and _lpips_valid_img(img2, normalize)):
        raise ValueError(_lpips_invalid_message(img1, img2, normalize))
    network = load_lpips(net_type, backbone_weights, linear_weights, img1.device)
    loss = network(img1, img2, normalize)
    return loss.mean() if reduction == "mean" else loss.sum()
