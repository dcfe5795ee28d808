"""Tweedie deviance (counterpart of ``metrics_tpu/functional/regression/tweedie_deviance.py``).

The domain check (``tweedie_deviance.py:16-31``) reaches the JAX package's verdict, and
raises its error, from one device reduction (three flags stacked) and one host read.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _as_float, _check_same_shape, _is_concrete
from metrics_tpu_torch.utils.compute import _safe_xlogy
from metrics_tpu_torch.utils.data import to_tensor


def _domain_check(preds: Tensor, targets: Tensor, power: float) -> None:
    if not _is_concrete(preds, targets):
        return
    flags = torch.stack([(preds <= 0).any(), (targets < 0).any(), (targets <= 0).any()])
    p_nonpos, t_neg, t_nonpos = flags.tolist()
    if power == 1 and (p_nonpos or t_neg):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    if power == 2 and (p_nonpos or t_nonpos):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
    if power < 0 and p_nonpos:
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
    if 1 < power < 2 and (p_nonpos or t_neg):
        raise ValueError(
            f"For power={power}, 'targets' has to be strictly positive and 'preds' cannot be negative."
        )
    if power > 2 and (p_nonpos or t_nonpos):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")


def _tweedie_deviance_score_update(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, targets)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    preds, targets = _as_float(preds), _as_float(targets)

    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:
        _domain_check(preds, targets, power)
        deviance_score = 2 * (_safe_xlogy(targets, targets / preds) + preds - targets)
    elif power == 2:
        _domain_check(preds, targets, power)
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        _domain_check(preds, targets, power)
        term_1 = torch.clamp(targets, min=0.0) ** (2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * preds ** (1 - power) / (1 - power)
        term_3 = preds ** (2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    return torch.sum(deviance_score), torch.tensor(deviance_score.numel(), device=preds.device)


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds, targets, power: float = 0.0, device=None) -> Tensor:
    """Tweedie deviance score."""
    preds = to_tensor(preds, device)
    targets = to_tensor(targets, preds.device)
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)
