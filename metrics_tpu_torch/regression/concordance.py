"""ConcordanceCorrCoef (counterpart of ``metrics_tpu/regression/concordance.py``)."""
from torch import Tensor

from metrics_tpu_torch.functional.regression.concordance import _concordance_corrcoef_compute
from metrics_tpu_torch.regression.pearson import PearsonCorrCoef


class ConcordanceCorrCoef(PearsonCorrCoef):
    """Concordance correlation coefficient (Pearson's states and merge)."""

    is_differentiable = True
    higher_is_better = None
    full_state_update = True

    def compute(self) -> Tensor:
        return _concordance_corrcoef_compute(*self._moments())
