"""Nominal-association classes (counterpart of ``metrics_tpu/nominal``)."""
from metrics_tpu_torch.nominal.cramers import CramersV
from metrics_tpu_torch.nominal.pearson import PearsonsContingencyCoefficient
from metrics_tpu_torch.nominal.theils_u import TheilsU
from metrics_tpu_torch.nominal.tschuprows import TschuprowsT

__all__ = [
    "CramersV",
    "PearsonsContingencyCoefficient",
    "TheilsU",
    "TschuprowsT",
]
