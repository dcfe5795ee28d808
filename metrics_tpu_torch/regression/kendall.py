"""KendallRankCorrCoef (counterpart of ``metrics_tpu/regression/kendall.py``)."""
from typing import Any, Optional

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.kendall import kendall_rank_corrcoef
from metrics_tpu_torch.utils.data import dim_zero_cat


class KendallRankCorrCoef(Metric):
    """Kendall rank correlation (tau-a/b/c), with the t-test's p-value if ``t_test``:
    ``cat`` states (``cat_capacity`` makes them ``CatBuffer``s of ``(num_outputs,)``
    rows), one pair-count kernel launch at ``compute``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = True

    def __init__(
        self, variant: str = "b", t_test: bool = False, alternative: Optional[str] = "two-sided",
        num_outputs: int = 1, **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if variant not in ("a", "b", "c"):
            raise ValueError(f"Argument `variant` is expected to be one of ('a', 'b', 'c'), but got {variant}")
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {t_test}")
        if t_test and alternative not in ("two-sided", "less", "greater"):
            raise ValueError(
                "Argument `alternative` is expected to be one of ('two-sided', 'less', 'greater'),"
                f" but got {alternative}"
            )
        self.variant = variant
        self.alternative = alternative if t_test else None
        self.t_test = t_test
        self.num_outputs = num_outputs
        item = () if num_outputs == 1 else (num_outputs,)
        self.add_state("preds", [], dist_reduce_fx="cat", cat_item_shape=item)
        self.add_state("target", [], dist_reduce_fx="cat", cat_item_shape=item)

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.preds.append(preds)
        self.target.append(target)

    def compute(self):
        return kendall_rank_corrcoef(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.variant, self.t_test,
            self.alternative or "two-sided",
        )
