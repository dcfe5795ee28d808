from metrics_tpu_torch.core.metric import Metric

__all__ = ["Metric"]
