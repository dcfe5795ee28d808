from metrics_tpu_torch.core.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric

__all__ = [
    "CatMetric", "CompositionalMetric", "MaxMetric", "MeanMetric", "Metric", "MetricCollection", "MinMetric",
    "SumMetric",
]
