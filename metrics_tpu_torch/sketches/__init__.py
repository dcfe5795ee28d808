"""Mergeable streaming sketch metrics (counterpart of ``metrics_tpu/sketches``).

Latency percentiles (:class:`QuantileSketch`), approximate distinct counts
(:class:`DistinctCount`), distribution drift (:class:`HistogramDrift`) and streaming
AUROC/AP brackets (:class:`StreamingAUROCBound`): fixed-shape integer states whose
``sum``/``max`` reduction is the sketch merge.
"""
from metrics_tpu_torch.sketches.auroc_bound import StreamingAUROCBound
from metrics_tpu_torch.sketches.base import SketchMetric
from metrics_tpu_torch.sketches.distinct import DistinctCount
from metrics_tpu_torch.sketches.drift import HistogramDrift
from metrics_tpu_torch.sketches.quantile import QuantileSketch

__all__ = [
    "DistinctCount",
    "HistogramDrift",
    "QuantileSketch",
    "SketchMetric",
    "StreamingAUROCBound",
]
