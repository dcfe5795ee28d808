"""Networks of the metrics (counterpart of ``metrics_tpu.models``): the FID InceptionV3."""
