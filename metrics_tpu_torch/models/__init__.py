"""Networks of the metrics (counterpart of ``metrics_tpu.models``): the FID InceptionV3,
the BERT/RoBERTa encoder of BERTScore and InfoLM, CLIP, and the LPIPS backbones."""
