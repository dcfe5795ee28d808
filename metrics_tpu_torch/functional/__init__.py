"""Functional entry points of metrics_tpu_torch: every classification, regression and
nominal functional, the pairwise functions, PSNRB, LPIPS, CLIPScore, the four box-IoU
functionals, PESQ and STOI, and the retrieval, the other image, the two panoptic, the
other six audio and the text functionals (``bert_score`` and ``infolm`` among them)
through root shims that warn (as in ``metrics_tpu.functional``);
``metrics_tpu_torch.functional.retrieval``, ``.image``, ``.detection``, ``.audio`` and
``.text`` give them silently.
"""
from metrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from metrics_tpu_torch.functional.classification import __all__ as _classification_all
from metrics_tpu_torch.functional.audio import (
    perceptual_evaluation_speech_quality,
    short_time_objective_intelligibility,
)
from metrics_tpu_torch.functional.audio._deprecated import (
    _permutation_invariant_training as permutation_invariant_training,
    _pit_permutate as pit_permutate,
    _scale_invariant_signal_distortion_ratio as scale_invariant_signal_distortion_ratio,
    _scale_invariant_signal_noise_ratio as scale_invariant_signal_noise_ratio,
    _signal_distortion_ratio as signal_distortion_ratio,
    _signal_noise_ratio as signal_noise_ratio,
)
from metrics_tpu_torch.functional.detection import (
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
)
from metrics_tpu_torch.functional.detection._deprecated import (
    _modified_panoptic_quality as modified_panoptic_quality,
    _panoptic_quality as panoptic_quality,
)
from metrics_tpu_torch.functional.image import (
    learned_perceptual_image_patch_similarity,
    peak_signal_noise_ratio_with_blocked_effect,
)
from metrics_tpu_torch.functional.multimodal import clip_score
from metrics_tpu_torch.functional.image._deprecated import (
    _error_relative_global_dimensionless_synthesis as error_relative_global_dimensionless_synthesis,
    _image_gradients as image_gradients,
    _multiscale_structural_similarity_index_measure as multiscale_structural_similarity_index_measure,
    _peak_signal_noise_ratio as peak_signal_noise_ratio,
    _relative_average_spectral_error as relative_average_spectral_error,
    _root_mean_squared_error_using_sliding_window as root_mean_squared_error_using_sliding_window,
    _spectral_angle_mapper as spectral_angle_mapper,
    _spectral_distortion_index as spectral_distortion_index,
    _structural_similarity_index_measure as structural_similarity_index_measure,
    _total_variation as total_variation,
    _universal_image_quality_index as universal_image_quality_index,
)
from metrics_tpu_torch.functional.nominal import (
    cramers_v,
    cramers_v_matrix,
    pearsons_contingency_coefficient,
    pearsons_contingency_coefficient_matrix,
    theils_u,
    theils_u_matrix,
    tschuprows_t,
    tschuprows_t_matrix,
)
from metrics_tpu_torch.functional.pairwise import (
    pairwise_cosine_similarity,
    pairwise_euclidean_distance,
    pairwise_linear_similarity,
    pairwise_manhattan_distance,
    pairwise_minkowski_distance,
)
from metrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from metrics_tpu_torch.functional.regression import __all__ as _regression_all
from metrics_tpu_torch.functional.text._deprecated import (
    _bert_score as bert_score,
    _bleu_score as bleu_score,
    _char_error_rate as char_error_rate,
    _chrf_score as chrf_score,
    _extended_edit_distance as extended_edit_distance,
    _infolm as infolm,
    _match_error_rate as match_error_rate,
    _perplexity as perplexity,
    _rouge_score as rouge_score,
    _sacre_bleu_score as sacre_bleu_score,
    _squad as squad,
    _translation_edit_rate as translation_edit_rate,
    _word_error_rate as word_error_rate,
    _word_information_lost as word_information_lost,
    _word_information_preserved as word_information_preserved,
)
from metrics_tpu_torch.functional.retrieval._deprecated import (
    _retrieval_average_precision as retrieval_average_precision,
    _retrieval_fall_out as retrieval_fall_out,
    _retrieval_hit_rate as retrieval_hit_rate,
    _retrieval_normalized_dcg as retrieval_normalized_dcg,
    _retrieval_precision as retrieval_precision,
    _retrieval_precision_recall_curve as retrieval_precision_recall_curve,
    _retrieval_r_precision as retrieval_r_precision,
    _retrieval_recall as retrieval_recall,
    _retrieval_reciprocal_rank as retrieval_reciprocal_rank,
)

__all__ = _classification_all + _regression_all + [
    "perceptual_evaluation_speech_quality",
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "short_time_objective_intelligibility",
    "signal_distortion_ratio",
    "signal_noise_ratio",
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
    "pairwise_minkowski_distance",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
    "cramers_v",
    "cramers_v_matrix",
    "pearsons_contingency_coefficient",
    "pearsons_contingency_coefficient_matrix",
    "theils_u",
    "theils_u_matrix",
    "tschuprows_t",
    "tschuprows_t_matrix",
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "extended_edit_distance",
    "match_error_rate",
    "perplexity",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
    "bert_score",
    "clip_score",
    "infolm",
    "learned_perceptual_image_patch_similarity",
]
