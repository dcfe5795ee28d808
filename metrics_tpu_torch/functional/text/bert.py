"""BERTScore (counterpart of ``metrics_tpu/functional/text/bert.py``).

The encoder is a callable

    ``encoder(sentences: Sequence[str]) -> (embeddings [B, S, D], input_ids [B, S],
    attention_mask [B, S])``

giving HF-style sequences (``[CLS] ... [SEP]``: position 0 and the last attended
position are left out of the scoring, as in the reference). The embeddings are a
tensor (their device is where the scoring runs; any other array goes to ``device``),
the ids and mask numpy arrays. :func:`metrics_tpu_torch.models.bert.torch_bert_encoder`
builds one from a local checkpoint; with ``model_name_or_path`` and ``transformers``
installed, a default encoder runs the HF model on ``device``.

The special-token mask and the idf weights stay in host numpy, as in the JAX package
(the SEP position is an ``argmax`` over a float cumsum; a device rewrite could break a
tie differently). The L2 normalisation and the greedy cosine matching run on the
embeddings' device.
"""
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.functional.text.helper import _input_ids_idf, _tokens_idf
from metrics_tpu_torch.utils.compute import fp32_exact
from metrics_tpu_torch.utils.data import _resolve_device, to_tensor
from metrics_tpu_torch.utils.imports import _TRANSFORMERS_AVAILABLE

_DEFAULT_MODEL = "roberta-large"

TextEncoder = Callable[[Sequence[str]], Tuple[Tensor, np.ndarray, np.ndarray]]


def _process_attention_mask_for_special_tokens(attention_mask: np.ndarray) -> np.ndarray:
    """Zero out [CLS] (position 0) and [SEP] (last attended position) per row."""
    mask = attention_mask.astype(np.float32).copy()
    mask[:, 0] = 0
    sep_positions = np.argmax(np.cumsum(mask - 0.1, axis=-1), axis=-1)
    mask[np.arange(mask.shape[0]), sep_positions] = 0
    return mask


def _idf_scale(input_ids: np.ndarray, mask: np.ndarray, idf_map: Optional[Dict[int, float]]) -> np.ndarray:
    """Per-token weights normalised within each sentence (uniform when no idf)."""
    if idf_map is None:
        weights = mask.astype(np.float32)
    else:
        weights = _input_ids_idf(input_ids, idf_map) * mask
    return weights / np.maximum(weights.sum(-1, keepdims=True), 1e-30)


def _bert_score_from_embeddings(
    preds_emb: Tensor, preds_scale: Tensor, target_emb: Tensor, target_scale: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy token matching: (precision, recall, f1) per sample.

    Embeddings must be L2-normalised with masked-out positions zeroed; scales must be
    normalised per sentence. A NaN f1 (p + r == 0) maps to 0.
    """
    with fp32_exact():
        cos_sim = torch.einsum("bpd,brd->bpr", preds_emb, target_emb)
    precision = torch.sum(cos_sim.max(dim=2).values * preds_scale, dim=-1)
    recall = torch.sum(cos_sim.max(dim=1).values * target_scale, dim=-1)
    denom = precision + recall
    positive = denom > 0
    f1 = torch.where(positive, 2 * precision * recall / torch.where(positive, denom, 1.0), 0.0)
    return precision, recall, f1


def _prepare_embeddings(
    encoder_output: Tuple[Tensor, np.ndarray, np.ndarray], idf_map: Optional[Dict[int, float]], device=None
) -> Tuple[Tensor, Tensor]:
    """L2-normalise, zero the special-token positions, build the per-token scales."""
    embeddings, input_ids, attention_mask = encoder_output
    mask = _process_attention_mask_for_special_tokens(np.asarray(attention_mask))
    emb = to_tensor(embeddings, device).to(torch.float32)
    emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-30)
    emb = emb * torch.as_tensor(mask, device=emb.device)[..., None]
    scale = torch.as_tensor(_idf_scale(np.asarray(input_ids), mask, idf_map), device=emb.device)
    return emb, scale


def _default_transformers_encoder(model_name_or_path: str, max_length: int = 512, device=None) -> TextEncoder:
    """HF-transformers encoder (last hidden state) on ``device``; needs cached weights."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`bert_score` with `model_name_or_path` requires `transformers`. Either install it or pass an `encoder`."
        )
    device = _resolve_device(device)
    from transformers import AutoModel, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
    model = AutoModel.from_pretrained(model_name_or_path)
    model.eval()
    model.to(device)

    def encoder(sentences: Sequence[str]) -> Tuple[Tensor, np.ndarray, np.ndarray]:
        batch = tokenizer(list(sentences), padding=True, truncation=True, max_length=max_length, return_tensors="pt")
        with torch.no_grad(), fp32_exact():
            out = model(batch["input_ids"].to(device), batch["attention_mask"].to(device)).last_hidden_state
        return out, batch["input_ids"].numpy(), batch["attention_mask"].numpy()

    return encoder


def bert_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    encoder: Optional[TextEncoder] = None,
    model_name_or_path: Optional[str] = None,
    idf: bool = False,
    max_length: int = 512,
    rescale_with_baseline: bool = False,
    baseline: Optional[Sequence[float]] = None,
    return_hash: bool = False,
    device=None,
) -> Dict[str, Union[Tensor, str]]:
    """BERTScore: token-level greedy cosine matching of contextual embeddings.

    Args:
        preds: predicted sentence(s).
        target: reference sentence(s).
        encoder: callable mapping sentences to ``(embeddings, input_ids,
            attention_mask)``; see the module docstring for the contract.
        model_name_or_path: build a default ``transformers`` encoder (needs locally
            cached weights; ``roberta-large`` when neither ``encoder`` nor a name is given).
        idf: weight tokens by inverse document frequency computed on ``target``.
        max_length: tokenizer truncation length of the default encoder.
        rescale_with_baseline: linearly rescale the scores with ``baseline``.
        baseline: three floats (precision/recall/f1 baselines); required to rescale.
        return_hash: include a config hash in the output dict.
        device: where the default encoder runs, and where embeddings that are not
            tensors go; ``cuda`` by default.

    Returns:
        Dict with per-sentence ``precision``, ``recall``, ``f1`` tensors.
    """
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [target] if isinstance(target, str) else list(target)
    if len(preds_l) != len(target_l):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, got {len(preds_l)} and {len(target_l)}"
        )
    if encoder is None:
        encoder = _default_transformers_encoder(model_name_or_path or _DEFAULT_MODEL, max_length, device)

    # target embeddings first: idf statistics are computed on references
    target_output = encoder(target_l)
    idf_map = _tokens_idf(np.asarray(target_output[1])) if idf else None
    t_emb, t_scale = _prepare_embeddings(target_output, idf_map, device)
    p_emb, p_scale = _prepare_embeddings(encoder(preds_l), idf_map, t_emb.device)

    precision, recall, f1 = _bert_score_from_embeddings(p_emb, p_scale, t_emb, t_scale)

    if rescale_with_baseline:
        if baseline is None:
            raise ValueError("`rescale_with_baseline` requires the `baseline` argument (no network access).")
        b = torch.as_tensor(baseline, dtype=torch.float32, device=precision.device)
        precision = (precision - b[0]) / (1 - b[0])
        recall = (recall - b[1]) / (1 - b[1])
        f1 = (f1 - b[2]) / (1 - b[2])

    output: Dict[str, Union[Tensor, str]] = {"precision": precision, "recall": recall, "f1": f1}
    if return_hash:
        output["hash"] = f"{model_name_or_path}{'_idf' if idf else '_no-idf'}"
    return output
