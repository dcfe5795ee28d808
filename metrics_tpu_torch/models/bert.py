"""BERT/RoBERTa encoder for BERTScore and InfoLM as an ``nn.Module`` (counterpart of
``metrics_tpu/models/bert.py``).

Token, position and type embeddings, then post-LayerNorm self-attention blocks with
exact ``gelu``, in float32 with TF32 off; an optional masked-LM head (``dense ->
gelu -> LayerNorm -> decoder``). The weights come from a HF ``BertModel``/
``RobertaModel`` (or ``*ForMaskedLM``) state dict in a local ``.npz``/``.pth`` file,
with the JAX package's key handling: the ``bert.``/``roberta.``/``model.`` prefixes,
the BERT (``cls.predictions.*``) and RoBERTa (``lm_head.*``) head layouts, and a
decoder tied to the word embeddings when the file leaves it out. Nothing is
downloaded.

Tokenization stays on the host with the caller's tokenizer, called as the JAX
builders call it (``return_tensors="np"``); the forward runs on ``device`` (``cuda``
unless the caller names another).
"""
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from metrics_tpu_torch.models._io import load_checkpoint_state
from metrics_tpu_torch.models._transformer import (
    NEG_BIAS,
    infer_num_heads,
    layer_norm,
    linear,
    multi_head_attention,
    pad_token_batch,
)
from metrics_tpu_torch.utils.compute import fp32_exact
from metrics_tpu_torch.utils.data import _resolve_device

# the port's layer names -> the HF names under ``encoder.layer.{i}.``
_LAYER_KEYS = {
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "ffn_in": "intermediate.dense",
    "ffn_out": "output.dense",
    "ffn_ln": "output.LayerNorm",
}
_EMBEDDING_KEYS = {
    "word_emb.weight": "embeddings.word_embeddings.weight",
    "pos_emb.weight": "embeddings.position_embeddings.weight",
    "type_emb.weight": "embeddings.token_type_embeddings.weight",
    "emb_ln.weight": "embeddings.LayerNorm.weight",
    "emb_ln.bias": "embeddings.LayerNorm.bias",
}


class _BertLayer(nn.Module):
    def __init__(self, width: int, ffn: int) -> None:
        super().__init__()
        self.q, self.k, self.v = nn.Linear(width, width), nn.Linear(width, width), nn.Linear(width, width)
        self.attn_out = nn.Linear(width, width)
        self.attn_ln = nn.LayerNorm(width)
        self.ffn_in = nn.Linear(width, ffn)
        self.ffn_out = nn.Linear(ffn, width)
        self.ffn_ln = nn.LayerNorm(width)

    def forward(self, x: Tensor, mask_bias: Tensor, num_heads: int, eps: float) -> Tensor:
        attn = multi_head_attention(x, self.q, self.k, self.v, self.attn_out, mask_bias, num_heads)
        x = layer_norm(x + attn, self.attn_ln.weight, self.attn_ln.bias, eps)
        ffn = linear(F.gelu(linear(x, self.ffn_in)), self.ffn_out)
        return layer_norm(x + ffn, self.ffn_ln.weight, self.ffn_ln.bias, eps)


class _MLMHead(nn.Module):
    def __init__(self, width: int, vocab_size: int) -> None:
        super().__init__()
        self.dense = nn.Linear(width, width)
        self.ln = nn.LayerNorm(width)
        self.decoder = nn.Linear(width, vocab_size)


class BertEncoder(nn.Module):
    """A BERT-family encoder, with a masked-LM head when ``mlm_head``.

    Args:
        vocab_size, width, num_layers, ffn, max_positions, type_vocab_size: the shape.
        num_heads: attention heads; 64-wide heads when None.
        eps: LayerNorm epsilon (1e-12 for BERT, 1e-5 for RoBERTa).
        mlm_head: build the masked-LM head.
        device: where the weights live; ``cuda`` by default.
    """

    def __init__(
        self,
        vocab_size: int,
        width: int,
        num_layers: int,
        ffn: int,
        max_positions: int,
        type_vocab_size: int = 2,
        num_heads: Optional[int] = None,
        eps: float = 1e-12,
        mlm_head: bool = False,
        device=None,
    ) -> None:
        super().__init__()
        device = _resolve_device(device)
        self.num_heads = num_heads or infer_num_heads(width)
        self.eps = eps
        with torch.device(device):
            self.word_emb = nn.Embedding(vocab_size, width)
            self.pos_emb = nn.Embedding(max_positions, width)
            self.type_emb = nn.Embedding(type_vocab_size, width)
            self.emb_ln = nn.LayerNorm(width)
            self.layers = nn.ModuleList(_BertLayer(width, ffn) for _ in range(num_layers))
            self.mlm_head = _MLMHead(width, vocab_size) if mlm_head else None
        self.requires_grad_(False)
        self.eval()

    @classmethod
    def from_state(
        cls, state: Dict[str, Any], num_heads: Optional[int] = None, eps: float = 1e-12, device=None
    ) -> "BertEncoder":
        """The encoder whose weights are ``state``, the port's state dict
        (:func:`params_from_state_dict`, :func:`mlm_params_from_state_dict` or
        :func:`metrics_tpu_torch.convert.bert_state_from_jax`); the shape is read from it."""
        state = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, Tensor) else v, dtype=torch.float32)
                 for k, v in state.items()}
        vocab_size, width = state["word_emb.weight"].shape
        num_layers = sum(1 for k in state if k.startswith("layers.") and k.endswith(".q.weight"))
        model = cls(
            vocab_size, width, num_layers, state["layers.0.ffn_in.weight"].shape[0],
            state["pos_emb.weight"].shape[0], state["type_emb.weight"].shape[0], num_heads, eps,
            mlm_head="mlm_head.dense.weight" in state, device="meta",
        )
        model.load_state_dict(state, assign=True)
        return model.to(_resolve_device(device)).requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.word_emb.weight.device

    @torch.no_grad()
    def forward(self, input_ids: Tensor, attention_mask: Tensor, position_ids: Tensor) -> Tensor:
        """The last hidden state, (B, S, width)."""
        with fp32_exact():
            x = self.word_emb.weight[input_ids] + self.pos_emb.weight[position_ids] + self.type_emb.weight[0]
            x = layer_norm(x, self.emb_ln.weight, self.emb_ln.bias, self.eps)
            # additive key-side padding mask, broadcast over heads and query positions
            mask_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, NEG_BIAS).to(x.dtype)
            for layer in self.layers:
                x = layer(x, mask_bias, self.num_heads, self.eps)
            return x

    @torch.no_grad()
    def mlm_logits(self, input_ids: Tensor, attention_mask: Tensor, position_ids: Tensor) -> Tensor:
        """(B, S, vocab) masked-LM logits: the InfoLM ``logits_fn`` surface."""
        if self.mlm_head is None:
            raise ValueError("This encoder was built without a masked-LM head")
        hidden = self.forward(input_ids, attention_mask, position_ids)
        head = self.mlm_head
        with fp32_exact():
            x = F.gelu(linear(hidden, head.dense))
            x = layer_norm(x, head.ln.weight, head.ln.bias, self.eps)
            return linear(x, head.decoder)


def params_from_state_dict(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF BertModel/RobertaModel state dict -> the port's state dict of :class:`BertEncoder`.

    Accepts bare keys (``embeddings.word_embeddings.weight``) or keys prefixed with
    ``bert.``/``roberta.``/``model.`` (full checkpoint files).
    """
    for prefix in ("bert.", "roberta.", "model."):
        if any(k.startswith(prefix + "embeddings.") for k in state):
            state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            break
    out = {name: np.asarray(state[key]) for name, key in _EMBEDDING_KEYS.items()}
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in state:
        for name, key in _LAYER_KEYS.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{name}.{leaf}"] = np.asarray(state[f"encoder.layer.{i}.{key}.{leaf}"])
        i += 1
    if i == 0:
        raise ValueError("state_dict contains no `encoder.layer.*` keys — not a BERT-family checkpoint")
    return out


def mlm_params_from_state_dict(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF ``BertForMaskedLM``/``RobertaForMaskedLM`` state dict -> the port's state dict
    with the masked-LM head, from either key layout: ``cls.predictions.*`` (BERT) or
    ``lm_head.*`` (RoBERTa). A decoder left out of the file (``save_pretrained`` strips
    tied weights) is the word-embedding matrix, a missing decoder bias zero."""
    out = params_from_state_dict(state)
    if "cls.predictions.transform.dense.weight" in state:  # BERT layout
        dense, ln, decoder = "cls.predictions.transform.dense", "cls.predictions.transform.LayerNorm", \
            "cls.predictions.decoder"
        bias_keys = ("cls.predictions.decoder.bias", "cls.predictions.bias")
    elif "lm_head.dense.weight" in state:  # RoBERTa layout
        dense, ln, decoder = "lm_head.dense", "lm_head.layer_norm", "lm_head.decoder"
        bias_keys = ("lm_head.decoder.bias", "lm_head.bias")
    else:
        raise ValueError("state_dict has neither `cls.predictions.*` nor `lm_head.*` keys — not a masked-LM checkpoint")
    for name, key in (("dense", dense), ("ln", ln)):
        out[f"mlm_head.{name}.weight"] = np.asarray(state[f"{key}.weight"])
        out[f"mlm_head.{name}.bias"] = np.asarray(state[f"{key}.bias"])
    weight = np.asarray(state[f"{decoder}.weight"]) if f"{decoder}.weight" in state else out["word_emb.weight"]
    bias = next((np.asarray(state[k]) for k in bias_keys if k in state), np.zeros(weight.shape[0], weight.dtype))
    out["mlm_head.decoder.weight"], out["mlm_head.decoder.bias"] = weight, bias
    return out


def bert_position_ids(attention_mask: np.ndarray, variant: str, padding_idx: int = 1) -> np.ndarray:
    """Position ids: sequential for BERT; RoBERTa offsets past its padding index and
    freezes pad positions at ``padding_idx`` (HF create_position_ids_from_input_ids)."""
    if variant == "roberta":
        mask = attention_mask.astype(np.int64)
        return np.cumsum(mask, axis=1) * mask + padding_idx
    return np.broadcast_to(np.arange(attention_mask.shape[1]), attention_mask.shape)


def _default_eps(variant: str, layer_norm_eps: Optional[float]) -> float:
    return layer_norm_eps if layer_norm_eps is not None else (1e-5 if variant == "roberta" else 1e-12)


def _max_positions(model: BertEncoder, variant: str) -> int:
    # RoBERTa position ids run cumsum(mask) + padding_idx, so a full row of length S
    # indexes up to S + padding_idx: bound S by the table minus that offset
    table = int(model.pos_emb.weight.shape[0])
    return table - 2 if variant == "roberta" else table


def _as_device_tensors(model: BertEncoder, ids: np.ndarray, mask: np.ndarray, variant: str):
    pos = bert_position_ids(mask, variant)
    return tuple(torch.tensor(a, dtype=torch.int64, device=model.device) for a in (ids, mask, pos))


def bert_encoder_from_model(model: BertEncoder, tokenizer, variant: str = "bert", max_length: int = 512):
    """A BERTScore ``TextEncoder`` over ``model``: ``sentences -> (hidden states on the
    model's device, input_ids, attention_mask)``, the ids and mask as numpy, the
    sequence axis padded to the JAX package's power-of-two buckets."""
    pad_id = getattr(tokenizer, "pad_token_id", None) or 0
    max_seq = min(max_length, _max_positions(model, variant))

    def encoder(sentences: Sequence[str]) -> Tuple[Tensor, np.ndarray, np.ndarray]:
        batch = tokenizer(list(sentences), padding=True, truncation=True, max_length=max_seq, return_tensors="np")
        ids = np.asarray(batch["input_ids"])
        mask = np.asarray(batch["attention_mask"])
        if ids.shape[1] > max_seq:
            raise ValueError(f"tokenizer produced length {ids.shape[1]} > usable position range {max_seq}")
        ids_p, mask_p = pad_token_batch(ids, mask, pad_id, cap=max_seq)
        return model(*_as_device_tensors(model, ids_p, mask_p, variant)), ids_p, mask_p

    return encoder


def mlm_logits_fn_from_model(model: BertEncoder, variant: str = "bert"):
    """An InfoLM ``logits_fn`` over ``model``: ``(input_ids, attention_mask) -> logits``
    on the model's device."""
    max_seq = _max_positions(model, variant)

    def logits_fn(input_ids: np.ndarray, attention_mask: np.ndarray) -> Tensor:
        ids = np.asarray(input_ids)
        mask = np.asarray(attention_mask)
        if ids.shape[1] > max_seq:
            raise ValueError(
                f"sequence length {ids.shape[1]} exceeds the checkpoint's usable position"
                f" range ({max_seq}); truncate in the tokenizer"
            )
        ids_p, mask_p = pad_token_batch(ids, mask, 0, cap=max_seq)
        return model.mlm_logits(*_as_device_tensors(model, ids_p, mask_p, variant))[:, : ids.shape[1], :]

    return logits_fn


def torch_bert_encoder(
    weights_path: str,
    tokenizer,
    variant: str = "bert",
    num_heads: Optional[int] = None,
    max_length: int = 512,
    layer_norm_eps: Optional[float] = None,
    device=None,
):
    """A BERTScore ``TextEncoder`` running the encoder in PyTorch on ``device``
    (counterpart of ``jax_bert_encoder``).

    Args:
        weights_path: HF state-dict checkpoint (``.bin``/``.pth``/``.npz``).
        tokenizer: a HF tokenizer instance (host side).
        variant: ``"bert"`` or ``"roberta"`` (position-id scheme and LN eps).
        num_heads: attention heads; inferred from the width when None.
        max_length: tokenizer truncation length.
        layer_norm_eps: override (default 1e-12 bert / 1e-5 roberta).
        device: where the encoder runs; ``cuda`` by default.
    """
    state = params_from_state_dict(load_checkpoint_state(weights_path))
    model = BertEncoder.from_state(state, num_heads, _default_eps(variant, layer_norm_eps), device)
    return bert_encoder_from_model(model, tokenizer, variant, max_length)


def torch_mlm_logits_fn(
    weights_path: str,
    variant: str = "bert",
    num_heads: Optional[int] = None,
    layer_norm_eps: Optional[float] = None,
    device=None,
):
    """An InfoLM ``logits_fn`` running the masked-LM forward in PyTorch on ``device``
    (counterpart of ``jax_mlm_logits_fn``)."""
    state = mlm_params_from_state_dict(load_checkpoint_state(weights_path))
    model = BertEncoder.from_state(state, num_heads, _default_eps(variant, layer_norm_eps), device)
    return mlm_logits_fn_from_model(model, variant)
