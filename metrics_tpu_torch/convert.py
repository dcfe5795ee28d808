"""Carry a ``metrics_tpu`` metric's state into the port: the port's counterpart of
carrying weights across.

The JAX package's ``Metric.state_dict()`` gives numpy arrays (only for persistent
states, so call ``persistent(True)`` on it first). Without ``jax_enable_x64`` its
count states are float32; the port's are int64. :func:`load_jax_state` converts
each state to the port's dtype and device, and refuses float counts that are not
whole numbers rather than rounding them. A ``CatBuffer`` state comes as the JAX
package's ``{"data", "count", "overflow"}`` dict and stays a ``CatBuffer``.

A ``BootStrapper`` takes the JAX package's stacked state (``boot_<name>``, ``(N,
*state)``): a base that the port stacks too loads it into its own ``boot_<name>``
states, and on the copies path row ``k`` loads into copy ``k``. A JAX pure-tier
BootStrapper state (``{"key", "metrics"}``) is refused: its ``jax.random`` key has no
use in the port. The nominal classes' float32 ``confmat`` becomes int64 like any
count.

A ``MetricCollection`` takes a ``metrics_tpu`` collection's ``state_dict()``, whose
keys are ``"<name>.<state>"``, or the nested ``{name: {state: value}}`` dict of its
pure tier (``init_state``/``local_update``), whose ``CatBuffer`` leaves are the JAX
package's own buffer objects: each compute group's state is loaded once, into its
leader, and shared with the members again.

A fleet metric (``fleet_size=N``) takes a JAX fleet's ``(N, *base)`` states and its
``_fleet_rows`` like any other state.

The sketch states load bit for bit in the JAX package's dtypes: the int32 histograms
of the sketches and of the ``tolerance > 0`` AUROC/AP classes (``pos_hist``,
``neg_hist``, ``pos_buckets``, ``neg_buckets``, ``edge_counts``, ``nan_count``,
``ref_hist``, ``live_hist``) and ``DistinctCount``'s uint8 ``registers``.

The text classes load the same way: their whole-number float32 counts (WER's
``errors``/``total``, BLEU's ``numerator``/``denominator`` and lengths, chrF's six
n-gram vectors, TER's ``total_num_edits``, SQuAD's ``exact_match``/``total``,
Perplexity's ``count``) become int64 and are refused when not whole; their float sums
(SQuAD's ``f1_score``, TER's ``total_tgt_len``, Perplexity's ``total_log_probs``) stay
float32; their list states (EED's sentence scores, ROUGE's per-sample scores, the
chrF and TER sentence scores) load as lists of float32 tensors, scalars or vectors.

A state with ``dist_reduce_fx=None`` may come stacked, as a sync leaves it (a leading
process axis, e.g. FID's ``(k, D)`` means, or Pearson's six ``(k, num_outputs)``
moments, which ``compute`` merges); FID's lazily sized moments are sized from
the incoming ones, and the sliding-window maps of RASE and RMSE-SW take the shape they
come with.

:func:`inception_state_from_jax` carries weights across: the JAX InceptionV3's
parameter pytree becomes the state dict of
:class:`~metrics_tpu_torch.models.inception.FeatureExtractorInceptionV3`;
:func:`bert_state_from_jax`, :func:`clip_state_from_jax` and
:func:`lpips_state_from_jax` do the same for ``BertEncoder``, ``CLIPModel`` and
``LPIPS`` (the JAX linears are ``x @ W`` with ``W`` transposed at load, the port's
``nn.Linear`` keeps ``(out, in)``). The model metrics' states load as the others:
``CLIPScore``'s int32 ``n_samples`` and LPIPS's float32 ``total`` become int64,
BERTScore's and InfoLM's corpora stay lists of strings.
"""
from typing import Any, Dict, Union

import numpy as np
import torch

from metrics_tpu_torch.core.collections import MetricCollection
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.state import CatBuffer


def _as_state_tensor(name: str, value: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    array = np.asarray(value)
    if not dtype.is_floating_point and np.issubdtype(array.dtype, np.floating):
        if not np.all(np.isfinite(array)) or not np.array_equal(array, np.round(array)):
            raise ValueError(f"load_jax_state: state `{name}` holds non-integral values for an integer state")
        array = np.round(array).astype(np.int64)
    return torch.tensor(array).to(device=device, dtype=dtype)


def load_jax_state(metric: Union[Metric, MetricCollection], state: Dict[str, Any]) -> Union[Metric, MetricCollection]:
    """Load ``state`` (a ``metrics_tpu`` ``state_dict()``: name -> numpy array or list
    of arrays) into ``metric``, replacing its states, and return ``metric``.

    For a collection, ``state`` is the collection's ``state_dict()`` and every
    metric's part of it (``"<name>."`` keys) loads as below: a group's leader's
    part once, shared by the members, the others each their own.

    Every state of ``metric`` must be present with the same shape. Tensor states take
    the port's dtype (float32 counts become int64); list (``cat``) states take the
    items as they are, integers widened to int64. A ``CatBuffer`` entry (a dict of
    ``data``, ``count`` and ``overflow``) becomes a ``CatBuffer`` of the same fields,
    its data in the dtype the metric declared for the state.
    """
    if isinstance(metric, MetricCollection):
        return _load_collection(metric, state)
    children = metric._jax_child_states(state) if hasattr(metric, "_jax_child_states") else None
    if children is not None:  # a wrapper whose copies the JAX package stacks
        for child, child_state in children:
            load_jax_state(child, child_state)
        metric._computed = None
        return metric
    if hasattr(metric, "_init_states_for_load"):
        metric._init_states_for_load(state)
    missing = sorted(set(metric._defaults) - set(state))
    if missing:
        raise KeyError(f"load_jax_state: state dict lacks {missing} (call persistent(True) before state_dict())")
    for name, default in metric._defaults.items():
        value = _as_plain(state[name])
        if isinstance(value, dict):
            if not {"data", "count"} <= set(value):
                raise ValueError(f"load_jax_state: state `{name}` is a dict without `data` and `count`")
            # a list state loads as a buffer too, in its declared row dtype
            dtype = default.data.dtype if isinstance(default, CatBuffer) else metric._cat_meta.get(name, ((), None))[1]
            data = np.asarray(value["data"])
            data = torch.tensor(data, device=metric.device) if dtype is None else _as_state_tensor(
                name, data, dtype, metric.device
            )
            setattr(metric, name, CatBuffer(data, np.asarray(value["count"]), np.asarray(value.get("overflow", False))))
        elif isinstance(default, list):
            items = []
            for item in value:
                item = np.asarray(item)
                if item.dtype.kind == "U":  # a host-side corpus (BERTScore, InfoLM)
                    items.append(str(item))
                    continue
                dtype = torch.int64 if np.issubdtype(item.dtype, np.integer) else torch.from_numpy(item).dtype
                items.append(_as_state_tensor(name, item, dtype, metric.device))
            setattr(metric, name, items)
        else:
            tensor = _as_state_tensor(name, value, default.dtype, metric.device)
            stacked = metric._reductions[name] is None and tensor.shape[1:] == default.shape
            if tensor.shape != default.shape and not stacked and not getattr(metric, "_lazy_state_shapes", False):
                raise ValueError(
                    f"load_jax_state: state `{name}` has shape {tuple(tensor.shape)}, expected {tuple(default.shape)}"
                )
            setattr(metric, name, tensor)
    metric._computed = None
    return metric


_BN_NAMES = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def inception_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of ``FeatureExtractorInceptionV3`` from the JAX package's InceptionV3
    parameter pytree (``random_inception_params`` or ``params_from_state_dict``), whose
    leaves are arrays: ``{block: {"kernel", "bn_*"}}`` for the stem convs,
    ``{block: {branch: {...}}}`` for the mixed blocks and ``{"fc": {"weight", "bias"}}``."""
    state: Dict[str, torch.Tensor] = {}

    def conv_bn(prefix: str, leaves: Dict[str, Any]) -> None:
        state[f"{prefix}.conv.weight"] = torch.tensor(np.asarray(leaves["kernel"]))
        for key, name in _BN_NAMES.items():
            state[f"{prefix}.{name}"] = torch.tensor(np.asarray(leaves[key]))

    for block, leaves in params.items():
        if block == "fc":
            state["fc.weight"] = torch.tensor(np.asarray(leaves["weight"]))
            state["fc.bias"] = torch.tensor(np.asarray(leaves["bias"]))
        elif "kernel" in leaves:
            conv_bn(block, leaves)
        else:
            for branch, branch_leaves in leaves.items():
                conv_bn(f"{block}.{branch}", branch_leaves)
    return state


def _pair(state: Dict[str, torch.Tensor], name: str, pair: Any) -> None:
    """A JAX ``(W, b)`` leaf pair as ``name.weight``/``name.bias``; a 2-d ``W`` is a
    linear's ``x @ W`` and is transposed to ``nn.Linear``'s ``(out, in)``."""
    weight = np.asarray(pair[0])
    state[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(weight.T if weight.ndim == 2 else weight))
    state[f"{name}.bias"] = torch.tensor(np.asarray(pair[1]))


def _layers(state: Dict[str, torch.Tensor], prefix: str, layers: Any) -> None:
    for i, layer in enumerate(layers):
        for name, pair in layer.items():
            _pair(state, f"{prefix}layers.{i}.{name}", pair)


def bert_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of ``BertEncoder`` from the JAX package's BERT parameter pytree
    (``params_from_state_dict`` or ``mlm_params_from_state_dict``): embeddings, the
    ``emb_ln`` pair, the ``layers`` list of ``{name: (W, b)}`` and, with a head,
    ``mlm_head``."""
    state = {f"{name}.weight": torch.tensor(np.asarray(params[name])) for name in ("word_emb", "pos_emb", "type_emb")}
    _pair(state, "emb_ln", params["emb_ln"])
    _layers(state, "", params["layers"])
    for name, pair in params.get("mlm_head", {}).items():
        _pair(state, f"mlm_head.{name}", pair)
    return state


def clip_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The state dict of ``CLIPModel`` from the JAX package's CLIP parameter pytree
    (``{"text": ..., "vision": ...}``)."""
    state: Dict[str, torch.Tensor] = {}
    for tower in ("text", "vision"):
        leaves = params[tower]
        _layers(state, f"{tower}.", leaves["layers"])
        for name, value in leaves.items():
            if name == "layers":
                continue
            if isinstance(value, (tuple, list)):
                _pair(state, f"{tower}.{name}", value)
            elif name == "proj":
                state[f"{tower}.proj.weight"] = torch.tensor(np.ascontiguousarray(np.asarray(value).T))
            elif name == "cls_emb":
                state[f"{tower}.cls_emb"] = torch.tensor(np.asarray(value))
            else:
                state[f"{tower}.{name}.weight"] = torch.tensor(np.asarray(value))
    return state


_VGG_FEATURES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_ALEX_FEATURES = (0, 3, 6, 8, 10)
_FIRE_FEATURES = (3, 4, 6, 7, 9, 10, 11, 12)


def lpips_state_from_jax(backbone: Any, linear_weights: Any, net_type: str) -> Dict[str, torch.Tensor]:
    """The state dict of ``LPIPS`` from the JAX package's ``load_lpips`` pair: the
    backbone parameters (a list of ``{"weight", "bias"}`` for vgg/alex, a dict of
    ``conv1`` and ``fire1``..``fire8`` for squeeze) and the (1, C) lin heads."""
    state: Dict[str, torch.Tensor] = {}

    def conv(name: str, leaves: Dict[str, Any]) -> None:
        state[f"{name}.weight"] = torch.tensor(np.asarray(leaves["weight"]))
        state[f"{name}.bias"] = torch.tensor(np.asarray(leaves["bias"]))

    if net_type == "squeeze":
        conv("features.0", backbone["conv1"])
        for n, i in enumerate(_FIRE_FEATURES, start=1):
            for part in ("squeeze", "expand1x1", "expand3x3"):
                conv(f"features.{i}.{part}", backbone[f"fire{n}"][part])
    else:
        for i, leaves in zip(_VGG_FEATURES if net_type == "vgg" else _ALEX_FEATURES, backbone):
            conv(f"features.{i}", leaves)
    for i, w in enumerate(linear_weights):
        state[f"lins.{i}"] = torch.tensor(np.asarray(w)).reshape(1, -1)
    return state


def _as_plain(value: Any) -> Any:
    """A JAX ``CatBuffer`` object as the ``{"data", "count", "overflow"}`` dict of its
    state dict; anything else as it is."""
    if all(hasattr(value, a) for a in ("data", "count", "overflow")) and not isinstance(value, (np.ndarray, dict)):
        return {"data": np.asarray(value.data), "count": np.asarray(value.count), "overflow": np.asarray(value.overflow)}
    return value


def _load_collection(collection: MetricCollection, state: Dict[str, Any]) -> MetricCollection:
    names = set(collection.keys(keep_base=True))
    if state and set(state) <= names and all(isinstance(v, dict) for v in state.values()):
        # the pure tier's nested {name: {state: value}}: flattened to state-dict keys
        state = {f"{name}.{key}": value for name, states in state.items() for key, value in states.items()}
    grouped = {name for group in collection.compute_groups.values() for name in group[1:]}
    for name, metric in collection.items(keep_base=True, copy_state=False):
        if name in grouped:
            continue
        prefix = f"{name}."
        load_jax_state(metric, {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)})
    collection._repoint()
    return collection
