"""PanopticQuality and ModifiedPanopticQuality of metrics_tpu_torch against metrics_tpu,
on the CPU.

The same seeded panoptic maps go through both packages: void pixels (categories
outside things and stuffs, in the target and, with ``allow_unknown_preds_category``,
in the preds), stuff instance ids that must be ignored, modified-stuff categories,
several updates. TP, FP and FN counts are bit-equal; ``iou_sum`` and PQ agree within
1e-6 (the port's ``iou_sum`` is float64, the JAX package's float32 without
``jax_enable_x64``). The errors have the JAX package's types and messages. The maps are
small and few: the JAX package runs each sample eagerly, one compile per new shape.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.detection as jd
import metrics_tpu.functional.detection as jfd
import metrics_tpu_torch.detection as td
import metrics_tpu_torch.functional.detection as tfd
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.ops import histogram
from tests.torch_deadline import deadline  # noqa: F401

THINGS, STUFFS = {0, 1, 3}, {6, 7}
ATOL = 1e-6

_pq_preds = np.array([[[[6, 0], [0, 0], [6, 0], [6, 0]],
                       [[0, 0], [0, 0], [6, 0], [0, 1]],
                       [[0, 0], [0, 0], [6, 0], [0, 1]],
                       [[0, 0], [7, 0], [6, 0], [1, 0]],
                       [[0, 0], [7, 0], [7, 0], [7, 0]]]])
_pq_target = np.array([[[[6, 0], [0, 1], [6, 0], [0, 1]],
                        [[0, 1], [0, 1], [6, 0], [0, 1]],
                        [[0, 1], [0, 1], [6, 0], [1, 0]],
                        [[0, 1], [7, 0], [1, 0], [1, 0]],
                        [[0, 1], [7, 0], [7, 0], [7, 0]]]])
_mod_preds = np.array([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
_mod_target = np.array([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])


def t(x):
    return torch.from_numpy(np.array(x))


def panoptic_maps(seed, n=2, size=8, unknown_preds=False):
    """Blocky maps: 2x2 tiles of one segment each, 30% of tiles changed in the preds."""
    rng = np.random.RandomState(seed)
    cats = np.array([0, 1, 3, 6, 7, 9])  # 9: void
    tiles = size // 2
    cat = cats[rng.randint(0, len(cats) - (0 if unknown_preds else 1), (n, tiles, tiles))]
    inst = rng.randint(0, 3, (n, tiles, tiles))
    target = np.stack([cats[rng.randint(0, len(cats), (n, tiles, tiles))], rng.randint(0, 3, (n, tiles, tiles))], -1)
    preds = np.where((rng.rand(n, tiles, tiles) < 0.7)[..., None], target, np.stack([cat, inst], -1))
    if not unknown_preds:
        preds[..., 0] = np.where(preds[..., 0] == 9, 6, preds[..., 0])
    up = lambda x: np.repeat(np.repeat(x, 2, 1), 2, 2)  # noqa: E731
    return up(preds), up(target)


def test_reference_values():
    assert round(float(tfd.panoptic_quality(t(_pq_preds), t(_pq_target), {0, 1}, {6, 7})), 4) == 0.5463
    assert round(float(tfd.modified_panoptic_quality(t(_mod_preds), t(_mod_target), {0, 1}, {6, 7})), 4) == 0.7667
    value = tfd.panoptic_quality(t(_mod_preds), t(_mod_target), {0, 1}, {6, 7}, allow_unknown_preds_category=True)
    assert round(float(value), 4) == 0.6
    perfect = td.PanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
    perfect.update(t(_pq_target), t(_pq_target))
    assert float(perfect.compute()) == 1.0


@pytest.mark.parametrize(("name", "cls", "kwargs", "unknown"), [
    ("panoptic_quality", "PanopticQuality", {}, False),
    ("panoptic_quality", "PanopticQuality", {"allow_unknown_preds_category": True}, True),
    ("modified_panoptic_quality", "ModifiedPanopticQuality", {}, False),
], ids=["pq", "pq_unknown_preds", "modified"])
def test_counts_bit_equal_and_pq_match_jax(name, cls, kwargs, unknown):
    preds, target = panoptic_maps(3, unknown_preds=unknown)
    want = float(getattr(jfd, name)(jnp.asarray(preds), jnp.asarray(target), THINGS, STUFFS, **kwargs))
    got = getattr(tfd, name)(t(preds), t(target), THINGS, STUFFS, **kwargs)
    np.testing.assert_allclose(float(got), want, rtol=0, atol=ATOL)

    jm = getattr(jd, cls)(things=THINGS, stuffs=STUFFS, **kwargs)
    tm = getattr(td, cls)(things=THINGS, stuffs=STUFFS, **kwargs, device="cpu")
    for i in range(2):  # one sample per update: the class accumulates
        jm.update(jnp.asarray(preds[i:i + 1]), jnp.asarray(target[i:i + 1]))
        tm.update(t(preds[i:i + 1]), t(target[i:i + 1]))
    for state in ("true_positives", "false_positives", "false_negatives"):
        got_state = getattr(tm, state)
        assert got_state.dtype == torch.int32
        np.testing.assert_array_equal(got_state.numpy(), np.asarray(getattr(jm, state)), err_msg=state)
    assert tm.iou_sum.dtype == torch.float64
    np.testing.assert_allclose(tm.iou_sum.numpy(), np.asarray(jm.iou_sum), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(tm.compute()), want, rtol=0, atol=ATOL)


def test_load_jax_state_and_forward():
    preds, target = panoptic_maps(5, n=1)
    jm = jd.PanopticQuality(things=THINGS, stuffs=STUFFS)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    jm.persistent(True)
    tm = load_jax_state(td.PanopticQuality(things=THINGS, stuffs=STUFFS, device="cpu"), jm.state_dict())
    np.testing.assert_allclose(float(tm.compute()), float(jm.compute()), rtol=0, atol=ATOL)
    fresh = td.PanopticQuality(things=THINGS, stuffs=STUFFS, device="cpu")
    batch = fresh(t(preds), t(target))
    np.testing.assert_allclose(float(batch), float(jm.compute()), rtol=0, atol=ATOL)
    assert torch.equal(fresh.true_positives, tm.true_positives)


def test_cpu_update_launches_no_kernel():
    before = histogram.histogram_cuda.launches
    tfd.panoptic_quality(t(_pq_preds), t(_pq_target), {0, 1}, {6, 7})
    assert histogram.histogram_cuda.launches == before


def _raises_like(call_jax, call_port):
    with pytest.raises(Exception) as jax_err:
        call_jax()
    with pytest.raises(Exception) as port_err:
        call_port()
    assert type(port_err.value) is type(jax_err.value)
    return str(jax_err.value), str(port_err.value)


@pytest.mark.parametrize(("things", "stuffs"), [({0, 1}, {1, 2}), (set(), set()), ({0.5}, {1})],
                         ids=["overlap", "empty", "not_int"])
def test_category_errors_match_jax(things, stuffs):
    jmsg, tmsg = _raises_like(lambda: jd.PanopticQuality(things=things, stuffs=stuffs),
                              lambda: td.PanopticQuality(things=things, stuffs=stuffs, device="cpu"))
    assert tmsg == jmsg


@pytest.mark.parametrize("case", ["unknown", "shape", "ndim", "channels"])
def test_input_errors_match_jax(case):
    preds, target = {
        "unknown": ([[[5, 0]]], [[[0, 0]]]),
        "shape": (np.zeros((1, 4, 2), int), np.zeros((1, 5, 2), int)),
        "ndim": (np.zeros((4, 2), int), np.zeros((4, 2), int)),
        "channels": (np.zeros((1, 4, 3), int), np.zeros((1, 4, 3), int)),
    }[case]
    jm = jd.PanopticQuality(things={0}, stuffs={6})
    tm = td.PanopticQuality(things={0}, stuffs={6}, device="cpu")
    jmsg, tmsg = _raises_like(lambda: jm.update(jnp.asarray(preds), jnp.asarray(target)),
                              lambda: tm.update(t(preds), t(target)))
    if case == "unknown":
        assert jmsg.startswith("Unknown categories found") and tmsg.startswith("Unknown categories found")
    else:
        assert tmsg == jmsg


def test_duplicate_categories_warn():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        td.PanopticQuality(things=[0, 0, 1], stuffs=[6, 6], device="cpu")
    messages = [str(w.message) for w in caught]
    assert any("`things` categories contained duplicates" in m for m in messages)
    assert any("`stuffs` categories contained duplicates" in m for m in messages)
