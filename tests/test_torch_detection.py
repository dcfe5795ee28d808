"""The box geometry, the IoU family and the greedy match of metrics_tpu_torch against
metrics_tpu, on the CPU.

- ``box_iou``, GIoU and DIoU matrices bit-equal to the JAX package's (0 ulp), zero-area
  and integer-coordinate boxes included; CIoU within 2.4e-7 absolute (its ``arctan``
  differs in the last bit between XLA and PyTorch, about 2 ulps of 1.0 after the
  products); ``box_convert`` and ``box_area`` bit-equal.
- The four functionals and the four classes against the JAX package on seeded boxes
  within 1e-6, and at the reference values the JAX tests hold (atol 1e-4).
- The greedy match: the plain version against ``_match_groups`` and
  ``_match_groups_from_iou``, ``det_matched``, ``det_ignored`` and ``npig``
  bit-equal, over pow2 and non-pow2 ``(N, D, G)``, tied IoUs, IoUs exactly at 0.5 and
  0.75 (and one float above), every COCO area range, invalid rows, a negative
  threshold and NaN IoUs.
- The names of ``detection`` and ``functional.detection``, the root exports and their
  ``FutureWarning`` shims, and the RLE codec against the JAX package's ``rle.py``.

The checks on the card are in ``tests/test_torch_detection_card.py``, which imports no JAX.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu.detection as jd
import metrics_tpu.functional as jfr
import metrics_tpu.functional.detection as jfd
import metrics_tpu_torch
import metrics_tpu_torch.detection as td
import metrics_tpu_torch.functional as tfr
import metrics_tpu_torch.functional.detection as tfd
from metrics_tpu.detection import rle as jrle
from metrics_tpu.functional.detection._mean_ap_kernel import _match_groups, _match_groups_from_iou
from metrics_tpu_torch.detection import rle as trle
from metrics_tpu_torch.functional.detection import _mean_ap_kernel as tk
from metrics_tpu_torch.ops.greedy_match import _plain_greedy_match, greedy_match, greedy_match_cuda
from tests.torch_deadline import deadline  # noqa: F401

THRESHOLDS = np.linspace(0.5, 0.95, 10).astype(np.float32)
AREAS = np.array([[0, 1e10], [0, 32**2], [32**2, 96**2], [96**2, 1e10]], np.float32)
BOX_FNS = ["box_iou", "generalized_box_iou", "distance_box_iou"]


def boxes(rng, n, integer=False, scale=100.0):
    b = rng.rand(n, 4).astype(np.float32) * scale
    b[:, 2:] += b[:, :2] + rng.rand(n, 2).astype(np.float32) * scale / 2
    if integer:
        b = np.round(b)
    if n > 1:
        b[0, 2] = b[0, 0]  # zero width
        b[1, 3] = b[1, 1]  # zero height
    return b.astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------- box ops


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
@pytest.mark.parametrize("name", BOX_FNS)
def test_box_matrices_bit_equal(name, integer):
    rng = np.random.RandomState(3 + integer)
    p, g = boxes(rng, 33, integer), boxes(rng, 20, integer)
    want = np.asarray(getattr(jfd, name)(jnp.asarray(p), jnp.asarray(g)))
    got = getattr(tfd, name)(t(p), t(g)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_complete_box_iou_within_atan_rounding(integer):
    rng = np.random.RandomState(5)
    p, g = boxes(rng, 33, integer), boxes(rng, 20, integer)
    want = np.asarray(jfd.complete_box_iou(jnp.asarray(p), jnp.asarray(g)))
    got = tfd.complete_box_iou(t(p), t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


def test_box_iou_batched_equals_per_group():
    rng = np.random.RandomState(8)
    p = np.stack([boxes(rng, 7) for _ in range(3)])
    g = np.stack([boxes(rng, 5) for _ in range(3)])
    batched = tfd.box_iou(t(p), t(g)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(batched[i], np.asarray(jfd.box_iou(jnp.asarray(p[i]), jnp.asarray(g[i]))))


def test_integer_boxes_hit_the_thresholds_exactly():
    # IoU 1/2 and 3/4 exactly: what a strict `>` at 0.5 and 0.75 decides on
    p = np.array([[0, 0, 20, 10], [0, 0, 40, 10]], np.float32)
    g = np.array([[0, 0, 10, 10], [0, 0, 30, 10]], np.float32)
    got = tfd.box_iou(t(p), t(g)).numpy()
    assert got[0, 0] == np.float32(0.5) and got[1, 1] == np.float32(0.75)
    np.testing.assert_array_equal(got, np.asarray(jfd.box_iou(jnp.asarray(p), jnp.asarray(g))))


@pytest.mark.parametrize("fmt", ["xywh", "cxcywh", "xyxy"])
def test_box_convert_and_area_bit_equal(fmt):
    b = boxes(np.random.RandomState(1), 9)
    np.testing.assert_array_equal(tfd.box_convert(t(b), fmt).numpy(), np.asarray(jfd.box_convert(jnp.asarray(b), fmt)))
    np.testing.assert_array_equal(tfd.box_area(t(b)).numpy(), np.asarray(jfd.box_area(jnp.asarray(b))))


def test_box_convert_errors_as_in_jax():
    xywh = np.array([[10.0, 20.0, 30.0, 40.0]], np.float32)
    for fn, arr in ((jfd.box_convert, jnp.asarray(xywh)), (tfd.box_convert, t(xywh))):
        with pytest.raises(ValueError, match="Unsupported box format"):
            fn(arr, "bad_fmt")
        with pytest.raises(ValueError, match="Only conversion to 'xyxy'"):
            fn(arr, "xywh", "cxcywh")


# ------------------------------------------------------------- functionals

FUNCTIONALS = [
    ("intersection_over_union", 0.6807),
    ("generalized_intersection_over_union", 0.6641),
    ("distance_intersection_over_union", 0.6724),
    ("complete_intersection_over_union", 0.6724),
]


@pytest.mark.parametrize(("name", "expected"), FUNCTIONALS)
def test_iou_functional_reference_values(name, expected):
    preds = torch.tensor([[100.0, 100.0, 200.0, 200.0]])
    target = torch.tensor([[110.0, 110.0, 210.0, 210.0]])
    np.testing.assert_allclose(float(getattr(tfd, name)(preds, target)), expected, atol=1e-4)


@pytest.mark.parametrize("kwargs", [{}, {"iou_threshold": 0.3}, {"iou_threshold": 0.3, "replacement_val": -1.0},
                                    {"aggregate": False}], ids=["default", "threshold", "replacement", "matrix"])
@pytest.mark.parametrize("name", [n for n, _ in FUNCTIONALS])
def test_iou_functionals_match_jax(name, kwargs):
    rng = np.random.RandomState(11)
    p, g = boxes(rng, 12), boxes(rng, 12)
    p[:6] = g[:6] + rng.randn(6, 4).astype(np.float32) * 3
    want = np.asarray(getattr(jfd, name)(jnp.asarray(p), jnp.asarray(g), **kwargs))
    got = getattr(tfd, name)(t(p), t(g), **kwargs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ classes

CLASSES = [
    ("IntersectionOverUnion", "iou", 0.4307),
    ("GeneralizedIntersectionOverUnion", "giou", -0.0694),
    ("DistanceIntersectionOverUnion", "diou", -0.0694),
    ("CompleteIntersectionOverUnion", "ciou", -0.5694),
]
_iou_preds = [{"boxes": np.array([[296.55, 93.96, 314.97, 152.79], [298.55, 98.96, 314.97, 151.79]], np.float32),
               "scores": np.array([0.236, 0.56], np.float32), "labels": np.array([4, 5])}]
_iou_target = [{"boxes": np.array([[300.00, 100.00, 315.00, 150.00]], np.float32), "labels": np.array([5])}]


def tlist(items):
    return [{k: t(v) for k, v in d.items()} for d in items]


def jlist(items):
    return [{k: jnp.asarray(v) for k, v in d.items()} for d in items]


@pytest.mark.parametrize(("cls", "key", "expected"), CLASSES)
def test_iou_class_reference_values(cls, key, expected):
    metric = getattr(td, cls)(device="cpu")
    result = metric(tlist(_iou_preds), tlist(_iou_target))
    np.testing.assert_allclose(float(result[key]), expected, atol=1e-4)


def iou_images(seed, n_images=6, num_classes=3):
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(n_images):
        ng = rng.randint(1, 6)
        nd = ng if i % 2 else rng.randint(1, 6)  # equal label lists in every other image
        gt = boxes(rng, ng, scale=60)
        gl = rng.randint(0, num_classes, ng)
        det = boxes(rng, nd, scale=60)
        k = min(nd, ng)
        det[:k] = gt[:k] + rng.randn(k, 4).astype(np.float32) * 2
        dl = gl.copy() if i % 2 else rng.randint(0, num_classes, nd)
        preds.append({"boxes": det, "scores": rng.rand(nd).astype(np.float32), "labels": dl})
        target.append({"boxes": gt, "labels": gl})
    return preds, target


@pytest.mark.parametrize("kwargs", [{}, {"class_metrics": True}, {"respect_labels": False}, {"iou_threshold": 0.4},
                                    {"box_format": "xywh", "class_metrics": True}],
                         ids=["default", "class_metrics", "no_labels", "threshold", "xywh"])
@pytest.mark.parametrize("cls", [c for c, _, _ in CLASSES])
def test_iou_classes_match_jax(cls, kwargs):
    preds, target = iou_images(7)
    jm = getattr(jd, cls)(**kwargs)
    tm = getattr(td, cls)(**kwargs, device="cpu")
    for lo, hi in ((0, 2), (2, 6)):
        jm.update(jlist(preds[lo:hi]), jlist(target[lo:hi]))
        tm.update(tlist(preds[lo:hi]), tlist(target[lo:hi]))
    want, got = jm.compute(), tm.compute()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=0, atol=1e-6, err_msg=key)


def test_iou_class_errors_as_in_jax():
    for metric in (jd.IntersectionOverUnion(), td.IntersectionOverUnion(device="cpu")):
        with pytest.raises(ValueError, match="Expected argument `preds` and `target` to have the same length"):
            metric.update(_iou_preds, [])
        with pytest.raises(ValueError, match="Expected all dicts in `preds` to contain the `scores` key"):
            metric.update([{"boxes": np.zeros((1, 4), np.float32), "labels": np.zeros(1)}], _iou_target)
        with pytest.raises(ValueError, match="Expected all boxes in `preds` to be of type Array"):
            metric.update([{**_iou_preds[0], "boxes": [[0.0, 0.0, 1.0, 1.0]] * 2}], _iou_target)
    for make in (jd.IntersectionOverUnion, lambda **k: td.IntersectionOverUnion(**k, device="cpu")):
        with pytest.raises(ValueError, match="box_format"):
            make(box_format="foo")
        with pytest.raises(ValueError, match="class_metrics"):
            make(class_metrics=1)
        with pytest.raises(ValueError, match="respect_labels"):
            make(respect_labels=1)


# ------------------------------------------------------------- greedy match


def match_inputs(seed, n, d, g, invalid=0.2):
    """IoUs with ties, exact thresholds (0.5, 0.75 and one float above 0.5) and zeros."""
    rng = np.random.RandomState(seed)
    special = np.array([0.0, 0.5, 0.75, np.nextafter(np.float32(0.5), np.float32(1)), 0.9, 0.3], np.float32)
    iou = rng.choice(special, (n, d, g)).astype(np.float32)
    free = rng.rand(n, d, g) < 0.4
    iou[free] = rng.rand(int(free.sum())).astype(np.float32)
    areas = np.array([10.0, 32.0**2, 1500.0, 96.0**2, 2e4], np.float32)
    d_area = rng.choice(areas, (n, d)).astype(np.float32)
    g_area = rng.choice(areas, (n, g)).astype(np.float32)
    dv = rng.rand(n, d) >= invalid
    gv = rng.rand(n, g) >= invalid
    if n > 2:
        dv[1] = False  # a group with no valid detection
        gv[2] = False  # and one with no valid ground truth
    return iou, d_area, g_area, dv, gv


def assert_match_equal(got, want):
    for name, g, w in zip(("det_matched", "det_ignored", "npig"), got, want):
        g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("shape", [(8, 16, 16), (5, 7, 3), (3, 1, 1), (1, 1, 9), (6, 32, 64), (4, 13, 40),
                                   (5, 17, 33), (3, 9, 65)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_greedy_match_bit_equal_to_jax_from_iou(shape):
    iou, d_area, g_area, dv, gv = match_inputs(sum(shape), *shape)
    want = _match_groups_from_iou(*(jnp.asarray(x) for x in (iou, d_area, g_area, dv, gv, THRESHOLDS, AREAS)))
    got = tk._match_groups_from_iou(*(t(x) for x in (iou, d_area, g_area, dv, gv, THRESHOLDS, AREAS)))
    assert_match_equal(got, want)


@pytest.mark.parametrize("other", [35, 36], ids=["same-lane", "next-lane"])
def test_plain_greedy_match_cross_lane_tie_bit_equal_to_jax(other):
    """Equal maxima at gt 3 and a gt past the first 32 (one lane of 32 apart, or two):
    the first wins, as in the scan; a NaN beside another row's maximum leaves it unmatched."""
    iou, d_area, g_area, dv, gv = match_inputs(7, 4, 6, 65)
    for g in (3, other):
        iou[:, :, g] = 0.875
    gv[:, [3, other]] = True
    g_area[:, [3, other]] = 500.0
    iou[1, 2, :] = 0.25
    iou[1, 2, 5] = np.nan
    iou[1, 2, 64] = 0.95
    thresholds = np.array([-0.1, 0.5, 0.75, 1.0], np.float32)
    want = _match_groups_from_iou(*(jnp.asarray(x) for x in (iou, d_area, g_area, dv, gv, thresholds, AREAS)))
    got = _plain_greedy_match(*(t(x) for x in (iou, d_area, g_area, dv, gv, thresholds, AREAS)))
    assert_match_equal(got, want)


def test_plain_greedy_match_edge_thresholds_and_nan():
    iou, d_area, g_area, dv, gv = match_inputs(4, 6, 9, 12)
    iou[0, 0, :3] = np.nan
    iou[3, 2, 5] = np.nan
    thresholds = np.array([-0.1, 0.0, 0.5, 0.75, 1.0], np.float32)
    want = _match_groups_from_iou(*(jnp.asarray(x) for x in (iou, d_area, g_area, dv, gv, thresholds, AREAS)))
    got = _plain_greedy_match(*(t(x) for x in (iou, d_area, g_area, dv, gv, thresholds, AREAS)))
    assert_match_equal(got, want)


@pytest.mark.parametrize(("n", "d", "g"), [(8, 16, 16), (4, 8, 32)], ids=["16x16", "8x32"])
def test_box_match_bit_equal_to_jax(n, d, g):
    rng = np.random.RandomState(n + d + g)
    gt = np.stack([boxes(rng, g, integer=True, scale=120) for _ in range(n)])
    det = gt[:, rng.randint(0, g, d)] + np.round(rng.randn(n, d, 4) * 4).astype(np.float32)
    det[..., 2:] = np.maximum(det[..., 2:], det[..., :2] + 1)
    dv = rng.rand(n, d) < 0.85
    gv = rng.rand(n, g) < 0.85
    want = _match_groups(*(jnp.asarray(x) for x in (det, dv, gt, gv, THRESHOLDS, AREAS)))
    got = tk._match_groups(*(t(x) for x in (det, dv, gt, gv, THRESHOLDS, AREAS)))
    assert_match_equal(got, want)
    iou = tfd.box_iou(t(det[0]), t(gt[0]))
    one = tk._per_group_from_iou(iou[None], tfd.box_area(t(det[:1])), tfd.box_area(t(gt[:1])), t(dv[:1]),
                                 t(gv[:1]), t(THRESHOLDS), t(AREAS))
    for a, b in zip(one, got):
        np.testing.assert_array_equal(a.numpy(), b[:1].numpy())


def test_greedy_match_checks_and_cpu_dispatch():
    iou, d_area, g_area, dv, gv = match_inputs(1, 2, 3, 4)
    args = [t(x) for x in (iou, d_area, g_area, dv, gv, THRESHOLDS, AREAS)]
    before = greedy_match_cuda.launches
    greedy_match(*args)
    assert greedy_match_cuda.launches == before  # CPU tensors take the plain version
    with pytest.raises(ValueError, match="d_area must be torch.float32"):
        greedy_match(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="gt_valid must be torch.bool of shape"):
        greedy_match(*args[:4], args[4][:, :2], *args[5:])
    with pytest.raises(ValueError, match="must be CUDA tensors"):
        greedy_match_cuda(*args)


# ---------------------------------------------------------- names and shims


@pytest.mark.parametrize("module,port", [(jd, td), (jfd, tfd)], ids=["detection", "functional.detection"])
def test_every_public_name_exists_in_the_port(module, port):
    assert set(port.__all__) == set(module.__all__)
    assert all(hasattr(port, n) for n in module.__all__)


def test_root_exports_match_the_jax_root_for_detection():
    for name in jd.__all__:
        assert (name in metrics_tpu.__all__) == (name in metrics_tpu_torch.__all__), name
    for name in jfd.__all__:
        assert (name in jfr.__all__) == (name in tfr.__all__), name


def _warns(fn) -> bool:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return any(issubclass(w.category, FutureWarning) for w in caught)


@pytest.mark.parametrize("name", ["PanopticQuality", "ModifiedPanopticQuality", "IntersectionOverUnion",
                                  "MeanAveragePrecision"])
def test_root_class_shims_warn_as_in_jax(name):
    kwargs = {"things": {0, 1}, "stuffs": {6, 7}} if "Panoptic" in name else {}
    jax_warns = _warns(lambda: getattr(metrics_tpu, name)(**kwargs))
    assert _warns(lambda: getattr(metrics_tpu_torch, name)(**kwargs, device="cpu")) == jax_warns
    assert not _warns(lambda: getattr(td, name)(**kwargs, device="cpu"))


@pytest.mark.parametrize("name", ["panoptic_quality", "modified_panoptic_quality", "intersection_over_union"])
def test_root_functional_shims_warn_as_in_jax(name):
    if "panoptic" in name:
        x = np.array([[[0, 0], [6, 0]]])
        args, kwargs = (x, x), {"things": {0}, "stuffs": {6}}
    else:
        b = np.array([[0.0, 0.0, 2.0, 2.0]], np.float32)
        args, kwargs = (b, b), {}
    jax_warns = _warns(lambda: getattr(jfr, name)(*(jnp.asarray(a) for a in args), **kwargs))
    assert _warns(lambda: getattr(tfr, name)(*(t(a) for a in args), **kwargs)) == jax_warns
    assert not _warns(lambda: getattr(tfd, name)(*(t(a) for a in args), **kwargs))


# ---------------------------------------------------------------------- RLE


def _random_mask(rng, h=23, w=17):
    base = rng.rand(h // 4 + 1, w // 4 + 1) > 0.5
    return np.kron(base, np.ones((4, 4), bool))[:h, :w]


@pytest.mark.parametrize("seed", range(4))
def test_rle_round_trip_and_codec_match_jax(seed):
    rng = np.random.RandomState(seed)
    mask = _random_mask(rng)
    for compress in (False, True):
        got, want = trle.rle_encode(mask, compress=compress), jrle.rle_encode(mask, compress=compress)
        assert got == want
        np.testing.assert_array_equal(trle.rle_decode(got), mask)
    counts = [0, 1, 31, 32, 1024, 5, 100000, 3, int(rng.randint(1, 1 << 20))]
    assert trle._counts_to_string(counts) == jrle._counts_to_string(counts)
    assert trle._counts_from_string(trle._counts_to_string(counts)) == counts


def test_rle_edge_cases_and_errors():
    assert trle.masks_from_rle([]).shape == (0, 1, 1)
    ones = np.ones((5, 4), bool)
    assert trle.rle_encode(ones)["counts"][0] == 0
    with pytest.raises(ValueError, match="counts sum"):
        trle.rle_decode({"size": [4, 4], "counts": [3, 2]})
    with pytest.raises(ValueError, match="share a size"):
        trle.masks_from_rle([trle.rle_encode(np.zeros((2, 2), bool)), trle.rle_encode(np.zeros((3, 2), bool))])
