"""MeanAveragePrecision of metrics_tpu_torch against metrics_tpu, on the CPU.

Every result key (the twelve COCO numbers, the per-class lists and ``classes``) within
1e-6 of the JAX package's, on the same seeded inputs:

- the ragged datasets of ``tests/unittests/detection/test_consolidated_and_rle.py``,
  in the list layout, the consolidated layout and mixed layouts (the consolidated
  states take the device path, the others the host path in both packages);
- the cocoapi subset of ``test_detection.py``, at the pycocotools numbers within
  1e-2 (the reference's own tolerance) and at the JAX package's within 1e-6;
- ``xywh``/``cxcywh`` boxes, ``class_metrics``, custom and unsorted thresholds,
  empty images, no updates, a big bucket wider than the input;
- segm with dense masks and with COCO RLE, and rectangle masks against bbox;
- the device tables (``_calculate_device``) against the JAX package's within 1e-6 and
  bit-equal to its host path's: the port's device tables are float64 (the JAX
  package's float32), so a recall that lands on a recall threshold gives the list
  layout's value in both layouts, where the JAX package's consolidated layout differs;
- the same exception types and messages;
- ``load_jax_state`` of a JAX mAP's list states, and a sync over two ``gloo`` ranks of
  four images each (``tests/torch_detection_ranks.py``): mAP against one JAX run on the
  union, IoU and panoptic quality against one run of the port on the union.
"""
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import metrics_tpu.detection as jd
import metrics_tpu_torch.detection as td
from metrics_tpu_torch.convert import load_jax_state
from metrics_tpu_torch.detection.rle import rle_encode
from metrics_tpu_torch.ops.greedy_match import greedy_match_cuda

from tests import torch_detection_ranks as ranks
from tests.unittests.detection import test_consolidated_and_rle as jcr
from tests.unittests.detection import test_detection as jtd

ATOL = 1e-6
DEADLINE_S = 120


def t(x):
    return torch.from_numpy(np.array(x))


def tlist(items):
    return [{k: (v if isinstance(v, list) else t(v)) for k, v in d.items()} for d in items]


def tdict(d):
    return {k: t(v) for k, v in d.items()}


def assert_results_close(got, want, atol=ATOL):
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key], np.float64).reshape(-1)
        g = got[key].detach().cpu().numpy().astype(np.float64).reshape(-1)
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if key == "classes":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


def run_jax(updates, **kwargs):
    metric = jd.MeanAveragePrecision(**kwargs)
    for preds, target in updates:
        metric.update(preds, target)
    return metric.compute()


def run_port(updates, **kwargs):
    metric = td.MeanAveragePrecision(**kwargs, device="cpu")
    for preds, target in updates:
        if isinstance(preds, dict):
            metric.update(tdict(preds), tdict(target))
        else:
            metric.update(tlist(preds), tlist(target))
    return metric.compute()


# ------------------------------------------------------------------- layouts


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_list_and_consolidated_layouts_match_jax(seed):
    preds, target = jcr._ragged_dataset(seed)
    want = run_jax([(preds, target)], class_metrics=True)
    assert float(want["map"]) > 0.005
    assert_results_close(run_port([(preds, target)], class_metrics=True), want)
    packed = [tuple({k: np.asarray(v) for k, v in d.items()} for d in jcr._consolidate(preds, target))]
    assert_results_close(run_port(packed, class_metrics=True), run_jax(packed, class_metrics=True))
    assert_results_close(run_port(packed, class_metrics=True), want)


def test_mixed_layouts_match_jax():
    preds, target = jcr._ragged_dataset(21, n_images=8)
    pack = lambda p, t_: tuple({k: np.asarray(v) for k, v in d.items()} for d in jcr._consolidate(p, t_))  # noqa
    updates = [pack(preds[:3], target[:3]), (preds[3:5], target[3:5]), pack(preds[5:], target[5:])]
    want = run_jax(updates)
    assert_results_close(run_port(updates), want)
    assert_results_close(run_port([(preds, target)]), want)


@pytest.mark.parametrize("fmt", ["xywh", "cxcywh"])
def test_box_formats_match_jax(fmt):
    preds, target = jcr._ragged_dataset(5, n_images=6)

    def convert(item):
        b = item["boxes"].copy()
        if b.size:
            w, h = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
            b = np.stack([b[:, 0], b[:, 1], w, h], 1) if fmt == "xywh" else np.stack(
                [b[:, 0] + w / 2, b[:, 1] + h / 2, w, h], 1)
        return {**item, "boxes": b.astype(np.float32)}

    preds, target = [convert(p) for p in preds], [convert(x) for x in target]
    packed = [tuple({k: np.asarray(v) for k, v in d.items()} for d in jcr._consolidate(preds, target))]
    for updates in ([(preds, target)], packed):
        assert_results_close(run_port(updates, box_format=fmt), run_jax(updates, box_format=fmt))


def test_big_bucket_wider_than_input_matches_jax():
    rng = np.random.RandomState(4)
    B, M = 3, 20
    gt = rng.rand(B, 6, 4).astype(np.float32) * 60
    gt[..., 2:] += gt[..., :2] + 5
    pb = rng.rand(B, M, 4).astype(np.float32) * 60
    pb[..., 2:] += pb[..., :2] + 5
    pb[0, :6] = gt[0] + rng.randn(6, 4).astype(np.float32)
    pl = np.zeros((B, M), np.int32)
    pl[1:, 17:] = -1
    packed = [({"boxes": pb, "scores": rng.rand(B, M).astype(np.float32), "labels": pl},
               {"boxes": gt, "labels": np.zeros((B, 6), np.int32)})]
    assert_results_close(run_port(packed, class_metrics=True), run_jax(packed, class_metrics=True))


def test_device_tables_match_jax():
    preds, target = jcr._ragged_dataset(3, n_images=16, num_classes=3)
    rng = np.random.RandomState(9)
    gt = rng.rand(18, 4).astype(np.float32) * 80
    gt[:, 2:] += gt[:, :2] + 4
    # one group of 18 gts and 20 detections: the big bucket, beside the small one
    target[0] = {"boxes": gt, "labels": np.zeros(18, np.int32)}
    preds[0] = {"boxes": gt[rng.randint(0, 18, 20)] + rng.randn(20, 4).astype(np.float32),
                "scores": rng.rand(20).astype(np.float32), "labels": np.zeros(20, np.int32)}
    jp, jt = jcr._consolidate(preds, target)
    jm = jd.MeanAveragePrecision()
    jm.update(jp, jt)
    tm = td.MeanAveragePrecision(device="cpu")
    tm.update(tdict({k: np.asarray(v) for k, v in jp.items()}), tdict({k: np.asarray(v) for k, v in jt.items()}))
    assert jm._device_path_ok() and tm._device_path_ok()
    jc, jprec, jrec = jm._calculate_device()
    tc, tprec, trec = tm._calculate_device()
    assert jc == tc
    np.testing.assert_allclose(tprec, jprec, rtol=0, atol=ATOL)
    np.testing.assert_allclose(trec, jrec, rtol=0, atol=ATOL)
    # the port's float64 device tables are the host path's, to the last bit
    host = jm._fetch_host_states()
    hprec, hrec = jm._calculate(jm._get_classes(host), host)
    np.testing.assert_array_equal(tprec, hprec)
    np.testing.assert_array_equal(trec, hrec)


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_host_tables_bit_equal_to_jax(iou_type):
    if iou_type == "bbox":
        preds, target = jcr._ragged_dataset(11, n_images=10)
    else:
        _, _, preds, target = _segm_pair(2, n_images=5)
    jm = jd.MeanAveragePrecision(iou_type=iou_type, max_detection_thresholds=[1, 3, 100])
    jm.update(preds, target)
    tm = td.MeanAveragePrecision(iou_type=iou_type, max_detection_thresholds=[1, 3, 100], device="cpu")
    tm.update(tlist(preds), tlist(target))
    jhost, thost = jm._fetch_host_states(), tm._fetch_host_states()
    assert jm._get_classes(jhost) == tm._get_classes(thost)
    for want, got in zip(jm._calculate(jm._get_classes(jhost), jhost), tm._calculate(tm._get_classes(thost), thost)):
        np.testing.assert_array_equal(got, want)


def test_recall_on_a_threshold_gives_the_list_layout_value():
    """7 of 20 gts matched: the recall 0.35 lands on a recall threshold. The JAX
    package's float32 device tables find it (0.35f == float32(0.35)), its float64 host
    path does not (7/20 < 0.35000000000000003), so its two layouts disagree by ~1e-2.
    The port's device tables are float64: both of its layouts give the list value."""
    gt = np.array([[x * 30, y * 30, x * 30 + 20, y * 30 + 20] for x in range(5) for y in range(4)], np.float32)
    det = np.concatenate([gt[:7], gt[7:] + 400]).astype(np.float32)
    preds = [{"boxes": det, "scores": np.linspace(0.9, 0.1, 20).astype(np.float32), "labels": np.zeros(20, np.int64)}]
    target = [{"boxes": gt, "labels": np.zeros(20, np.int64)}]
    packed = [tuple({k: np.asarray(v) for k, v in d.items()} for d in jcr._consolidate(preds, target))]
    want = run_jax([(preds, target)])
    assert abs(float(run_jax(packed)["map"]) - float(want["map"])) > 1e-3
    assert_results_close(run_port(packed), want)
    assert_results_close(run_port([(preds, target)]), want)


def test_tied_scores_across_buckets_give_the_list_layout_value():
    """A crowded image first (18 gts: the big bucket) and a small one after it, every
    score tied. The list layout orders tied rows by image: the crowded image's 20 false
    positives, then the small image's 2 true positives. The JAX package's device tables
    put small-bucket rows first, so its two layouts disagree; the port's device tables
    order ties by (image, slot) and give the list value in both layouts."""
    gt = np.array([[x * 30, y * 30, x * 30 + 20, y * 30 + 20] for x in range(6) for y in range(3)], np.float32)
    far = gt[np.arange(20) % 18] + 300
    small_gt = np.array([[0, 0, 40, 40], [100, 100, 150, 140]], np.float32)
    tie = lambda n: np.full(n, 0.5, np.float32)  # noqa: E731
    preds = [{"boxes": far, "scores": tie(20), "labels": np.zeros(20, np.int64)},
             {"boxes": small_gt, "scores": tie(2), "labels": np.zeros(2, np.int64)}]
    target = [{"boxes": gt, "labels": np.zeros(18, np.int64)},
              {"boxes": small_gt, "labels": np.zeros(2, np.int64)}]
    packed = [tuple({k: np.asarray(v) for k, v in d.items()} for d in jcr._consolidate(preds, target))]
    want = run_jax([(preds, target)], class_metrics=True)
    assert abs(float(run_jax(packed, class_metrics=True)["map"]) - float(want["map"])) > 1e-2
    assert_results_close(run_port(packed, class_metrics=True), want)
    assert_results_close(run_port([(preds, target)], class_metrics=True), want)


# ------------------------------------------------------------- cocoapi subset


def _coco_subset():
    conv = lambda items: [{k: np.asarray(v) for k, v in d.items()} for d in items]  # noqa: E731
    return conv(jtd._map_preds), conv(jtd._map_target)


def test_cocoapi_subset_pycocotools_parity():
    preds, target = _coco_subset()
    updates = [(preds[:2], target[:2]), (preds[2:], target[2:])]
    got = run_port(updates, class_metrics=True)
    expected = {"map": 0.637, "map_50": 0.859, "map_75": 0.761, "map_small": 0.622, "map_medium": 0.800,
                "map_large": 0.635, "mar_1": 0.432, "mar_10": 0.652, "mar_100": 0.652, "mar_small": 0.673,
                "mar_medium": 0.800, "mar_large": 0.633}
    for key, value in expected.items():
        np.testing.assert_allclose(float(got[key]), value, atol=1e-2, err_msg=key)
    np.testing.assert_allclose(got["map_per_class"].numpy(), [0.725, 0.800, 0.454, -1.000, 0.650, 0.556], atol=1e-2)
    np.testing.assert_allclose(got["mar_100_per_class"].numpy(), [0.780, 0.800, 0.450, -1.000, 0.650, 0.580],
                               atol=1e-2)
    assert_results_close(got, run_jax(updates, class_metrics=True))


@pytest.mark.parametrize("kwargs", [
    {"max_detection_thresholds": [5, 1, 2]},
    {"iou_thresholds": [0.3, 0.5, 0.75], "rec_thresholds": [0.0, 0.25, 0.5, 0.75, 1.0]},
    {"iou_thresholds": [0.6], "class_metrics": True},
], ids=["unsorted_max_det", "custom_thresholds", "no_50_75"])
def test_thresholds_match_jax(kwargs):
    preds, target = _coco_subset()
    updates = [(preds, target)]
    want = run_jax(updates, **kwargs)
    assert_results_close(run_port(updates, **kwargs), want)
    # the consolidated layout against the JAX list layout: at the 0.6 threshold a recall
    # lands on a recall threshold, where the JAX package's float32 device tables differ
    packed = [tuple({k: np.asarray(v) for k, v in d.items()} for d in jcr._consolidate(preds, target))]
    assert_results_close(run_port(packed, **kwargs), want)


def test_single_box_and_empty_images_match_jax():
    one = {"boxes": np.array([[258.0, 41.0, 606.0, 285.0]], np.float32), "scores": np.array([0.536], np.float32),
           "labels": np.array([0])}
    gt = {"boxes": np.array([[214.0, 41.0, 562.0, 285.0]], np.float32), "labels": np.array([0])}
    no_gt = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int32)}
    no_det = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int32)}
    other = {"boxes": np.array([[1.0, 2.0, 3.0, 4.0]], np.float32), "labels": np.array([1])}
    for updates in ([([one], [gt])], [([one, one], [gt, no_gt])], [([one, no_det], [gt, other])],
                    [([no_det], [no_gt])]):
        got, want = run_port(updates, class_metrics=True), run_jax(updates, class_metrics=True)
        assert_results_close(got, want)
    got = run_port([([one], [gt])])
    assert (round(float(got["map"]), 4), round(float(got["map_50"]), 4)) == (0.6, 1.0)


def test_no_updates_match_jax():
    with pytest.warns(UserWarning, match="before the ``update``"):
        got = td.MeanAveragePrecision(device="cpu").compute()
    assert_results_close(got, jd.MeanAveragePrecision().compute())
    assert float(got["map"]) == -1.0


def test_forward_and_reset():
    preds, target = jcr._ragged_dataset(0, n_images=6)
    metric = td.MeanAveragePrecision(device="cpu")
    batch = metric(tlist(preds[:3]), tlist(target[:3]))
    metric(tlist(preds[3:]), tlist(target[3:]))
    assert_results_close(batch, run_jax([(preds[:3], target[:3])]))
    assert_results_close(metric.compute(), run_jax([(preds, target)]))
    metric.reset()
    assert metric.detections == [] and metric.groundtruth_labels == []


# --------------------------------------------------------------------- segm

H = W = 48


def _rect_mask(box):
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    m = np.zeros((H, W), bool)
    m[y0:y1, x0:x1] = True
    return m


def _segm_pair(seed, n_images=5):
    rng = np.random.RandomState(seed)
    preds_b, target_b, preds_m, target_m = [], [], [], []
    for _ in range(n_images):
        nd, ng = rng.randint(1, 6), rng.randint(1, 4)
        db, gb = np.zeros((nd, 4), np.float32), np.zeros((ng, 4), np.float32)
        for arr, n in ((db, nd), (gb, ng)):
            for i in range(n):
                x0, y0 = rng.randint(0, W - 12, 2)
                w, h = rng.randint(4, 12, 2)
                arr[i] = [x0, y0, x0 + w, y0 + h]
        db[: min(nd, ng)] = gb[: min(nd, ng)] + rng.randint(-1, 2, (min(nd, ng), 4))
        scores = rng.rand(nd).astype(np.float32)
        dl, gl = rng.randint(0, 2, nd), rng.randint(0, 2, ng)
        preds_b.append({"boxes": db, "scores": scores, "labels": dl})
        target_b.append({"boxes": gb, "labels": gl})
        preds_m.append({"masks": np.stack([_rect_mask(b) for b in db]), "scores": scores, "labels": dl})
        target_m.append({"masks": np.stack([_rect_mask(b) for b in gb]), "labels": gl})
    return preds_b, target_b, preds_m, target_m


@pytest.mark.parametrize("seed", [0, 7])
def test_segm_dense_and_rle_match_jax_and_bbox(seed):
    preds_b, target_b, preds_m, target_m = _segm_pair(seed)
    want = run_jax([(preds_m, target_m)], iou_type="segm", class_metrics=True)
    got = run_port([(preds_m, target_m)], iou_type="segm", class_metrics=True)
    assert_results_close(got, want)
    assert_results_close(got, run_port([(preds_b, target_b)], class_metrics=True))
    rle_p = [{**p, "masks": [rle_encode(m, compress=bool(i % 2)) for i, m in enumerate(p["masks"])]} for p in preds_m]
    rle_t = [{**x, "masks": [rle_encode(m) for m in x["masks"]]} for x in target_m]
    assert_results_close(run_port([(rle_p, rle_t)], iou_type="segm", class_metrics=True), want)


def test_segm_consolidated_and_empty_masks_match_jax():
    _, _, preds_m, target_m = _segm_pair(3, n_images=4)
    preds_m.append({"masks": np.zeros((0, H, W), bool), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, int)})
    target_m.append({"masks": np.stack([_rect_mask([1, 1, 9, 9])]), "labels": np.array([1])})
    md = max(p["masks"].shape[0] for p in preds_m)
    mg = max(x["masks"].shape[0] for x in target_m)
    pm, ps, pl = np.zeros((5, md, H, W), np.uint8), np.full((5, md), -np.inf, np.float32), np.full((5, md), -1)
    tm, tl = np.zeros((5, mg, H, W), np.uint8), np.full((5, mg), -1)
    for i, (p, x) in enumerate(zip(preds_m, target_m)):
        n = p["masks"].shape[0]
        pm[i, :n], ps[i, :n], pl[i, :n] = p["masks"] * 255, p["scores"], p["labels"]
        n = x["masks"].shape[0]
        tm[i, :n], tl[i, :n] = x["masks"], x["labels"]
    packed = [({"masks": pm, "scores": ps, "labels": pl}, {"masks": tm, "labels": tl})]
    want = run_jax([(preds_m, target_m)], iou_type="segm")
    assert_results_close(run_port([(preds_m, target_m)], iou_type="segm"), want)
    assert_results_close(run_port(packed, iou_type="segm"), run_jax(packed, iou_type="segm"))
    assert_results_close(run_port(packed, iou_type="segm"), want)


# ------------------------------------------------------------------- errors


def _raises_like(call_jax, call_port):
    with pytest.raises(Exception) as jax_err:
        call_jax()
    with pytest.raises(Exception) as port_err:
        call_port()
    assert type(port_err.value) is type(jax_err.value)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kwargs", [{"class_metrics": "yes"}, {"box_format": "foo"}, {"iou_type": "rle"}],
                         ids=["class_metrics", "box_format", "iou_type"])
def test_constructor_errors_match_jax(kwargs):
    _raises_like(lambda: jd.MeanAveragePrecision(**kwargs), lambda: td.MeanAveragePrecision(**kwargs, device="cpu"))


def _update_error_cases():
    box = np.array([[0.0, 0.0, 4.0, 4.0]], np.float32)
    p = {"boxes": box, "scores": np.array([0.5], np.float32), "labels": np.array([0])}
    g = {"boxes": box, "labels": np.array([0])}
    good_p = {"boxes": np.zeros((2, 3, 4), np.float32), "scores": np.zeros((2, 3), np.float32),
              "labels": np.zeros((2, 3), np.int32)}
    good_t = {"boxes": np.zeros((2, 3, 4), np.float32), "labels": np.zeros((2, 3), np.int32)}
    return {
        "length": ([p], []),
        "missing_scores": ([{"boxes": box, "labels": np.array([0])}], [g]),
        "missing_target_labels": ([p], [{"boxes": box}]),
        "boxes_not_array": ([{**p, "boxes": [[0.0, 0.0, 1.0, 1.0]]}], [g]),
        "scores_not_array": ([{**p, "scores": [0.5]}], [g]),
        "target_labels_length": ([p], [{**g, "labels": np.array([0, 1])}]),
        "pred_scores_length": ([{**p, "scores": np.array([0.5, 0.2], np.float32)}], [g]),
        "consolidated_missing": ({k: v for k, v in good_p.items() if k != "scores"}, good_t),
        "consolidated_shape": ({**good_p, "boxes": np.zeros((2, 3, 5), np.float32)}, good_t),
        "consolidated_batch": (good_p, {"boxes": np.zeros((3, 3, 4), np.float32), "labels": np.zeros((3, 3), np.int32)}),
        "consolidated_labels": ({**good_p, "labels": np.zeros((2, 4), np.int32)}, good_t),
        "consolidated_scores": ({**good_p, "scores": np.zeros((2, 2), np.float32)}, good_t),
    }


@pytest.mark.parametrize("case", sorted(_update_error_cases()))
def test_update_errors_match_jax(case):
    preds, target = _update_error_cases()[case]

    def port():
        conv = (lambda d: {k: t(v) if isinstance(v, np.ndarray) else v for k, v in d.items()})  # noqa: E731
        p_, t_ = (conv(preds), conv(target)) if isinstance(preds, dict) else ([conv(d) for d in preds],
                                                                              [conv(d) for d in target])
        td.MeanAveragePrecision(device="cpu").update(p_, t_)

    _raises_like(lambda: jd.MeanAveragePrecision().update(preds, target), port)


def test_segm_spatial_size_mismatch_matches_jax():
    preds = [{"masks": np.ones((1, 4, 4), bool), "scores": np.array([0.5], np.float32), "labels": np.array([0])}]
    target = [{"masks": np.ones((1, 5, 4), bool), "labels": np.array([0])}]
    _raises_like(lambda: run_jax([(preds, target)], iou_type="segm"),
                 lambda: run_port([(preds, target)], iou_type="segm"))


# -------------------------------------------------- state carry-over and sync


def test_load_jax_state_of_list_states():
    preds, target = jcr._ragged_dataset(11, n_images=6)
    jm = jd.MeanAveragePrecision(class_metrics=True)
    jm.update(preds, target)
    packed = jcr._consolidate(preds, target)
    jm.update(*packed)
    jm.persistent(True)
    tm = load_jax_state(td.MeanAveragePrecision(class_metrics=True, device="cpu"), jm.state_dict())
    assert len(tm.detections) == len(preds) + 1
    assert_results_close(tm.compute(), jm.compute())


def test_cpu_compute_launches_no_kernel():
    preds, target = jcr._ragged_dataset(0)
    before = greedy_match_cuda.launches
    run_port([(preds, target)])
    run_port([tuple({k: np.asarray(v) for k, v in d.items()} for d in jcr._consolidate(preds, target))])
    assert greedy_match_cuda.launches == before


def _spawn(world: int, tmp_path, seed: int) -> list:
    store, results = str(tmp_path / "store"), str(tmp_path / "results")
    ctx = mp.start_processes(ranks.rank_main, args=(world, store, results, seed), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                pytest.fail(f"the {world}-rank gloo group did not finish within {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [torch.load(f"{results}.{r}.pt", weights_only=False) for r in range(world)]


def test_two_gloo_ranks_match_one_run_on_the_union(tmp_path):
    world, seed, n = 2, 5, ranks.IMAGES_PER_RANK
    got = _spawn(world, tmp_path, seed)
    preds, target = ranks.make_images(seed, world * n)
    # list states come back interleaved: image i of every rank, then image i + 1
    order = [r * n + i for i in range(n) for r in range(world)]
    want_list = run_jax([([preds[i] for i in order], [target[i] for i in order])], class_metrics=True)
    packed = [ranks.consolidate(preds[r * n:(r + 1) * n], target[r * n:(r + 1) * n]) for r in range(world)]
    want_packed = run_jax(packed, class_metrics=True)
    # IoU and PQ against the port's own single-process run on the union (both are held
    # against the JAX package in tests/test_torch_detection.py and test_torch_panoptic.py)
    tiou = td.IntersectionOverUnion(class_metrics=True, device="cpu")
    tiou.update(tlist([preds[i] for i in order]), tlist([target[i] for i in order]))
    want_iou = tiou.compute()
    pq_p, pq_t = ranks.make_panoptic(seed, world * n)
    want_pq = td.PanopticQuality(things=ranks.THINGS, stuffs=ranks.STUFFS, device="cpu")(t(pq_p), t(pq_t))
    for rank, result in enumerate(got):
        assert_results_close(result["map_list"], want_list)
        assert_results_close(result["map_consolidated"], want_packed)
        assert_results_close(result["map_consolidated"], want_list)
        assert sorted(result["iou"]) == sorted(want_iou)
        for key in want_iou:
            np.testing.assert_allclose(float(result["iou"][key]), float(want_iou[key]), rtol=0, atol=ATOL)
        np.testing.assert_allclose(float(result["pq"]), float(want_pq), rtol=0, atol=ATOL)
        local = td.PanopticQuality(things=ranks.THINGS, stuffs=ranks.STUFFS, device="cpu")
        local.update(t(pq_p[rank * n:(rank + 1) * n]), t(pq_t[rank * n:(rank + 1) * n]))
        for mine, theirs in zip(result["pq_counts"], (local.true_positives, local.false_positives,
                                                      local.false_negatives)):
            assert torch.equal(mine, theirs)
