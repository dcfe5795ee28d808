"""The detection slice on the card: the greedy-match kernel against its plain version,
and the card against the port's CPU run.

Every test here needs a CUDA card: each is marked ``cuda`` and skips elsewhere. The
file imports neither JAX nor metrics_tpu, so that it runs on a machine with the card
alone:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_detection_card.py

Tolerances: the kernel's ``det_matched``, ``det_ignored`` and ``npig`` bit-equal to the
plain version on the same CUDA inputs; mAP results within 1e-6 of the CPU run (the
device path divides in float32 in another order of launches, the host path is
float64 numpy in both); box IoU, GIoU and DIoU bit-equal to the CPU, CIoU within
2.4e-7 (CUDA's ``atanf`` against the CPU's); panoptic counts bit-equal, PQ within 1e-12.
"""
import numpy as np
import pytest
import torch

from metrics_tpu_torch import detection as td
from metrics_tpu_torch.functional import detection as tfd
from metrics_tpu_torch.ops import histogram
from metrics_tpu_torch.ops.greedy_match import KERNEL_MAX_G, _plain_greedy_match, greedy_match_cuda

THRESHOLDS = np.linspace(0.5, 0.95, 10).astype(np.float32)
AREAS = np.array([[0, 1e10], [0, 32**2], [32**2, 96**2], [96**2, 1e10]], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def match_inputs(seed, n, d, g, invalid=0.2, thresholds=THRESHOLDS):
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
        dv[1] = False
        gv[2] = False
    return [torch.from_numpy(x) for x in (iou, d_area, g_area, dv, gv, np.asarray(thresholds, np.float32), AREAS)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 16, 16), (64, 128, 32), (3, 1, 1), (7, 1, 9), (5, 9, 1), (9, 20, 1024),
                                   (2, 8, KERNEL_MAX_G), (33, 13, 40)], ids=lambda s: "x".join(map(str, s)))
def test_kernel_bit_equal_to_plain_on_card(cuda, shape):
    args = [x.to(cuda) for x in match_inputs(sum(shape), *shape)]
    before = greedy_match_cuda.launches
    got = greedy_match_cuda(*args)
    torch.cuda.synchronize()
    assert greedy_match_cuda.launches == before + 1
    for name, g, w in zip(("det_matched", "det_ignored", "npig"), got, _plain_greedy_match(*args)):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
def test_kernel_edge_thresholds_and_nan_on_card(cuda):
    args = match_inputs(1, 6, 9, 12, thresholds=[-0.1, 0.0, 0.5, 0.75, 1.0])
    args[0][0, 0, :3] = float("nan")
    args[0][3, 2, 5] = float("nan")
    args = [x.to(cuda) for x in args]
    for g, w in zip(greedy_match_cuda(*args), _plain_greedy_match(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    args = [x.to(cuda) for x in match_inputs(0, 2, 3, KERNEL_MAX_G + 1)]
    with pytest.raises(ValueError, match="ground truths per group"):
        greedy_match_cuda(*args)
    args = [x.to(cuda) for x in match_inputs(0, 2, 3, 4)]
    with pytest.raises(ValueError, match="d_area must be torch.float32"):
        greedy_match_cuda(args[0], args[1].double(), *args[2:])


def images(seed, n=12, num_classes=4):
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(n):
        ng, nd = rng.randint(0, 8), (20 if i == 0 else rng.randint(0, 24))
        gt = np.round(rng.rand(ng, 4) * 200).astype(np.float32)
        gt[:, 2:] += gt[:, :2] + 4
        det = np.round(rng.rand(nd, 4) * 200).astype(np.float32)
        det[:, 2:] += det[:, :2] + 4
        k = min(ng, nd)
        det[:k] = gt[:k] + np.round(rng.randn(k, 4) * 3).astype(np.float32)
        det[:k, 2:] = np.maximum(det[:k, 2:], det[:k, :2] + 1)
        scores = rng.rand(nd).astype(np.float32)
        scores[: nd // 2] = np.round(scores[: nd // 2], 1)  # ties
        preds.append({"boxes": det, "scores": scores, "labels": rng.randint(0, num_classes, nd)})
        target.append({"boxes": gt, "labels": rng.randint(0, num_classes, ng)})
    return preds, target


def packed(preds, target):
    md = max(max(p["boxes"].shape[0] for p in preds), 1)
    mg = max(max(x["boxes"].shape[0] for x in target), 1)
    b = len(preds)
    pb, ps, pl = np.zeros((b, md, 4), np.float32), np.full((b, md), -np.inf, np.float32), np.full((b, md), -1)
    tb, tl = np.zeros((b, mg, 4), np.float32), np.full((b, mg), -1)
    for i, (p, x) in enumerate(zip(preds, target)):
        n = p["boxes"].shape[0]
        pb[i, :n], ps[i, :n], pl[i, :n] = p["boxes"], p["scores"], p["labels"]
        n = x["boxes"].shape[0]
        tb[i, :n], tl[i, :n] = x["boxes"], x["labels"]
    return {"boxes": pb, "scores": ps, "labels": pl}, {"boxes": tb, "labels": tl}


def run(device, updates, **kwargs):
    metric = td.MeanAveragePrecision(class_metrics=True, **kwargs, device=device)
    def on(d):
        return {k: v if isinstance(v, list) else torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}

    for preds, target in updates:
        if isinstance(preds, dict):
            metric.update(on(preds), on(target))
        else:
            metric.update([on(d) for d in preds], [on(d) for d in target])
    before = greedy_match_cuda.launches
    result = metric.compute()
    return {k: v.cpu() for k, v in result.items()}, greedy_match_cuda.launches - before


def assert_close(got, want, atol=1e-6):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].double().numpy(), want[key].double().numpy(), rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["list", "consolidated"])
def test_map_on_card_matches_cpu_with_its_launches(cuda, layout):
    preds, target = images(3)
    # one (image, class) group of 20 detections: the big bucket of the device path
    preds[0]["labels"][:] = 0
    updates = [packed(preds[:6], target[:6]), packed(preds[6:], target[6:])] if layout == "consolidated" else [
        (preds[:6], target[:6]), (preds[6:], target[6:])]
    want, cpu_launches = run("cpu", updates)
    got, launches = run(cuda, updates)
    assert cpu_launches == 0
    assert launches == (2 if layout == "consolidated" else 1)
    assert_close(got, want)


@pytest.mark.cuda
def test_segm_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(4)
    preds, target = [], []
    for _ in range(4):
        nd, ng = rng.randint(1, 6), rng.randint(1, 4)
        dm = rng.rand(nd, 40, 48) < 0.3
        gm = rng.rand(ng, 40, 48) < 0.3
        dm[: min(nd, ng)] |= gm[: min(nd, ng)]
        preds.append({"masks": dm, "scores": rng.rand(nd).astype(np.float32), "labels": rng.randint(0, 2, nd)})
        target.append({"masks": gm, "labels": rng.randint(0, 2, ng)})
    want, _ = run("cpu", [(preds, target)], iou_type="segm")
    got, launches = run(cuda, [(preds, target)], iou_type="segm")
    assert launches == 1
    assert_close(got, want)


@pytest.mark.cuda
def test_box_family_and_iou_classes_on_card_match_cpu(cuda):
    rng = np.random.RandomState(2)
    p = np.round(rng.rand(30, 4) * 100).astype(np.float32)
    p[:, 2:] += p[:, :2] + 2
    g = np.round(rng.rand(20, 4) * 100).astype(np.float32)
    g[:, 2:] += g[:, :2] + 2
    for name in ("box_iou", "generalized_box_iou", "distance_box_iou", "complete_box_iou"):
        got = getattr(tfd, name)(torch.from_numpy(p).to(cuda), torch.from_numpy(g).to(cuda)).cpu()
        want = getattr(tfd, name)(torch.from_numpy(p), torch.from_numpy(g))
        atol = 2.4e-7 if name == "complete_box_iou" else 0.0
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
    preds, target = images(5, n=5)
    for cls in td.__all__:
        if "IntersectionOverUnion" not in cls:
            continue
        values = []
        for device in (cuda, "cpu"):
            metric = getattr(td, cls)(class_metrics=True, device=device)
            on = lambda d: {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}  # noqa: E731
            metric.update([on(d) for d in preds], [on(d) for d in target])
            values.append({k: v.cpu() for k, v in metric.compute().items()})
        assert_close(values[0], values[1], atol=2.4e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_panoptic_on_card_matches_cpu_through_the_histogram(cuda, cls):
    rng = np.random.RandomState(6)
    cats = np.array([0, 1, 6, 7, 9])
    target = np.stack([cats[rng.randint(0, 5, (3, 16, 16))], rng.randint(0, 4, (3, 16, 16))], -1)
    preds = np.where((rng.rand(3, 16, 16) < 0.7)[..., None], target,
                     np.stack([cats[rng.randint(0, 4, (3, 16, 16))], rng.randint(0, 4, (3, 16, 16))], -1))
    metrics = {}
    before = histogram.histogram_cuda.launches
    for device in (cuda, "cpu"):
        metric = getattr(td, cls)(things={0, 1}, stuffs={6, 7}, allow_unknown_preds_category=True, device=device)
        metric.update(torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device))
        metrics[str(device)] = metric
    assert histogram.histogram_cuda.launches == before + 3  # one count-mode launch per sample
    card, cpu = metrics[str(cuda)], metrics["cpu"]
    for state in ("true_positives", "false_positives", "false_negatives"):
        assert torch.equal(getattr(card, state).cpu(), getattr(cpu, state)), state
    torch.testing.assert_close(card.iou_sum.cpu(), cpu.iou_sum, rtol=0, atol=1e-12)
    torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=0, atol=1e-12)
