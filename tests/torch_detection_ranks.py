"""The rank side of the detection sync test in ``tests/test_torch_map.py``: one process
of a ``gloo`` group.

It imports ``torch``, numpy and ``metrics_tpu_torch`` only (no JAX, nothing of
``metrics_tpu``). Every rank draws the same data from the seed and takes its own
images: rank r of W the images r*N .. (r+1)*N-1. It feeds them to
``MeanAveragePrecision`` in the list layout (one state entry per image) and in the
consolidated layout (one entry per rank), to ``IntersectionOverUnion`` and to
``PanopticQuality``, and saves what ``compute`` gives after the sync. The list
states come back interleaved (image i of every rank, then image i + 1), the
consolidated ones in rank order; the test process builds its single-process oracle
in that order.
"""
import datetime
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

IMAGES_PER_RANK = 4
NUM_CLASSES = 3
THINGS, STUFFS = {0, 1}, {6, 7}


def make_images(seed: int, n: int) -> Tuple[List[Dict[str, np.ndarray]], List[Dict[str, np.ndarray]]]:
    """``n`` images of boxes, with detections that overlap some ground truths."""
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for _ in range(n):
        ng, nd = rng.randint(1, 7), rng.randint(1, 9)
        gt = rng.rand(ng, 4).astype(np.float32) * 80
        gt[:, 2:] += gt[:, :2] + 4
        det = rng.rand(nd, 4).astype(np.float32) * 80
        det[:, 2:] += det[:, :2] + 4
        k = min(ng, nd)
        det[:k] = gt[:k] + rng.randn(k, 4).astype(np.float32) * 2
        preds.append({"boxes": det, "scores": rng.rand(nd).astype(np.float32),
                      "labels": rng.randint(0, NUM_CLASSES, nd)})
        target.append({"boxes": gt, "labels": rng.randint(0, NUM_CLASSES, ng)})
    return preds, target


def make_panoptic(seed: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(n, 6, 6, 2)`` panoptic maps of things {0, 1} and stuffs {6, 7}."""
    rng = np.random.RandomState(seed + 1)
    cats = np.array([0, 1, 6, 7])
    target = np.stack([cats[rng.randint(0, 4, (n, 6, 6))], rng.randint(0, 3, (n, 6, 6))], -1)
    preds = target.copy()
    flip = rng.rand(n, 6, 6) < 0.3
    preds[flip, 0] = cats[rng.randint(0, 4, int(flip.sum()))]
    return preds, target


def consolidate(preds, target):
    """The images as one padded batch (padding rows labelled -1, scored -inf)."""
    md = max(p["boxes"].shape[0] for p in preds)
    mg = max(t["boxes"].shape[0] for t in target)
    b = len(preds)
    pb, ps, pl = np.zeros((b, md, 4), np.float32), np.full((b, md), -np.inf, np.float32), np.full((b, md), -1)
    tb, tl = np.zeros((b, mg, 4), np.float32), np.full((b, mg), -1)
    for i, (p, t) in enumerate(zip(preds, target)):
        n = p["boxes"].shape[0]
        pb[i, :n], ps[i, :n], pl[i, :n] = p["boxes"], p["scores"], p["labels"]
        n = t["boxes"].shape[0]
        tb[i, :n], tl[i, :n] = t["boxes"], t["labels"]
    return {"boxes": pb, "scores": ps, "labels": pl}, {"boxes": tb, "labels": tl}


def run(world: int, rank: int, seed: int) -> dict:
    from metrics_tpu_torch.detection import IntersectionOverUnion, MeanAveragePrecision, PanopticQuality

    preds, target = make_images(seed, world * IMAGES_PER_RANK)
    lo, hi = rank * IMAGES_PER_RANK, (rank + 1) * IMAGES_PER_RANK
    mine_p = [{k: torch.from_numpy(v) for k, v in d.items()} for d in preds[lo:hi]]
    mine_t = [{k: torch.from_numpy(v) for k, v in d.items()} for d in target[lo:hi]]
    out = {}
    listed = MeanAveragePrecision(class_metrics=True, device="cpu")
    listed.update(mine_p, mine_t)
    out["map_list"] = {k: v.clone() for k, v in listed.compute().items()}
    packed = MeanAveragePrecision(class_metrics=True, device="cpu")
    cp, ct = consolidate(preds[lo:hi], target[lo:hi])
    packed.update({k: torch.from_numpy(v) for k, v in cp.items()}, {k: torch.from_numpy(v) for k, v in ct.items()})
    out["map_consolidated"] = {k: v.clone() for k, v in packed.compute().items()}
    iou = IntersectionOverUnion(class_metrics=True, device="cpu")
    iou.update(mine_p, mine_t)
    out["iou"] = {k: v.clone() for k, v in iou.compute().items()}
    pq_p, pq_t = make_panoptic(seed, world * IMAGES_PER_RANK)
    pq = PanopticQuality(things=THINGS, stuffs=STUFFS, device="cpu")
    pq.update(torch.from_numpy(pq_p[lo:hi]), torch.from_numpy(pq_t[lo:hi]))
    out["pq"] = pq.compute().clone()
    out["pq_counts"] = [pq.true_positives.clone(), pq.false_positives.clone(), pq.false_negatives.clone()]
    return out


def rank_main(rank: int, world: int, store: str, results: str, seed: int) -> None:
    """Entry point of one spawned rank: join the group, run, save the results."""
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        torch.save(run(world, rank, seed), f"{results}.{rank}.pt")
    finally:
        dist.destroy_process_group()
