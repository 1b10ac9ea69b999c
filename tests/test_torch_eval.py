"""The port's evaluator (``AmodalEval``, ``evaluate_sweep``), result-dict
builders and proposal recall against the JAX package's, on randomized
region GT and detections. Both sides run the same numpy arithmetic over the
same native RLE code, so every stats vector must be equal (tolerance 0)."""

import copy

import numpy as np
import pytest

from sln_amodal_tpu.data.dataset import AmodalCoco as JaxCoco
from sln_amodal_tpu.data.dataset import DetectionResults as JaxResults
from sln_amodal_tpu.eval_amodal import amodal_eval as jax_eval
from sln_amodal_tpu.eval_amodal import coco_results as jax_results
from sln_amodal_tpu.eval_amodal import recall as jax_recall
from sln_amodal_tpu_torch.data.dataset import AmodalCoco, DetectionResults
from sln_amodal_tpu_torch.eval_amodal import amodal_eval, coco_results, recall, rle

H, W = 48, 56


def blob(rng, y1, x1, h, w):
    m = np.zeros((H, W), np.uint8)
    m[y1:y1 + h, x1:x1 + w] = 1
    m[y1:y1 + h, x1:x1 + w] &= (rng.rand(h, w) < 0.9).astype(np.uint8)
    return m


def rle_str(mask):
    r = rle.encode(np.asfortranarray(mask))
    return {"size": r["size"], "counts": r["counts"].decode()}


def random_box(rng):
    y1, x1 = rng.randint(0, H - 8), rng.randint(0, W - 8)
    return y1, x1, rng.randint(4, H - y1 + 1), rng.randint(4, W - x1 + 1)


# occlusion rates that land in each slice of the sweep, and on its bounds
OCCLUSION = [0.0, 0.000005, 0.1, 0.25, 0.6, 0.00001]


def make_gt_dt(seed, n_images=5):
    rng = np.random.RandomState(seed)
    images, anns, results = [], [], []
    for img_id in range(1, n_images + 1):
        images.append({"id": img_id, "height": H, "width": W, "file_name": f"{img_id}.jpg"})
        regions, gt_masks = [], []
        for k in range(rng.randint(1, 6)):
            y1, x1, h, w = random_box(rng)
            amodal = blob(rng, y1, x1, h, w)
            vis = amodal & (rng.rand(H, W) < 0.8).astype(np.uint8)
            order = int(rng.randint(1, 5))
            region = {"visible_mask": rle_str(vis), "invisible_mask": rle_str(amodal & ~vis),
                      "isStuff": int(rng.rand() < 0.3),
                      "occlude_rate": float(OCCLUSION[rng.randint(len(OCCLUSION))]),
                      "order": order, "amodal_region": {"order": order + 10}}
            if k == 0:   # a polygon region (frPyObjects path)
                region["segmentation"] = [float(v) for v in
                                          (x1, y1, x1 + w, y1, x1 + w, y1 + h, x1, y1 + h)]
            else:
                region["segmentation"] = rle_str(amodal)
            regions.append(region)
            gt_masks.append(amodal)
        anns.append({"id": 100 + img_id, "image_id": img_id, "regions": regions})
        # detections: jittered GT masks, false positives, tied scores
        for m in gt_masks + [blob(rng, *random_box(rng)) for _ in range(rng.randint(0, 4))]:
            jitter = (rng.rand(H, W) < rng.uniform(0.0, 0.5)).astype(np.uint8)
            dt = (m ^ (jitter & np.roll(m, rng.randint(-3, 4), axis=1))).astype(np.uint8)
            res = {"image_id": img_id, "category_id": 1,
                   "bbox": [0.0, 0.0, 1.0, 1.0],
                   "score": float(rng.choice([0.5, 0.9, rng.rand()])),
                   "segmentation": rle.encode(np.asfortranarray(dt))}
            if rng.rand() < 0.3:
                res["amodal_mask"] = rle.encode(np.asfortranarray(m))
            results.append(res)
    return {"images": images, "annotations": anns}, results


def run_both(seed, order_key, use_amodal_gt):
    gt, results = make_gt_dt(seed)
    out = []
    for coco_cls, res_cls, module in ((JaxCoco, JaxResults, jax_eval),
                                      (AmodalCoco, DetectionResults, amodal_eval)):
        ev = module.AmodalEval(coco_cls(dataset=copy.deepcopy(gt)),
                               res_cls(copy.deepcopy(results)), order_key=order_key)
        ev.params.use_amodal_gt = use_amodal_gt
        stats = module.evaluate_sweep(ev, verbose=False)
        out.append((stats, ev.export_dt_matches(), ev.eval))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("order_key", ["order", "amodal_region.order"])
@pytest.mark.parametrize("use_amodal_gt", [True, False])
def test_sweep_equals_jax(seed, order_key, use_amodal_gt):
    (ref, ref_matches, ref_eval), (out, matches, ev) = run_both(seed, order_key, use_amodal_gt)
    assert list(out) == list(ref) and len(out) == 12
    for key in ref:
        assert np.array_equal(out[key], ref[key]), (key, out[key], ref[key])
    assert any((ref[k] > 0).any() for k in ref), "a vacuous comparison"
    # the last slice's matches carry the GT order of the key in use
    assert matches == ref_matches
    for name in ("precision", "recall", "scores"):
        assert np.array_equal(ev[name], ref_eval[name]), name


def test_iou_cache_is_reused_across_the_sweep(monkeypatch):
    gt, results = make_gt_dt(4)
    ev = amodal_eval.AmodalEval(AmodalCoco(dataset=gt), DetectionResults(results))
    calls = []
    compute = ev.compute_iou
    monkeypatch.setattr(ev, "compute_iou", lambda i: calls.append(i) or compute(i))
    amodal_eval.evaluate_sweep(ev, verbose=False)
    assert len(calls) == len(ev.params.img_ids)
    ev.params.use_amodal_dt = False      # another mask selection: recomputed
    ev.run()
    assert len(calls) == 2 * len(ev.params.img_ids)


def test_detection_results_ids_and_area():
    _, results = make_gt_dt(5)
    ref, out = JaxResults(copy.deepcopy(results)), DetectionResults(copy.deepcopy(results))
    assert out.anns.keys() == ref.anns.keys() and out.img_to_anns.keys() == ref.img_to_anns.keys()
    for i, ann in out.anns.items():
        assert ann["id"] == i and ann["area"] == ref.anns[i]["area"]
        assert ann["area"] == float(rle.area(ann["segmentation"]))


@pytest.mark.parametrize("seed", [0, 1])
def test_build_coco_results_equal_jax(seed):
    rng = np.random.RandomState(seed)
    n = 6
    y1, x1 = rng.randint(0, H - 10, n), rng.randint(0, W - 10, n)
    h, w = rng.randint(1, 10, n), rng.randint(1, 10, n)
    y1[0], x1[0], h[0], w[0] = 0, 0, H, W                       # the whole frame
    y1[1], x1[1] = H - h[1], W - w[1]                           # bottom-right corner
    # float rois as the unmold gives them (int32 boxes) and with fractions
    rois = np.stack([y1, x1, y1 + h, x1 + w], 1).astype(np.int32)
    class_ids = np.asarray([1, 1, 0, 2, 1, 1])
    scores = rng.rand(n).astype(np.float32)
    crops = [(rng.rand(h[i], w[i]) < 0.6).astype(np.uint8) for i in range(n)]
    full = np.zeros((H, W, n), np.uint8)
    for i in range(n):
        full[y1[i]:y1[i] + h[i], x1[i]:x1[i] + w[i], i] = crops[i]
    out = coco_results.build_coco_results_crops(7, rois, class_ids, scores, crops, (H, W, 3))
    assert out == jax_results.build_coco_results_crops(7, rois, class_ids, scores, crops, (H, W, 3))
    assert out == coco_results.build_coco_results(7, rois, class_ids, scores, full)
    frac = rois + rng.uniform(-0.3, 0.3, rois.shape)
    assert (coco_results.build_coco_results(7, frac, class_ids, scores, full)
            == jax_results.build_coco_results(7, frac, class_ids, scores, full))
    assert [r["category_id"] for r in out] == [1, 1, 0, 1, 1, 1]
    assert coco_results.build_coco_results_crops(7, np.zeros((0, 4)), [], [], [], (H, W)) == []


@pytest.mark.parametrize("area", ["all", "small", "medium", "large", "96-128"])
@pytest.mark.parametrize("limit", [None, 3])
def test_evaluate_recall_equal_jax(area, limit):
    rng = np.random.RandomState(len(area))

    def boxes(n, scale):
        xy = rng.uniform(0, 300, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(4, scale, (n, 2))], 1)

    props = [boxes(rng.randint(0, 12), 200) for _ in range(4)]
    gts = [boxes(rng.randint(0, 5), 200) for _ in range(4)]
    props[1][:len(gts[1])] = gts[1] + rng.uniform(-3, 3, gts[1].shape)
    ref = jax_recall.evaluate_recall(props, gts, area=area, limit=limit)
    out = recall.evaluate_recall(props, gts, area=area, limit=limit)
    assert out.keys() == ref.keys()
    for key in ref:
        assert np.array_equal(out[key], ref[key]), key
    np.testing.assert_array_equal(recall.bbox_overlaps(props[1], gts[1]),
                                  jax_recall.bbox_overlaps(props[1], gts[1]))
