"""Amodal evaluation protocol (COCO-style AP/AR over amodal regions).

Re-implementation of the reference's forked evaluator
(``evaluate/amodalevalCOCOA.py`` /
``amodalevalD2SA.py`` — which differ only in where the GT depth ``order``
lives: ``region['order']`` vs ``region['amodal_region']['order']``, lines
286/302) and the 12-way results sweep (``modal/Functions.py:897-1007``).

Semantics preserved:

- GT is region-based: one annotation per image with ``regions[]``; matching
  is greedy per IoU threshold, ignore-last, with the matched GT's depth
  ``order`` recorded in ``dtMatches`` (order-fidelity embedded in matches);
- ``useAmodalGT`` selects amodal vs visible GT masks, ``useAmodalDT``
  selects ``amodal_mask`` vs ``segmentation`` on detections;
- region filters: ``onlyThings`` ∈ {0 both, 1 things, 2 stuff} and
  ``occRng`` occlusion-rate window mark GT ignore;
- accumulation: COCO PR curves — 10 IoU thresholds .5:.05:.95, 101 recall
  points, mergesort score ordering; stats[0..5] = AP, AP50, AP75,
  AR@1/10/100.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

from . import rle as rle_api


class Params:
    """Evaluation parameters (reference Params, amodalevalCOCOA.py:486-506)."""

    def __init__(self):
        self.img_ids: List[int] = []
        self.cat_ids: List[int] = [1]
        self.iou_thrs = np.linspace(0.5, 0.95, 10, endpoint=True)
        self.rec_thrs = np.linspace(0.0, 1.00, 101, endpoint=True)
        self.max_dets = [1, 10, 100]
        self.area_rng = [[0, 1e5 ** 2]]
        self.use_segm = True
        self.use_amodal_gt = True
        self.use_amodal_dt = True
        self.only_things = 0   # 0 both | 1 things | 2 stuff
        self.occ_rng = [0, 1]


def _region_rle(region: dict, h: int, w: int, key: str = "segmentation"):
    seg = region[key]
    if isinstance(seg, list):
        rles = rle_api.frPyObjects([seg] if not isinstance(seg[0], list) else seg, h, w)
        if isinstance(rles, dict):
            return rles
        return rles[0] if len(rles) == 1 else rle_api.merge(rles)
    seg = dict(seg)
    if isinstance(seg.get("counts"), str):
        seg["counts"] = seg["counts"].encode()
    if isinstance(seg.get("counts"), list):
        return rle_api.frPyObjects(seg, h, w)
    return seg


class AmodalEval:
    """Evaluator over (AmodalCoco GT, DetectionResults DT)."""

    def __init__(self, amodal_gt=None, amodal_dt=None, limit: int = -1,
                 order_key: str = "order"):
        """order_key: 'order' (COCOA) or 'amodal_region.order' (D2SA)."""
        self.gt = amodal_gt
        self.dt = amodal_dt
        self.params = Params()
        self.order_key = order_key
        self.eval_imgs: List[Optional[dict]] = []
        self.eval: Dict = {}
        self.stats = np.zeros((6,))
        self.ious: Dict = {}
        if amodal_gt is not None:
            ids = amodal_gt.get_img_ids()
            self.params.img_ids = ids[:limit] if limit and limit > 0 else ids

    # ------------------------------------------------------------ helpers --

    def _order_of(self, region: dict):
        if self.order_key == "amodal_region.order":
            return region["amodal_region"]["order"]
        return region[self.order_key]

    def _gt_regions(self, img_id: int) -> List[dict]:
        anns = self.gt.img_to_anns.get(img_id, [])
        if not anns:
            return []
        return anns[0].get("regions", [])

    def _dts(self, img_id: int) -> List[dict]:
        ids = self.dt.get_ann_ids([img_id])
        return self.dt.load_anns(ids)

    # --------------------------------------------------------------- main --

    def compute_iou(self, img_id: int) -> np.ndarray:
        p = self.params
        gt = self._gt_regions(img_id)
        dt = sorted(self._dts(img_id), key=lambda x: -x["score"])[: p.max_dets[-1]]
        if not gt or not dt:
            return np.zeros((0, 0))
        img = self.gt.imgs[img_id]
        h, w = img["height"], img["width"]
        if p.use_amodal_gt:
            g = [_region_rle(r, h, w, "segmentation") for r in gt]
        else:
            g = [
                _region_rle(r, h, w, "visible_mask" if "visible_mask" in r else "segmentation")
                for r in gt
            ]
        if p.use_amodal_dt:
            d = [
                dict(x.get("amodal_mask", x["segmentation"])) if isinstance(
                    x.get("amodal_mask", x["segmentation"]), dict
                ) else x["segmentation"]
                for x in dt
            ]
        else:
            d = [x["segmentation"] for x in dt]
        d = [
            {**r, "counts": r["counts"].encode() if isinstance(r["counts"], str) else r["counts"]}
            for r in d
        ]
        return rle_api.iou(d, g, [0] * len(gt))  # [D, G]

    def evaluate(self) -> None:
        p = self.params
        # IoU matrices depend only on the mask-selection params, not on the
        # only_things/occ_rng slice — cache them so the 12-way sweep doesn't
        # redo the dominant RLE work 12x.
        cache_key = (p.use_amodal_gt, p.use_amodal_dt, p.use_segm,
                     tuple(p.max_dets), tuple(p.img_ids))
        if getattr(self, "_iou_cache_key", None) != cache_key:
            self.ious = {img_id: self.compute_iou(img_id) for img_id in p.img_ids}
            self._iou_cache_key = cache_key
        self.eval_imgs = [
            self.evaluate_img(img_id, p.area_rng[0], p.max_dets[-1], p.occ_rng)
            for img_id in p.img_ids
        ]
        self._params_eval = copy.deepcopy(p)

    def evaluate_img(self, img_id: int, area_rng, max_det: int, occ_rng):
        p = self.params
        gt = self._gt_regions(img_id)
        dt = self._dts(img_id)
        if not gt or not dt:
            return None

        gt_ignore = []
        for g in gt:
            ig = 0
            if p.only_things == 1 and g.get("isStuff", 0) == 1:
                ig = 1
            if p.only_things == 2 and g.get("isStuff", 0) == 0:
                ig = 1
            rate = g.get("occlude_rate", 0.0)
            if rate < occ_rng[0] or rate > occ_rng[1]:
                ig = 1
            gt_ignore.append(ig)

        # sort GT ignore-last (stable), detections by score
        gt_order = sorted(range(len(gt)), key=lambda i: gt_ignore[i])
        inv_gt_order = np.argsort(gt_order)
        gt_sorted = [gt[i] for i in gt_order]
        gt_ig = np.asarray([gt_ignore[i] for i in gt_order])
        dt_sorted = sorted(dt, key=lambda x: -x["score"])[:max_det]

        ious_full = self.ious[img_id]
        ious = (
            ious_full[:max_det, np.asarray(gt_order)]
            if ious_full.size
            else ious_full
        )

        t_n = len(p.iou_thrs)
        g_n, d_n = len(gt_sorted), len(dt_sorted)
        gtm = np.zeros((t_n, g_n))
        dtm = np.zeros((t_n, d_n))
        dt_ig = np.zeros((t_n, d_n))

        if ious.size:
            for ti, t in enumerate(p.iou_thrs):
                for di, d in enumerate(dt_sorted):
                    best_iou = min(t, 1 - 1e-10)
                    match = -1
                    for gi in range(g_n):
                        if gtm[ti, gi] > 0:
                            continue
                        if match > -1 and gt_ig[match] == 0 and gt_ig[gi] == 1:
                            break  # remaining GTs are all ignored
                        if ious[di, gi] < best_iou:
                            continue
                        best_iou = ious[di, gi]
                        match = gi
                    if match == -1:
                        continue
                    dt_ig[ti, di] = gt_ig[match]
                    dtm[ti, di] = self._order_of(gt_sorted[match])
                    gtm[ti, match] = d["id"]

        gtm = gtm[:, inv_gt_order]
        # unmatched detections outside the area range are ignored
        a = np.asarray(
            [d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dt_sorted]
        ).reshape(1, d_n)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, np.repeat(a, t_n, 0)))

        return {
            "image_id": img_id,
            "max_det": max_det,
            "dt_ids": [d["id"] for d in dt_sorted],
            "gt_orders": [self._order_of(g) for g in gt_sorted],
            "dt_matches": dtm,
            "gt_matches": gtm,
            "dt_scores": [d["score"] for d in dt_sorted],
            "gt_ignore": gt_ig,
            "dt_ignore": dt_ig,
        }

    def export_dt_matches(self, path: Optional[str] = None):
        """Per-image GT→DT match table from the last evaluate() — the
        reference's ``exportDtFile`` capability (amodalevalCOCOA.py:202-214),
        as JSON-serializable dicts."""
        if not self.eval_imgs:
            raise RuntimeError("run evaluate() first")
        rows = []
        for e in self.eval_imgs:
            if e is None:
                continue
            rows.append(
                {
                    "image_id": e["image_id"],
                    "dt_ids": e["dt_ids"],
                    "gt_orders": e["gt_orders"],
                    "gt_matches": np.asarray(e["gt_matches"]).tolist(),
                    "dt_matches": np.asarray(e["dt_matches"]).tolist(),
                    "dt_scores": e["dt_scores"],
                }
            )
        if path is not None:
            import json

            with open(path, "w") as f:
                json.dump(rows, f)
        return rows

    def accumulate(self) -> None:
        p = self._params_eval
        t_n = len(p.iou_thrs)
        r_n = len(p.rec_thrs)
        m_n = len(p.max_dets)
        precision = -np.ones((t_n, r_n, 1, 1, m_n))
        recall = -np.ones((t_n, 1, 1, m_n))
        scores = -np.ones((t_n, r_n, 1, 1, m_n))

        entries = [e for e in self.eval_imgs if e is not None]
        for mi, max_det in enumerate(p.max_dets):
            if not entries:
                continue
            dt_scores = np.concatenate([
                np.asarray(e["dt_scores"][:max_det]) for e in entries
            ])
            order = np.argsort(-dt_scores, kind="mergesort")
            dt_scores_sorted = dt_scores[order]
            dtm = np.concatenate(
                [e["dt_matches"][:, :max_det] for e in entries], axis=1
            )[:, order]
            dt_ig = np.concatenate(
                [e["dt_ignore"][:, :max_det] for e in entries], axis=1
            )[:, order]
            gt_ig = np.concatenate([e["gt_ignore"] for e in entries])
            n_pos = np.count_nonzero(gt_ig == 0)
            if n_pos == 0:
                continue
            tps = np.logical_and(dtm, np.logical_not(dt_ig))
            fps = np.logical_and(np.logical_not(dtm), np.logical_not(dt_ig))
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                nd = len(tp)
                rc = tp / n_pos
                pr = tp / (fp + tp + np.spacing(1))
                recall[ti, 0, 0, mi] = rc[-1] if nd else 0
                pr = pr.tolist()
                for i in range(nd - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                q = np.zeros((r_n,))
                ss = np.zeros((r_n,))
                inds = np.searchsorted(rc, p.rec_thrs, side="left")
                for ri, pi in enumerate(inds):
                    if pi < nd:
                        q[ri] = pr[pi]
                        ss[ri] = dt_scores_sorted[pi]
                precision[ti, :, 0, 0, mi] = q
                scores[ti, :, 0, 0, mi] = ss

        self.eval = {
            "counts": [t_n, r_n, 1, 1, m_n],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    def summarize(self) -> np.ndarray:
        p = self.params

        def _summ(ap: bool, iou_thr=None, max_dets=100):
            mi = [i for i, m in enumerate(p.max_dets) if m == max_dets]
            if ap:
                s = self.eval["precision"]
                if iou_thr is not None:
                    s = s[np.where(np.isclose(p.iou_thrs, iou_thr))[0]]
                s = s[:, :, :, 0, mi]
            else:
                s = self.eval["recall"]
                s = s[:, :, 0, mi]
            valid = s[s > -1]
            return float(np.mean(valid)) if valid.size else -1.0

        max_prop = p.max_dets[-1]
        self.stats = np.array(
            [
                _summ(True, max_dets=max_prop),
                _summ(True, iou_thr=0.5, max_dets=max_prop),
                _summ(True, iou_thr=0.75, max_dets=max_prop),
                _summ(False, max_dets=1),
                _summ(False, max_dets=10),
                _summ(False, max_dets=100),
            ]
        )
        return self.stats

    def run(self) -> np.ndarray:
        self.evaluate()
        self.accumulate()
        return self.summarize()


# ----------------------------------------------------------------- sweep ---

SWEEP_OCC = {
    "all": [0, 1000],
    "none": [0, 0.00001],
    "partial": [0.00001, 0.25],
    "heavy": [0.25, 1],
}
SWEEP_THINGS = {"both": 0, "things": 1, "stuff": 2}
STAT_NAMES = ("AP", "AP50", "AP75", "AR@1", "AR@10", "AR@100")


def print_stats(stats: np.ndarray) -> None:
    fmt = " {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ] = {:0.3f}"
    rows = [
        ("Average Precision", "(AP)", "0.50:0.95", 100, stats[0]),
        ("Average Precision", "(AP)", "0.50", 100, stats[1]),
        ("Average Precision", "(AP)", "0.75", 100, stats[2]),
        ("Average Recall", "(AR)", "0.50:0.95", 1, stats[3]),
        ("Average Recall", "(AR)", "0.50:0.95", 10, stats[4]),
        ("Average Recall", "(AR)", "0.50:0.95", 100, stats[5]),
    ]
    for title, kind, iou, md, v in rows:
        print(fmt.format(title, kind, iou, "all", md, v))


def evaluate_sweep(ev: AmodalEval, verbose: bool = True) -> Dict[str, np.ndarray]:
    """The reference's 12-way {both, things, stuff} × occlusion sweep
    (``print_result``, Functions.py:919-1007). Returns {slice: stats[6]}."""
    results: Dict[str, np.ndarray] = {}
    for tname, tval in SWEEP_THINGS.items():
        if verbose:
            print(f"######################### {tname} #################\n")
        for oname, orng in SWEEP_OCC.items():
            ev.params.only_things = tval
            ev.params.occ_rng = orng
            stats = ev.run()
            results[f"{tname}/{oname}"] = stats
            if verbose:
                print_stats(stats)
    return results
