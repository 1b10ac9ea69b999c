"""COCO-compatible RLE mask API (the role of ``pycocotools.mask``).

A thin layer over the native C++ library (``native/rle.cpp``, built at first
use by ``native/build.py``); a build failure raises. The format is the
standard COCO one: ``{'size': [h, w], 'counts': bytes}`` with the 6-bit
LEB128-style string codec; masks are column-major, runs alternate 0s/1s
starting with zeros. Evaluation IoU is computed on the runs, as in the
reference's vendored ``cocoapi``.

The functions ending in ``_plain`` are straightforward numpy/Python versions
of the same semantics. The main path never calls them; the tests hold the
native library against them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Union

import numpy as np

from ..native.build import load_library

RLEDict = Dict[str, object]


def _u32(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _cat(counts_list) -> tuple:
    """Concatenated uint32 runs + int32 run lengths, for the batched calls."""
    cat = np.ascontiguousarray(np.concatenate(counts_list).astype(np.uint32))
    ms = np.asarray([len(c) for c in counts_list], np.int32)
    return cat, ms


def _flat_f(mask_f: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(mask_f, dtype=np.uint8, order="F").reshape(-1, order="F"))


# ------------------------------------------------------------- raw counts ---

def encode_counts(mask_f: np.ndarray) -> np.ndarray:
    """Column-major uint8 [h, w] mask -> uint32 run counts."""
    h, w = mask_f.shape
    out = np.empty(h * w + 1, np.uint32)
    m = load_library().sln_rle_encode(
        _ptr(_flat_f(mask_f), ctypes.c_uint8), h, w, _ptr(out, ctypes.c_uint32))
    return out[:m].copy()


def encode_counts_plain(mask_f: np.ndarray) -> np.ndarray:
    flat = _flat_f(mask_f)
    if flat.size == 0:
        return np.zeros(1, np.uint32)
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    counts = np.diff(np.concatenate([[0], changes, [flat.size]]))
    if flat[0] != 0:
        counts = np.concatenate([[0], counts])
    return counts.astype(np.uint32)


def _check_paste(crop, y1, x1, H, W) -> np.ndarray:
    crop = np.ascontiguousarray(crop, np.uint8)
    h, w = crop.shape
    if not (0 <= y1 and 0 <= x1 and y1 + h <= H and x1 + w <= W):
        raise ValueError(f"crop {h}x{w} at ({y1}, {x1}) outside the {H}x{W} frame")
    return crop


def encode_pasted_counts(crop: np.ndarray, y1: int, x1: int,
                         H: int, W: int) -> np.ndarray:
    """Run counts of an [H, W] frame equal to the binary row-major ``crop``
    pasted at (y1, x1) into zeros, without building the frame (O(box area);
    equal to ``encode_counts`` of the pasted frame)."""
    crop = _check_paste(crop, y1, x1, H, W)
    h, w = crop.shape
    # per frame column: <= h crop runs + 2 zero pads; +2 outer, +1 final
    out = np.empty(w * (h + 2) + 3, np.uint32)
    m = load_library().sln_rle_encode_pasted(
        _ptr(crop, ctypes.c_uint8), h, w, int(y1), int(x1), int(H), int(W),
        _ptr(out, ctypes.c_uint32))
    return out[:m].copy()


def encode_pasted_counts_plain(crop, y1, x1, H, W) -> np.ndarray:
    crop = _check_paste(crop, y1, x1, H, W)
    full = np.zeros((H, W), np.uint8)
    full[y1:y1 + crop.shape[0], x1:x1 + crop.shape[1]] = crop
    return encode_counts_plain(full)


def decode_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Run counts -> column-major uint8 [h, w] mask."""
    counts = _u32(counts)
    out = np.empty(h * w, np.uint8)
    load_library().sln_rle_decode(
        _ptr(counts, ctypes.c_uint32), len(counts), _ptr(out, ctypes.c_uint8), h * w)
    return out.reshape((h, w), order="F")


def decode_counts_plain(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    counts = _u32(counts)
    size = h * w
    out = np.repeat((np.arange(len(counts)) % 2).astype(np.uint8), counts)
    if out.size < size:
        out = np.concatenate([out, np.zeros(size - out.size, np.uint8)])
    return out[:size].reshape((h, w), order="F")


def counts_to_string(counts: np.ndarray) -> bytes:
    counts = _u32(counts)
    # a count or delta below 2^32 in magnitude takes at most 7 six-bit chars
    buf = ctypes.create_string_buffer(7 * max(len(counts), 1) + 1)
    n = load_library().sln_rle_to_string(_ptr(counts, ctypes.c_uint32), len(counts), buf)
    return buf.raw[:n]


def counts_to_string_plain(counts: np.ndarray) -> bytes:
    counts = _u32(counts)
    s = bytearray()
    for i in range(len(counts)):
        x = int(counts[i])
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(c + 48)
    return bytes(s)


def string_to_counts(s: Union[str, bytes]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    out = np.empty(len(s) + 1, np.uint32)
    m = load_library().sln_rle_from_string(s, _ptr(out, ctypes.c_uint32))
    return out[:m].copy()


def string_to_counts_plain(s: Union[str, bytes]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    counts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def counts_from_poly(xy: Sequence[float], h: int, w: int) -> np.ndarray:
    xy = np.ascontiguousarray(np.asarray(xy, np.float64).reshape(-1))
    k = len(xy) // 2
    lib = load_library()
    cap = h * w + 8 * k + 16
    out = np.empty(cap, np.uint32)
    m = lib.sln_rle_from_poly(_ptr(xy, ctypes.c_double), k, h, w,
                              _ptr(out, ctypes.c_uint32), cap)
    if m < 0:  # the crossings exceeded the first guess: -m is the exact need
        cap = -m
        out = np.empty(cap, np.uint32)
        m = lib.sln_rle_from_poly(_ptr(xy, ctypes.c_double), k, h, w,
                                  _ptr(out, ctypes.c_uint32), cap)
    return out[:m].copy()


def counts_from_poly_plain(xy: Sequence[float], h: int, w: int) -> np.ndarray:
    """COCO polygon rasterization (5x supersampling, +.5 rounding,
    column-crossing fill)."""
    xy = np.asarray(xy, np.float64).reshape(-1)
    k = len(xy) // 2
    scale = 5.0
    px = [int(scale * xy[2 * j] + 0.5) for j in range(k)] + [int(scale * xy[0] + 0.5)]
    py = [int(scale * xy[2 * j + 1] + 0.5) for j in range(k)] + [int(scale * xy[1] + 0.5)]
    u: List[int] = []
    v: List[int] = []
    for j in range(k):
        xs, xe, ys, ye = px[j], px[j + 1], py[j], py[j + 1]
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            for d in range(dx + 1):
                t = dx - d if flip else d
                u.append(t + xs)
                v.append(int(ys + s * t + 0.5))
        else:
            s = (xe - xs) / dy if dy else 0.0
            for d in range(dy + 1):
                t = dy - d if flip else d
                v.append(t + ys)
                u.append(int(xs + s * t + 0.5))
    a: List[int] = []
    for j in range(1, len(u)):
        if u[j] == u[j - 1]:
            continue
        xd = float(u[j] if u[j] < u[j - 1] else u[j] - 1)
        xd = (xd + 0.5) / scale - 0.5
        if np.floor(xd) != xd or xd < 0 or xd > w - 1:
            continue
        yd = float(v[j] if v[j] < v[j - 1] else v[j - 1])
        yd = (yd + 0.5) / scale - 0.5
        yd = min(max(yd, 0), h)
        a.append(int(xd) * h + int(np.ceil(yd)))
    a.append(h * w)
    a.sort()
    deltas, p = [], 0
    for t in a:
        deltas.append(t - p)
        p = t
    b = [deltas[0]]
    j = 1
    while j < len(deltas):
        if deltas[j] > 0:
            b.append(deltas[j])
            j += 1
        else:
            j += 1
            if j < len(deltas):
                b[-1] += deltas[j]
                j += 1
    return np.asarray(b, np.uint32)


# ----------------------------------------------------------- dict-level API --

def _to_counts(rle: RLEDict) -> np.ndarray:
    c = rle["counts"]
    if isinstance(c, (bytes, str)):
        return string_to_counts(c)
    return _u32(c)


def encode(mask: np.ndarray) -> Union[RLEDict, List[RLEDict]]:
    """uint8 column-major [H, W] or [H, W, N] -> RLE dict(s), string counts."""
    if mask.ndim == 3:
        return [encode(mask[:, :, i]) for i in range(mask.shape[2])]
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": counts_to_string(encode_counts(mask))}


def encode_pasted(crop: np.ndarray, y1: int, x1: int, H: int, W: int) -> RLEDict:
    """RLE dict of ``crop`` pasted at (y1, x1) into an [H, W] zero frame
    (see :func:`encode_pasted_counts`)."""
    return {"size": [int(H), int(W)],
            "counts": counts_to_string(encode_pasted_counts(crop, y1, x1, H, W))}


def decode(rle: Union[RLEDict, List[RLEDict]]) -> np.ndarray:
    if isinstance(rle, list):
        if not rle:
            return np.zeros((0, 0, 0), np.uint8)
        return np.stack([decode(r) for r in rle], axis=2)
    h, w = rle["size"]
    return decode_counts(_to_counts(rle), int(h), int(w))


def area(rle: Union[RLEDict, List[RLEDict]]):
    if isinstance(rle, list):
        return np.asarray([area(r) for r in rle], np.uint32)
    counts = _to_counts(rle)
    return int(load_library().sln_rle_area(_ptr(counts, ctypes.c_uint32), len(counts)))


def area_plain(rle: RLEDict) -> int:
    return int(_to_counts(rle)[1::2].sum())


def merge(rles: List[RLEDict], intersect: bool = False) -> RLEDict:
    if not rles:
        return {"size": [0, 0], "counts": b""}
    h, w = rles[0]["size"]
    cat, ms = _cat([_to_counts(r) for r in rles])
    out = np.empty(h * w + 2, np.uint32)
    m = load_library().sln_rle_merge(
        _ptr(cat, ctypes.c_uint32), _ptr(ms, ctypes.c_int32), len(rles),
        int(intersect), _ptr(out, ctypes.c_uint32))
    return {"size": [int(h), int(w)], "counts": counts_to_string(out[:m])}


def merge_plain(rles: List[RLEDict], intersect: bool = False) -> RLEDict:
    h, w = rles[0]["size"]
    acc = decode_counts_plain(_to_counts(rles[0]), h, w).astype(bool)
    for r in rles[1:]:
        m = decode_counts_plain(_to_counts(r), h, w).astype(bool)
        acc = (acc & m) if intersect else (acc | m)
    return {"size": [int(h), int(w)],
            "counts": counts_to_string_plain(encode_counts_plain(acc.astype(np.uint8)))}


def toBbox(rle: Union[RLEDict, List[RLEDict]]) -> np.ndarray:
    single = not isinstance(rle, list)
    rles = [rle] if single else rle
    if not rles:
        return np.zeros((0, 4), np.float64)
    cat, ms = _cat([_to_counts(r) for r in rles])
    bb = np.empty((len(rles), 4), np.float64)
    load_library().sln_rle_to_bbox(
        _ptr(cat, ctypes.c_uint32), _ptr(ms, ctypes.c_int32), len(rles),
        int(rles[0]["size"][0]), _ptr(bb, ctypes.c_double))
    return bb[0] if single else bb


def to_bbox_plain(rle: RLEDict) -> np.ndarray:
    h, w = rle["size"]
    ys, xs = np.nonzero(decode_counts_plain(_to_counts(rle), int(h), int(w)))
    if len(xs) == 0:
        return np.zeros(4, np.float64)
    return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                       ys.max() - ys.min() + 1], np.float64)


def _is_box_array(objs) -> bool:
    return isinstance(objs, np.ndarray) or (
        len(objs) > 0 and isinstance(objs[0], (list, tuple, np.ndarray))
        and len(objs[0]) == 4 and not isinstance(objs[0], dict))


def _crowd(iscrowd, n_gt) -> np.ndarray:
    return np.asarray([int(c) for c in iscrowd] if len(iscrowd) else [0] * n_gt, np.uint8)


def iou(dt, gt, iscrowd) -> np.ndarray:
    """IoU matrix [len(dt), len(gt)] with the ``pycocotools.mask.iou``
    contract: RLE dicts or xywh box arrays; for a crowd GT the union is the
    detection's own area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    crowd = _crowd(iscrowd, len(gt))
    lib = load_library()
    out = np.empty((len(gt), len(dt)), np.float64)
    if _is_box_array(dt) and _is_box_array(gt):
        dtb = np.ascontiguousarray(np.asarray(dt, np.float64))
        gtb = np.ascontiguousarray(np.asarray(gt, np.float64))
        lib.sln_bb_iou(_ptr(dtb, ctypes.c_double), _ptr(gtb, ctypes.c_double),
                       len(dt), len(gt), _ptr(crowd, ctypes.c_uint8),
                       _ptr(out, ctypes.c_double))
        return out.T
    dcat, dms = _cat([_to_counts(r) for r in dt])
    gcat, gms = _cat([_to_counts(r) for r in gt])
    lib.sln_rle_iou(
        _ptr(dcat, ctypes.c_uint32), _ptr(dms, ctypes.c_int32), len(dt),
        _ptr(gcat, ctypes.c_uint32), _ptr(gms, ctypes.c_int32), len(gt),
        int(dt[0]["size"][0]), _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double))
    return out.T


def _bb_iou_one(d, g, crowd) -> float:
    da, ga = d[2] * d[3], g[2] * g[3]
    w = min(d[2] + d[0], g[2] + g[0]) - max(d[0], g[0])
    if w <= 0:
        return 0.0
    h = min(d[3] + d[1], g[3] + g[1]) - max(d[1], g[1])
    if h <= 0:
        return 0.0
    i = w * h
    return i / (da if crowd else da + ga - i)


def iou_plain(dt, gt, iscrowd) -> np.ndarray:
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    crowd = _crowd(iscrowd, len(gt))
    out = np.empty((len(dt), len(gt)), np.float64)
    if _is_box_array(dt) and _is_box_array(gt):
        dtb, gtb = np.asarray(dt, np.float64), np.asarray(gt, np.float64)
        for d in range(len(dt)):
            for g in range(len(gt)):
                out[d, g] = _bb_iou_one(dtb[d], gtb[g], crowd[g])
        return out

    def masks(rles):
        return [decode_counts_plain(_to_counts(r), *map(int, r["size"])).astype(bool)
                for r in rles]

    dms, gms = masks(dt), masks(gt)
    for d in range(len(dt)):
        for g in range(len(gt)):
            inter = np.logical_and(dms[d], gms[g]).sum()
            union = dms[d].sum() if crowd[g] else np.logical_or(dms[d], gms[g]).sum()
            out[d, g] = inter / union if union else 0.0
    return out


def nms(dt: List[RLEDict], thr: float) -> np.ndarray:
    """Greedy mask NMS with the ``pycocotools`` ``mask.nms`` contract
    (dormant in the reference's live path). Returns uint8 keep flags in the
    given order."""
    n = len(dt)
    if n == 0:
        return np.zeros(0, np.uint8)
    cat, ms = _cat([_to_counts(r) for r in dt])
    keep = np.empty(n, np.uint8)
    load_library().sln_rle_nms(
        _ptr(cat, ctypes.c_uint32), _ptr(ms, ctypes.c_int32), n,
        int(dt[0]["size"][0]), ctypes.c_double(thr), _ptr(keep, ctypes.c_uint8))
    return keep


def nms_plain(dt: List[RLEDict], thr: float) -> np.ndarray:
    n = len(dt)
    keep = np.ones(n, np.uint8)
    for i in range(n):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if keep[j] and float(iou_plain([dt[i]], [dt[j]], [0])[0, 0]) > thr:
                keep[j] = 0
    return keep


def frPyObjects(pyobj, h: int, w: int):
    """Polygons / uncompressed RLE / xywh boxes -> RLE dict(s), with the
    ``pycocotools`` ``frPyObjects`` contract."""
    if isinstance(pyobj, np.ndarray) and pyobj.ndim == 2:
        return [frPyObjects(row, h, w) for row in pyobj.tolist()]
    if isinstance(pyobj, list) and len(pyobj) and isinstance(
            pyobj[0], (list, tuple, np.ndarray, dict)):
        return [frPyObjects(p, h, w) for p in pyobj]
    if isinstance(pyobj, dict):
        counts = pyobj["counts"]
        if isinstance(counts, list):
            return {"size": [h, w], "counts": counts_to_string(_u32(counts))}
        return {"size": pyobj.get("size", [h, w]), "counts": counts}
    arr = np.asarray(pyobj, np.float64).reshape(-1)
    if len(arr) == 4:  # xywh box
        x, y, bw, bh = arr
        arr = np.asarray([x, y, x, y + bh, x + bw, y + bh, x + bw, y])
    return {"size": [h, w], "counts": counts_to_string(counts_from_poly(arr, h, w))}
