"""The port's COCO RLE (``sln_amodal_tpu_torch/eval_amodal/rle.py``, native
library built from ``sln_amodal_tpu_torch/native/rle.cpp``) against the JAX
package's ``sln_amodal_tpu.eval_amodal.rle`` and against its own plain
versions. Everything is integer or the same float64 arithmetic: every
comparison is exact."""

import numpy as np
import pytest

from sln_amodal_tpu.eval_amodal import rle as jax_rle
from sln_amodal_tpu_torch.eval_amodal import rle
from sln_amodal_tpu_torch.native import build as native_build

SHAPES = [(37, 23), (1, 1), (64, 64), (5, 200), (200, 3)]


def random_mask(rng, h, w, p):
    return np.asfortranarray((rng.rand(h, w) < p).astype(np.uint8))


def masks(seed, n=6, h=41, w=29):
    rng = np.random.RandomState(seed)
    out = [random_mask(rng, h, w, p) for p in rng.uniform(0.05, 0.9, n)]
    blocks = np.zeros((h, w), np.uint8)
    blocks[5:30, 3:20] = 1
    out += [np.asfortranarray(blocks), np.zeros((h, w), np.uint8, order="F"),
            np.ones((h, w), np.uint8, order="F")]
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.3, 0.97, 1.0])
def test_encode_decode_counts(shape, p):
    m = random_mask(np.random.RandomState(sum(shape)), *shape, p)
    counts = rle.encode_counts(m)
    np.testing.assert_array_equal(counts, rle.encode_counts_plain(m))
    np.testing.assert_array_equal(counts, jax_rle.encode_counts(m))
    np.testing.assert_array_equal(rle.decode_counts(counts, *shape), m)
    np.testing.assert_array_equal(rle.decode_counts_plain(counts, *shape), m)
    d = rle.encode(m)
    assert d == jax_rle.encode(m)
    np.testing.assert_array_equal(rle.decode(d), jax_rle.decode(d))


def test_string_codec():
    rng = np.random.RandomState(3)
    cases = [np.zeros(1, np.uint32), np.asarray([0, 5], np.uint32),
             rng.randint(0, 2 ** 28, 50).astype(np.uint32),      # large, negative deltas
             rng.randint(0, 40, 300).astype(np.uint32)]
    cases += [rle.encode_counts(m) for m in masks(4)]
    # the largest counts take 7 chars a value (the JAX package's buffer
    # holds 6): the port against its plain version only
    huge = np.asarray([0, 2 ** 32 - 1, 0, 2 ** 31, 1, 2 ** 32 - 1], np.uint32)
    s = rle.counts_to_string(huge)
    assert s == rle.counts_to_string_plain(huge)
    np.testing.assert_array_equal(rle.string_to_counts(s), huge)
    for counts in cases:
        s = rle.counts_to_string(counts)
        assert s == rle.counts_to_string_plain(counts) == jax_rle.counts_to_string(counts)
        np.testing.assert_array_equal(rle.string_to_counts(s), counts)
        np.testing.assert_array_equal(rle.string_to_counts_plain(s), counts)
        np.testing.assert_array_equal(rle.string_to_counts(s.decode()),
                                      jax_rle.string_to_counts(s))


@pytest.mark.parametrize("seed", [0, 1])
def test_area_bbox_merge(seed):
    rles = rle.encode(np.stack(masks(seed), axis=2))
    np.testing.assert_array_equal(rle.area(rles), jax_rle.area(rles))
    assert [rle.area(r) for r in rles] == [rle.area_plain(r) for r in rles]
    np.testing.assert_array_equal(rle.toBbox(rles), jax_rle.toBbox(rles))
    np.testing.assert_array_equal(rle.toBbox(rles[0]), rle.to_bbox_plain(rles[0]))
    for r in rles[:-2]:   # the plain version gives [0, 0, 0, 0] for an empty mask
        np.testing.assert_array_equal(rle.toBbox(r), rle.to_bbox_plain(r))
    for intersect in (False, True):
        for sub in (rles[:2], rles[1:5], rles):
            out = rle.merge(sub, intersect=intersect)
            assert out == jax_rle.merge(sub, intersect=intersect)
            assert out == rle.merge_plain(sub, intersect=intersect)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_with_crowd(seed):
    rng = np.random.RandomState(seed)
    dt = rle.encode(np.stack(masks(seed, n=5), axis=2))
    gt = rle.encode(np.stack(masks(seed + 10, n=4), axis=2))
    crowd = rng.randint(0, 2, len(gt)).tolist()
    out = rle.iou(dt, gt, crowd)
    assert out.shape == (len(dt), len(gt))
    np.testing.assert_array_equal(out, jax_rle.iou(dt, gt, crowd))
    np.testing.assert_array_equal(out, rle.iou_plain(dt, gt, crowd))
    assert rle.iou(dt, [], []).shape == (len(dt), 0)


def test_box_iou_with_crowd():
    rng = np.random.RandomState(5)
    dt = np.concatenate([rng.uniform(0, 50, (7, 2)), rng.uniform(1, 30, (7, 2))], 1)
    gt = np.concatenate([rng.uniform(0, 50, (4, 2)), rng.uniform(1, 30, (4, 2))], 1)
    gt[0] = dt[0]
    crowd = [0, 1, 0, 1]
    out = rle.iou(dt, gt, crowd)
    np.testing.assert_array_equal(out, jax_rle.iou(dt, gt, crowd))
    np.testing.assert_array_equal(out, rle.iou_plain(dt, gt, crowd))
    assert out[0, 0] == 1.0


@pytest.mark.parametrize("thr", [0.1, 0.5, 0.9])
def test_mask_nms(thr):
    base = masks(7, n=8)
    dt = rle.encode(np.stack(base + base[:3], axis=2))
    keep = rle.nms(dt, thr)
    np.testing.assert_array_equal(keep, jax_rle.nms(dt, thr))
    np.testing.assert_array_equal(keep, rle.nms_plain(dt, thr))


POLYS = [
    [10.0, 10.0, 30.0, 10.0, 30.0, 25.0, 10.0, 25.0],                 # axis square
    [3.3, 4.7, 40.2, 8.1, 22.5, 35.9],                                 # triangle
    [0.0, 0.0, 47.9, 0.0, 47.9, 39.9, 0.0, 39.9],                      # full frame
    [-5.0, 12.0, 20.0, -3.0, 60.0, 30.0, 12.0, 50.0],                  # beyond the frame
    [5.0, 5.0, 35.0, 30.0, 5.0, 30.0, 35.0, 5.0],                      # self-crossing
    list(np.random.RandomState(9).uniform(0, 45, 40)),                 # 20 random vertices
]


@pytest.mark.parametrize("poly", range(len(POLYS)))
def test_polygons(poly):
    xy, h, w = POLYS[poly], 40, 48
    counts = rle.counts_from_poly(xy, h, w)
    np.testing.assert_array_equal(counts, rle.counts_from_poly_plain(xy, h, w))
    np.testing.assert_array_equal(counts, jax_rle.counts_from_poly(xy, h, w))
    assert rle.frPyObjects([xy], h, w) == jax_rle.frPyObjects([xy], h, w)


def test_frpyobjects_boxes_and_uncompressed():
    h, w = 30, 40
    boxes = np.asarray([[2.0, 3.0, 10.0, 7.5], [0.0, 0.0, 40.0, 30.0]])
    assert rle.frPyObjects(boxes, h, w) == jax_rle.frPyObjects(boxes, h, w)
    m = random_mask(np.random.RandomState(2), h, w, 0.5)
    raw = {"size": [h, w], "counts": rle.encode_counts(m).tolist()}
    out = rle.frPyObjects(raw, h, w)
    assert out == jax_rle.frPyObjects(raw, h, w)
    np.testing.assert_array_equal(rle.decode(out), m)


# (y1, x1, h, w) in a 48x36 frame
EDGES = {"origin": (0, 0, 11, 7), "bottom_right": (37, 29, 11, 7), "full": (0, 0, 48, 36),
         "one_pixel": (47, 35, 1, 1), "empty_crop": (10, 10, 6, 5), "top_edge": (0, 12, 9, 13),
         "left_edge": (20, 0, 28, 4)}


def edge_crop(where):
    _, _, h, w = EDGES[where]
    rng = np.random.RandomState(len(where))
    return (rng.rand(h, w) < (0.0 if where == "empty_crop" else 0.6)).astype(np.uint8)


@pytest.mark.parametrize("where", list(EDGES))
def test_encode_pasted_at_the_edges(where):
    H, W = 48, 36
    y1, x1, _, _ = EDGES[where]
    crop = edge_crop(where)
    counts = rle.encode_pasted_counts(crop, y1, x1, H, W)
    np.testing.assert_array_equal(counts, rle.encode_pasted_counts_plain(crop, y1, x1, H, W))
    np.testing.assert_array_equal(counts, jax_rle.encode_pasted_counts(crop, y1, x1, H, W))
    assert rle.encode_pasted(crop, y1, x1, H, W) == jax_rle.encode_pasted(crop, y1, x1, H, W)


def test_encode_pasted_outside_the_frame_raises():
    with pytest.raises(ValueError, match="outside"):
        rle.encode_pasted(np.ones((5, 5), np.uint8), 44, 0, 48, 36)
    with pytest.raises(ValueError, match="outside"):
        rle.encode_pasted(np.ones((5, 5), np.uint8), 0, -1, 48, 36)


def many_case(case):
    """(crops, y1s, x1s) in a 48x36 frame for one call of ``encode_pasted_many``."""
    H, W = 48, 36
    rng = np.random.RandomState(len(case))
    if case == "none":
        return [], [], []
    if case == "edges":                    # test_encode_pasted_at_the_edges, in one call
        return ([edge_crop(k) for k in EDGES], [EDGES[k][0] for k in EDGES],
                [EDGES[k][1] for k in EDGES])
    if case == "ragged":                   # mixed sizes, a 1x1 and the full frame among them
        sizes = [(1, 1), (H, W), (3, 30), (40, 2), (17, 17), (1, W), (H, 1), (9, 5)]
        crops = [(rng.rand(h, w) < 0.5).astype(np.uint8) for h, w in sizes]
        y1s = [rng.randint(0, H - h + 1) for h, _ in sizes]
        x1s = [rng.randint(0, W - w + 1) for _, w in sizes]
        return crops, y1s, x1s
    if case == "zeros_and_ones":
        return [np.zeros((12, 9), np.uint8), np.ones((12, 9), np.uint8),
                np.ones((H, W), np.uint8)], [5, 30, 0], [20, 0, 0]
    assert case == "bool_and_sliced"
    base = rng.rand(40, 50) < 0.4
    sliced = base.astype(np.uint8)[3:33:2, 40:4:-3]        # non-contiguous, negative stride
    assert not sliced.flags.c_contiguous
    return [base[:20, :25], sliced, base[::3, ::4]], [1, 30, 0], [2, 20, 23]


@pytest.mark.parametrize("case", ["edges", "ragged", "zeros_and_ones", "bool_and_sliced", "none"])
def test_encode_pasted_many_equals_one_by_one(case):
    H, W = 48, 36
    crops, y1s, x1s = many_case(case)
    out = rle.encode_pasted_many(crops, y1s, x1s, H, W)
    assert isinstance(out, list) and len(out) == len(crops)
    for s, crop, y1, x1 in zip(out, crops, y1s, x1s):
        assert isinstance(s, bytes)
        assert s == rle.counts_to_string_plain(rle.encode_pasted_counts_plain(crop, y1, x1, H, W))
        assert s == jax_rle.encode_pasted(crop, y1, x1, H, W)["counts"]
        assert s == rle.encode_pasted(crop, y1, x1, H, W)["counts"]


@pytest.mark.parametrize("where", [0, 3, 5])
@pytest.mark.parametrize("side", ["top", "left", "bottom", "right"])
def test_encode_pasted_many_outside_the_frame_raises(where, side, monkeypatch):
    """One crop past any edge, anywhere in the list: ValueError before the
    native library is called."""
    monkeypatch.setattr(rle, "load_library", lambda: pytest.fail("called before the check"))
    crops = [np.ones((5, 4), np.uint8)] * 6
    y1s, x1s = [0, 10, 20, 30, 43, 7], [0, 5, 10, 15, 32, 20]
    y1s[where], x1s[where] = {"top": (-1, 3), "left": (3, -2), "bottom": (44, 3),
                              "right": (3, 33)}[side]
    with pytest.raises(ValueError, match="outside"):
        rle.encode_pasted_many(crops, y1s, x1s, 48, 36)


def test_library_is_built_under_build_native_by_hash():
    path = native_build.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    rle.area({"size": [2, 2], "counts": b"12"})
    assert path.exists()


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No toolchain: the build raises, nothing falls back to numpy."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        native_build.load_library()
    with pytest.raises(RuntimeError, match="not found"):
        rle.encode(np.zeros((3, 3), np.uint8, order="F"))
