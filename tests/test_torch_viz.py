"""The port's ``viz.py`` against the JAX package's: the cases of
``tests/test_viz_recall.py``, with the port's arrays equal to the JAX
``viz``'s on the same inputs."""

import numpy as np
import pytest

from sln_amodal_tpu import viz as jax_viz
from sln_amodal_tpu.eval_amodal import rle as jax_rle
from sln_amodal_tpu_torch import viz


def _region(mask, order):
    r = jax_rle.encode(np.asfortranarray(mask.astype(np.uint8)))
    return {"segmentation": {"size": r["size"], "counts": r["counts"].decode()},
            "order": order}


def _masks():
    m1 = np.zeros((32, 32), np.uint8)
    m1[4:20, 4:20] = 1
    m2 = np.zeros((32, 32), np.uint8)
    m2[10:28, 10:28] = 1
    return m1, m2


def _image(seed=0):
    return np.random.RandomState(seed).randint(0, 255, (32, 32, 3), np.uint8)


def test_show_amodal_anns_paints_pixels(tmp_path):
    img = np.zeros((32, 32, 3), np.uint8)
    m1, m2 = _masks()
    regions = [_region(m1, 1), _region(m2, 2)]
    out = viz.show_amodal_anns(img, regions, path=str(tmp_path / "a.png"))
    assert out.shape == img.shape
    assert out[12, 12].any()          # painted
    assert not out[0, 0].any()        # background untouched
    assert (tmp_path / "a.png").exists()
    np.testing.assert_array_equal(out, jax_viz.show_amodal_anns(img, regions))


def test_show_amodal_anns_depth_order_matches_jax():
    """Back to front by ``order``, on a textured image, with a polygon region."""
    img = _image(1)
    m1, m2 = _masks()
    poly = {"segmentation": [2, 2, 30, 4, 16, 30], "order": 3}
    regions = [_region(m2, 2), poly, _region(m1, 1)]
    np.testing.assert_array_equal(viz.show_amodal_anns(img, regions, alpha=0.3),
                                  jax_viz.show_amodal_anns(img, regions, alpha=0.3))


@pytest.mark.parametrize("visible", [False, True])
def test_show_instances_match_jax(visible, tmp_path):
    img = _image(2)
    m1, m2 = _masks()
    region = _region(m2, 1)
    if visible:
        r = jax_rle.encode(np.asfortranarray(m1))
        region["visible_mask"] = {"size": r["size"], "counts": r["counts"].decode()}
    modal = viz.show_modal_instance(img, region, path=str(tmp_path / "m.png"))
    np.testing.assert_array_equal(modal, jax_viz.show_modal_instance(img, region))
    assert (tmp_path / "m.png").exists()
    amodal = viz.show_amodal_instance(img, region)
    np.testing.assert_array_equal(amodal, jax_viz.show_amodal_instance(img, region))
    # the amodal extent is m2; the modal part is m1 where a visible mask is given
    painted = (modal != img).any(-1)
    assert np.array_equal(painted, (m1 if visible else m2).astype(bool))
    assert np.array_equal((amodal != img).any(-1), m2.astype(bool))


def test_overlay_detections():
    img = np.zeros((32, 32, 3), np.uint8)
    masks = np.zeros((32, 32, 2), np.uint8)
    masks[2:10, 2:10, 0] = 1
    masks[15:25, 15:25, 1] = 1
    rois = np.array([[2, 2, 10, 10], [15, 15, 25, 25]])
    scores = np.array([0.9, 0.5])
    out = viz.overlay_detections(img, rois, scores, masks)
    assert out[5, 5].any() and out[20, 20].any()
    np.testing.assert_array_equal(out, jax_viz.overlay_detections(img, rois, scores, masks))


def test_overlay_detections_saves_and_matches_jax(tmp_path):
    img = _image(3)
    rng = np.random.RandomState(4)
    masks = (rng.rand(32, 32, 14) > 0.7).astype(np.uint8)   # more than the palette
    rois = np.sort(rng.randint(0, 32, (14, 2, 2)), axis=1).reshape(14, 4)   # y1 x1 y2 x2
    scores = rng.rand(14)
    out = viz.overlay_detections(img, rois, scores, masks, alpha=0.4,
                                 path=str(tmp_path / "d.png"))
    assert (tmp_path / "d.png").exists()
    np.testing.assert_array_equal(
        out, jax_viz.overlay_detections(img, rois, scores, masks, alpha=0.4))
