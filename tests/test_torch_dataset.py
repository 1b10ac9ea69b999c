"""The port's dataset readers (``AmodalDataset``, ``AmodalCoco``,
``polygon_to_mask``, ``region_mask``) and sem-dist codec against the JAX
package's, on the synthetic COCOA-style dataset of ``tests/fixtures.py``.
All integer/boolean data: every comparison is exact."""

import pickle

import numpy as np
import pytest

from fixtures import make_synthetic_dataset
from sln_amodal_tpu.data import dataset as jax_dataset
from sln_amodal_tpu.data import semdist as jax_semdist
from sln_amodal_tpu_torch.data import dataset, semdist
from sln_amodal_tpu_torch.eval_amodal import rle


@pytest.fixture(scope="module", params=[("COCO", "val"), ("D2S", "train")])
def both(request, tmp_path_factory):
    data_type, subset = request.param
    root = str(tmp_path_factory.mktemp(f"synthetic_{data_type}"))
    make_synthetic_dataset(root, n_images=3, size=48, data_type=data_type,
                           subset=subset, seed=3)
    out = []
    for module in (jax_dataset, dataset):
        ds = module.AmodalDataset()
        coco = ds.load_amodal(root, subset, data_type=data_type)
        ds.prepare()
        out.append((ds, coco))
    return out


def test_image_info_and_index(both):
    (ref, ref_coco), (ds, coco) = both
    assert ds.image_info == ref.image_info
    np.testing.assert_array_equal(ds.image_ids, ref.image_ids)
    assert ds.num_images == ref.num_images == 3
    assert coco.get_img_ids() == ref_coco.get_img_ids()
    assert coco.get_ann_ids([1, 3]) == ref_coco.get_ann_ids([1, 3])
    assert coco.load_anns(coco.getAnnIds()) == ref_coco.load_anns(ref_coco.getAnnIds())
    assert coco.regions == ref_coco.regions


def test_load_image_and_mask(both):
    (ref, _), (ds, _) = both
    for i in ds.image_ids:
        np.testing.assert_array_equal(ds.load_image(i), ref.load_image(i))
        for a, b in zip(ds.load_mask(i), ref.load_mask(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_layers", [1, 2, 4])
def test_load_layers(both, num_layers):
    (ref, _), (ds, _) = both
    for i in ds.image_ids:
        for a, b in zip(ds.load_layers(i, num_layers), ref.load_layers(i, num_layers)):
            np.testing.assert_array_equal(a, b)


def test_load_layers_legacy(both):
    (ref, _), (ds, _) = both
    for i in ds.image_ids:
        path = ds.image_info[i]["path"]
        with open(path[:-4] + ".layer", "wb") as f:
            pickle.dump(semdist.load_layer_file(path[:-4] + ".npz").tolist(), f)
        for a, b in zip(ds.load_layers_legacy(i), ref.load_layers_legacy(i)):
            np.testing.assert_array_equal(a, b)


def test_polygon_and_region_masks():
    poly = [3.5, 2.0, 30.2, 6.0, 25.0, 28.7, 4.0, 20.0]
    np.testing.assert_array_equal(dataset.polygon_to_mask(poly, 40, 32),
                                  jax_dataset.polygon_to_mask(poly, 40, 32))
    m = np.zeros((32, 40), np.uint8)
    m[4:20, 7:33] = 1
    r = rle.encode(np.asfortranarray(m))
    for region in ({"segmentation": poly},
                   {"segmentation": {"size": r["size"], "counts": r["counts"].decode()}}):
        np.testing.assert_array_equal(dataset.region_mask(region, 40, 32),
                                      jax_dataset.region_mask(region, 40, 32))


def random_objects(seed, n, h=40, w=44):
    rng = np.random.RandomState(seed)
    amodal, invis = [], []
    for k in range(n):
        a = np.zeros((h, w), bool)
        y, x = rng.randint(0, h - 10), rng.randint(0, w - 10)
        a[y:y + rng.randint(6, h - y + 1), x:x + rng.randint(6, w - x + 1)] = True
        amodal.append(a)
        invis.append(None if k % 3 == 2 else a & (rng.rand(h, w) < 0.3))
    return amodal, invis


@pytest.mark.parametrize("seed,n", [(0, 2), (1, 5), (2, 9), (3, 34)])
def test_semdist_codec(seed, n):
    amodal, invis = random_objects(seed, n)
    for min_size in (1, 4, 64):
        label = semdist.encode_layer_map(amodal, invis, min_size=min_size)
        np.testing.assert_array_equal(
            label, jax_semdist.encode_layer_map(amodal, invis, min_size=min_size))
    ids = semdist.get_image_labels(label)
    np.testing.assert_array_equal(ids, jax_semdist.get_image_labels(label))
    assert semdist.max_object_id(ids) == jax_semdist.max_object_id(ids)
    for num_layers in (1, 2, 3, 5):
        for a, b in zip(semdist.decode_layer_masks(label, num_layers),
                        jax_semdist.decode_layer_masks(label, num_layers)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(semdist.decode_instance_masks(label),
                    jax_semdist.decode_instance_masks(label)):
        np.testing.assert_array_equal(a, b)
    for obj in range(min(n, 3)):
        for a, b in zip(semdist.object_masks(label, obj), jax_semdist.object_masks(label, obj)):
            np.testing.assert_array_equal(a, b)
    for lid in ids[:5]:
        bits = semdist.bits_to_indices(int(lid) >> 32)
        assert bits == jax_semdist.bits_to_indices(int(lid) >> 32)
        for obj in bits:
            assert semdist.occlusion_depth(int(lid), obj) == jax_semdist.occlusion_depth(int(lid), obj)
