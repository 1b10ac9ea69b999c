"""The port's host training loader against the JAX package's.

``data/pipeline.py`` is host numpy in both packages; the port keeps its own
copy. For the same numpy seed, ``make_training_sample`` gives bit-equal
samples (image, RPN match and deltas, padded GT ids, boxes and layer masks,
with the flip and the box jitter drawn), and ``TrainLoader(workers=1)``
equal batches. Also: the image helpers the loader uses, and each process's
slice of the dataset.
"""

import numpy as np
import pytest

from fixtures import make_synthetic_dataset
from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.data import pipeline as jax_pipeline
from sln_amodal_tpu.data.dataset import AmodalDataset as JaxDataset
from sln_amodal_tpu.ops.anchors import config_anchors as jax_anchors
from sln_amodal_tpu.utils import image as jax_image
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.data import pipeline
from sln_amodal_tpu_torch.data.dataset import AmodalDataset
from sln_amodal_tpu_torch.ops.anchors import config_anchors
from sln_amodal_tpu_torch.utils import image

CFG = dict(image_size=64, max_gt_instances=4, rpn_train_anchors_per_image=64, batch_size=2)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = make_synthetic_dataset(str(tmp_path_factory.mktemp("pipe")), n_images=5, size=80)
    out = []
    for cls in (JaxDataset, AmodalDataset):
        ds = cls()
        ds.load_amodal(root, "train")
        ds.prepare()
        out.append(ds)
    return out


def assert_samples_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("augment", [True, False])
def test_training_samples_equal_jax(datasets, augment):
    jax_ds, ds = datasets
    anchors = config_anchors(Config(**CFG))
    np.testing.assert_array_equal(anchors, jax_anchors(JaxConfig(**CFG)))
    for image_id in range(5):
        for seed in (0, 1):
            ref = jax_pipeline.make_training_sample(
                jax_ds, JaxConfig(**CFG), image_id, anchors,
                rng=np.random.default_rng(seed), augment=augment)
            got = pipeline.make_training_sample(
                ds, Config(**CFG), image_id, anchors, rng=np.random.default_rng(seed),
                augment=augment)
            assert_samples_equal(got, ref)
            assert got["gt_class_ids"].sum() > 0 and (got["rpn_match"] == 1).any()


def test_more_gt_than_slots_subsamples_the_same(datasets):
    """More GT than ``max_gt_instances``: the random subsample is the same."""
    jax_ds, ds = datasets
    cfg = dict(CFG, max_gt_instances=1)
    anchors = config_anchors(Config(**cfg))
    ref = jax_pipeline.make_training_sample(jax_ds, JaxConfig(**cfg), 2, anchors,
                                            rng=np.random.default_rng(5))
    got = pipeline.make_training_sample(ds, Config(**cfg), 2, anchors,
                                        rng=np.random.default_rng(5))
    assert_samples_equal(got, ref)
    assert got["gt_class_ids"].shape == (1,)


def test_rpn_targets_equal_jax():
    """Crowd boxes, a zero-area box and the positive/negative quota."""
    anchors = config_anchors(Config(**CFG))
    boxes = np.array([[8, 8, 40, 40], [30, 30, 62, 50], [10, 10, 10, 30], [0, 0, 20, 20]],
                     np.float32)
    ids = np.array([1, 1, 1, -1])
    ref = jax_pipeline.build_rpn_targets(anchors, ids, boxes, JaxConfig(**CFG),
                                         np.random.default_rng(2))
    got = pipeline.build_rpn_targets(anchors, ids, boxes, Config(**CFG),
                                     np.random.default_rng(2))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    # a sample with no box left is all negative
    match, deltas = pipeline.build_rpn_targets(anchors, ids[2:3], boxes[2:3], Config(**CFG))
    assert (match == -1).all() and not deltas.any()


def test_loader_batches_equal_jax(datasets):
    jax_ds, ds = datasets
    ref_it = iter(jax_pipeline.TrainLoader(jax_ds, JaxConfig(**CFG), seed=3, workers=1))
    got_it = iter(pipeline.TrainLoader(ds, Config(**CFG), seed=3, workers=1))
    for _ in range(4):
        assert_samples_equal(next(got_it), next(ref_it))


def test_extract_bboxes_and_image_helpers_equal_jax():
    rng = np.random.RandomState(0)
    masks = np.zeros((40, 50, 3), bool)
    masks[5:20, 10:30, 0] = True
    masks[0:40, 45:50, 1] = True
    for jitter in (True, False):
        np.testing.assert_array_equal(
            pipeline.extract_bboxes(masks, np.random.default_rng(1), jitter),
            jax_pipeline.extract_bboxes(masks, np.random.default_rng(1), jitter))
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    for a, b in zip(image.resize_image(img, 64), jax_image.resize_image(img, 64)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    layers = rng.rand(37, 53, 1, 2) > 0.5
    np.testing.assert_array_equal(image.resize_layer_masks(layers, (64 / 37, 64 / 53)),
                                  jax_image.resize_layer_masks(layers, (64 / 37, 64 / 53)))
    np.testing.assert_array_equal(image.mold_image(img, (123.7, 116.8, 103.9)),
                                  jax_image.mold_image(img, (123.7, 116.8, 103.9)))
    f = rng.rand(9, 7).astype(np.float32)
    np.testing.assert_array_equal(image.imresize_float(f, (20, 15)),
                                  jax_image.imresize_float(f, (20, 15)))


def test_train_loader_partitions_ids_as_jax(datasets):
    """Each process streams the JAX loader's slice of the dataset: ceil(5/2)
    ids, the tail wrapped to the front; one process keeps every id."""
    jax_ds, ds = datasets
    for index, count in ((0, 2), (1, 2), (0, 1)):
        ref = jax_pipeline.TrainLoader(jax_ds, JaxConfig(**CFG), workers=1,
                                       process_index=index, process_count=count)
        got = pipeline.TrainLoader(ds, Config(**CFG), workers=1,
                                   process_index=index, process_count=count)
        np.testing.assert_array_equal(got.local_ids, ref.local_ids)
        assert len(got.local_ids) == (3 if count == 2 else 5)
