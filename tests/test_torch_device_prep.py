"""The port's on-device training targets (``data/device_prep.py``) against
the JAX package's module and the host numpy loader.

Every case of ``tests/test_device_prep.py`` but the sharded one (ROADMAP
item 13) has its counterpart here, with the JAX module's function run on the
same numpy inputs. With the JAX module's ``jax.random`` draws fed in (its
own key splits, ``device_prep.py:356``, ``:258``), ``prepare_sample`` and
``prepare_batch`` equal the JAX package's bit for bit on images, masks,
class ids and RPN matches; boxes within 1e-6, RPN deltas within 2e-5 (the
JAX test's tolerances). Also: the host encoding equal to the JAX one, a
float64 heads step on a ``DevicePrepLoader`` batch against the JAX step on
the JAX ``prepare_batch`` output, and ``cli.train train --device_prep`` on
the CPU.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fixtures import make_synthetic_dataset
from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.data import device_prep as jax_prep
from sln_amodal_tpu.data import semdist as jax_semdist
from sln_amodal_tpu.data.dataset import AmodalDataset as JaxDataset
from sln_amodal_tpu_torch.cli import train as cli
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.data import device_prep, semdist
from sln_amodal_tpu_torch.data.dataset import AmodalDataset
from sln_amodal_tpu_torch.data.device_prep import (
    NOBJ,
    DevicePrepLoader,
    Draws,
    downsample_label_map,
    encode_sample,
    prepare_batch,
    prepare_sample,
)
from sln_amodal_tpu_torch.data.pipeline import (
    SampleOverflowError,
    build_rpn_targets,
    make_training_sample,
)
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.ops.anchors import config_anchors
from sln_amodal_tpu_torch.train.optim import StagedSGD
from sln_amodal_tpu_torch.train.trainer import to_device, train_step
from sln_amodal_tpu_torch.utils import image as image_utils
from test_torch_train_slice import (CFG, LR, SMALL, assert_step_equals_jax, jax_reference_step,
                                    shared_weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_label_map(rng, h, w, n_objects=5):
    """A sem-dist map of overlapping random rectangles, encoded with the
    port's encoder (later objects occlude earlier ones)."""
    amodal, invis = [], []
    occupied = np.zeros((h, w), bool)
    for _ in range(n_objects):
        y1, x1 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        y2, x2 = y1 + rng.randint(2, h // 2), x1 + rng.randint(2, w // 2)
        m = np.zeros((h, w), bool)
        m[y1:y2, x1:x2] = True
        amodal.append(m)
        inv = m & occupied
        invis.append(inv if inv.any() else None)
        occupied |= m
    return semdist.encode_layer_map(amodal, invis, min_size=1)


def as_int32(plane):
    return torch.from_numpy(np.ascontiguousarray(plane).view(np.int32))


def port_masks(label_map, size, num_layers):
    """The port's decode of the host-downsampled map; → [S, S, L, N] bool."""
    n = semdist.max_object_id(semdist.get_image_labels(label_map))
    lo, hi = device_prep.planes_from_small(downsample_label_map(label_map, size))
    out = device_prep._decode_masks(device_prep.bit_planes(as_int32(lo)[None]),
                                    device_prep.bit_planes(as_int32(hi)[None]),
                                    torch.tensor([n], dtype=torch.int32), num_layers)[0]
    return np.transpose(out.numpy(), (2, 3, 1, 0))[..., :n] > 0


def jax_masks(label_map, size, num_layers):
    n = jax_semdist.max_object_id(jax_semdist.get_image_labels(label_map))
    lo, hi = jax_prep.planes_from_small(jax_prep.downsample_label_map(label_map, size))
    out = jax_prep._decode_masks(jnp.asarray(lo), jnp.asarray(hi), jnp.int32(n), num_layers)
    return np.transpose(np.asarray(out), (2, 3, 1, 0))[..., :n] > 0


@pytest.mark.parametrize("hw", [(37, 53), (100, 80), (64, 64), (19, 91)])
@pytest.mark.parametrize("num_layers", [1, 3])
def test_decode_commutes_with_nearest_resize(hw, num_layers):
    """decode(zoom0(map)) == zoom0(decode(map)), bit for bit, in the port
    and in the JAX module."""
    rng = np.random.RandomState(sum(hw) + num_layers)
    h, w = hw
    size = 48
    label_map = random_label_map(rng, h, w)

    oracle_masks, _ = semdist.decode_layer_masks(label_map, num_layers)
    oracle = image_utils.resize_layer_masks(oracle_masks, (size / h, size / w)) > 0

    dev = port_masks(label_map, size, num_layers)
    assert dev.shape == oracle.shape
    np.testing.assert_array_equal(dev, oracle)
    np.testing.assert_array_equal(dev, jax_masks(label_map, size, num_layers))


def test_zoom0_indices_match_scipy():
    import scipy.ndimage

    rng = np.random.RandomState(0)
    for (h, w, s) in [(37, 53, 64), (7, 9, 16), (1, 5, 8), (128, 96, 64)]:
        m = rng.randint(0, 7, (h, w, 2, 3)).astype(np.uint8)
        z = scipy.ndimage.zoom(m, zoom=[s / h, s / w, 1, 1], order=0)
        for n_in, n_out in ((h, z.shape[0]), (w, z.shape[1])):
            np.testing.assert_array_equal(device_prep.zoom0_indices(n_in, n_out),
                                          jax_prep.zoom0_indices(n_in, n_out))
        g = m[device_prep.zoom0_indices(h, z.shape[0])][:, device_prep.zoom0_indices(w, z.shape[1])]
        np.testing.assert_array_equal(g, z)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synthetic set, read by the port's dataset and the JAX one."""
    root = str(tmp_path_factory.mktemp("devprep"))
    make_synthetic_dataset(root, n_images=3, size=64, subset="train")
    out = []
    for cls in (AmodalDataset, JaxDataset):
        ds = cls()
        ds.load_amodal(root, "train")
        ds.prepare()
        out.append(ds)
    return out


def prep_config(**kw):
    return Config(image_size=64, name="devprep", **kw)


def jax_draws(keys, num_anchors) -> Draws:
    """The draws the JAX module takes from each of ``keys`` [B, 2]
    (``prepare_sample``'s and ``_subsample_to_quota``'s key splits)."""
    fields = []
    for key in keys:
        k_flip, k_jit, k_sel, k_rpn = jax.random.split(key, 4)
        kp, kn = jax.random.split(k_rpn)
        fields.append((jax.random.bernoulli(k_flip), jax.random.uniform(k_jit, (NOBJ, 4)),
                       jax.random.uniform(k_sel, (NOBJ,)), jax.random.uniform(kp, (num_anchors,)),
                       jax.random.uniform(kn, (num_anchors,))))
    return Draws(*(torch.from_numpy(np.stack([np.asarray(f[i]) for f in fields]))
                   for i in range(5)))


def one(draws: Draws, i: int) -> Draws:
    return Draws(*(t[i] for t in draws))


def port_prepare(enc, anchors, draws, cfg, augment):
    return prepare_sample(torch.from_numpy(enc["image"]), as_int32(enc["label_lo"]),
                          as_int32(enc["label_hi"]), int(enc["n_objects"]),
                          torch.from_numpy(anchors).float(), draws, config=cfg, augment=augment)


def jax_prepare(enc, anchors, key, cfg, augment):
    out = jax_prep.prepare_sample(
        jnp.asarray(enc["image"]), jnp.asarray(enc["label_lo"]), jnp.asarray(enc["label_hi"]),
        jnp.asarray(enc["n_objects"]), jnp.asarray(anchors), key, config=cfg, augment=augment)
    return {k: np.asarray(v) for k, v in out.items()}


def assert_equal_to_jax(port, ref):
    """Bit for bit but the boxes (1e-6) and the RPN deltas (2e-5)."""
    assert set(port) == set(ref)
    for k, v in port.items():
        assert str(v.numpy().dtype) == str(ref[k].dtype) and v.shape == ref[k].shape, k
    for k in ("images", "gt_masks", "gt_class_ids", "rpn_match"):
        np.testing.assert_array_equal(port[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_allclose(port["gt_boxes"].numpy(), ref["gt_boxes"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["rpn_deltas"].numpy(), ref["rpn_deltas"], rtol=0, atol=2e-5)


def test_encode_sample_equals_jax(synth):
    ds, jax_ds = synth
    cfg = prep_config()
    for image_id in range(3):
        for dense in (True, False):
            enc = encode_sample(ds, cfg, image_id, dense_planes=dense)
            ref = jax_prep.encode_sample(jax_ds, JaxConfig(image_size=64), image_id,
                                         dense_planes=dense)
            assert list(enc) == list(ref)
            for k in enc:
                assert enc[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(enc[k], ref[k], err_msg=k)


def test_prepare_sample_matches_oracle(synth):
    """Augment off, against the host loader (the JAX test's checks and
    tolerances) and against the JAX module on its draws: the deterministic
    outputs equal; negatives, random on both paths, as (count, subset of
    the eligible)."""
    ds, _ = synth
    cfg = prep_config()
    anchors = config_anchors(cfg)

    for image_id in range(3):
        enc = encode_sample(ds, cfg, image_id)
        assert enc is not None
        key = jax.random.PRNGKey(image_id)
        draws = one(jax_draws(key[None], anchors.shape[0]), 0)
        dev = port_prepare(enc, anchors, draws, cfg, augment=False)
        assert_equal_to_jax(dev, jax_prepare(enc, anchors, key, JaxConfig(image_size=64), False))
        dev = {k: v.numpy() for k, v in dev.items()}

        host = make_training_sample(ds, cfg, image_id, anchors, rng=np.random.default_rng(0),
                                    augment=False)
        np.testing.assert_array_equal(dev["images"], host["images"])
        np.testing.assert_array_equal(dev["gt_class_ids"], host["gt_class_ids"])
        np.testing.assert_allclose(dev["gt_boxes"], host["gt_boxes"], atol=1e-6)
        np.testing.assert_array_equal(dev["gt_masks"], host["gt_masks"])
        assert dev["gt_masks"].any(), "vacuous: no mask content"

        pos_dev = np.where(dev["rpn_match"] == 1)[0]
        pos_host = np.where(host["rpn_match"] == 1)[0]
        assert pos_dev.size <= cfg.rpn_train_anchors_per_image // 2
        np.testing.assert_array_equal(pos_dev, pos_host)
        assert pos_dev.size > 0
        np.testing.assert_allclose(dev["rpn_deltas"][pos_dev], host["rpn_deltas"][pos_dev],
                                   atol=2e-5)
        np.testing.assert_array_equal(dev["rpn_deltas"][dev["rpn_match"] != 1], 0.0)

        no_subsample = cfg.replace(rpn_train_anchors_per_image=10 ** 6)
        full_match, _ = build_rpn_targets(
            anchors, np.asarray([1] * int(enc["n_objects"]), np.int32),
            host["gt_boxes"][: int(enc["n_objects"])] * cfg.image_size,
            no_subsample, rng=np.random.default_rng(1))
        eligible_neg = set(np.where(full_match == -1)[0])
        neg_dev = np.where(dev["rpn_match"] == -1)[0]
        quota = cfg.rpn_train_anchors_per_image - pos_dev.size
        assert neg_dev.size == min(quota, len(eligible_neg))
        assert set(neg_dev) <= eligible_neg


def test_prepare_sample_no_objects():
    cfg = prep_config()
    s = cfg.image_size
    anchors = config_anchors(cfg)
    key = jax.random.PRNGKey(0)
    zeros = np.zeros((s, s), np.uint32)
    enc = {"image": np.zeros((s, s, 3), np.uint8), "label_lo": zeros, "label_hi": zeros,
           "n_objects": np.int32(0)}
    dev = port_prepare(enc, anchors, one(jax_draws(key[None], anchors.shape[0]), 0), cfg, False)
    assert_equal_to_jax(dev, jax_prepare(enc, anchors, key, JaxConfig(image_size=64), False))
    # the host loader marks every anchor negative and samples nothing
    assert (dev["rpn_match"] == -1).all()
    assert (dev["rpn_deltas"] == 0).all()
    assert (dev["gt_class_ids"] == 0).all()
    assert (dev["gt_masks"] == 0).all()


def test_prepare_sample_augment_flip_is_exact(synth):
    """With augment on, the image is the molded original or its exact
    horizontal flip, and the masks follow; both occur over the seeds."""
    ds, _ = synth
    cfg = prep_config()
    anchors = config_anchors(cfg)
    enc = encode_sample(ds, cfg, 0)
    base = make_training_sample(ds, cfg, 0, anchors, rng=np.random.default_rng(0), augment=False)
    keys = jax.random.split(jax.random.PRNGKey(0), 6)
    draws = jax_draws(keys, anchors.shape[0])

    seen = set()
    for i in range(6):
        dev = port_prepare(enc, anchors, one(draws, i), cfg, augment=True)
        assert_equal_to_jax(dev, jax_prepare(enc, anchors, keys[i], JaxConfig(image_size=64), True))
        img, masks = dev["images"].numpy(), dev["gt_masks"].numpy()
        if np.array_equal(img, base["images"]):
            seen.add("original")
            np.testing.assert_array_equal(masks, base["gt_masks"])
            assert not draws.flip[i]
        elif np.array_equal(img, base["images"][:, ::-1]):
            seen.add("flipped")
            np.testing.assert_array_equal(masks, base["gt_masks"][..., ::-1])
            assert draws.flip[i]
        else:
            raise AssertionError("augmented image is neither original nor flip")
        boxes = dev["gt_boxes"].numpy()
        assert (boxes >= 0).all() and (boxes <= 1.0).all()
    assert seen == {"original", "flipped"}, "flip coin never landed both ways"


def encoded_random_batch(seed, size, budget):
    """A batch of 2 encoded samples from random 5-object label maps, in both
    upload formats."""
    rng = np.random.RandomState(seed)
    samples = []
    for hw in ((80, 72), (56, 90)):
        label_map = random_label_map(rng, *hw)
        small = downsample_label_map(label_map, size)
        starts, lo, hi, n_runs = device_prep.rle_encode_map(small, budget)
        plo, phi = device_prep.planes_from_small(small)
        samples.append({"image": rng.randint(0, 256, (size, size, 3)).astype(np.uint8),
                        "run_starts": starts, "run_lo": lo, "run_hi": hi, "n_runs": n_runs,
                        "n_objects": np.int32(semdist.max_object_id(
                            semdist.get_image_labels(label_map))),
                        "label_lo": plo, "label_hi": phi})
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("max_gt", [50, 4])
def test_jax_draws_give_jax_outputs(augment, max_gt):
    """The JAX module's draws fed to the port: ``prepare_sample`` equals the
    JAX ``prepare_sample`` and ``prepare_batch`` (RLE and dense uploads) the
    jitted JAX ``make_prepare_batch``, above and below 32 GT slots (below:
    5 objects into 4 slots, the random subset)."""
    size = 64
    cfg = prep_config(max_gt_instances=max_gt)
    jcfg = JaxConfig(image_size=size, max_gt_instances=max_gt)
    anchors = config_anchors(cfg)
    budget = device_prep.rle_budget_for(size)
    enc = encoded_random_batch(4, size, budget)
    assert (enc["n_objects"] > 4).all() and (enc["n_runs"] <= budget).all()
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    draws = jax_draws(keys, anchors.shape[0])

    for i in range(2):
        sample = {k: v[i] for k, v in enc.items()}
        assert_equal_to_jax(port_prepare(sample, anchors, one(draws, i), cfg, augment),
                            jax_prepare(sample, anchors, keys[i], jcfg, augment))

    anchors_t = torch.from_numpy(anchors).float()
    for rle in (True, False):
        keys_of_route = device_prep.RLE_KEYS if rle else device_prep.DENSE_KEYS
        ref = jax_prep.make_prepare_batch(jcfg, augment=augment, rle=rle)(
            {k: jnp.asarray(enc[k]) for k in keys_of_route}, jnp.asarray(anchors), keys)
        got = prepare_batch(device_prep.upload(enc, rle, "cpu"), anchors_t, draws,
                            config=cfg, augment=augment)
        assert_equal_to_jax(got, {k: np.asarray(v) for k, v in ref.items()})
        assert (got["rpn_match"] == 1).any() and got["gt_masks"].any()


def test_rle_roundtrip_matches_dense():
    """rle_encode_map → runs_to_planes reproduces the dense planes, on
    realistic, single-run and every-pixel-distinct maps; an over-budget map
    reports its true run count. The port's encoding equals the JAX one."""
    rng = np.random.RandomState(7)
    size = 48
    maps = [
        random_label_map(rng, 80, 64),
        np.zeros((size, size), np.uint64),
        np.arange(size * size, dtype=np.uint64).reshape(size, size) << np.uint64(20),
    ]
    for label_map in maps:
        small = downsample_label_map(label_map, size)
        budget = size * size
        runs = device_prep.rle_encode_map(small, budget)
        for a, b in zip(runs, jax_prep.rle_encode_map(small, budget)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        starts, lo, hi, n_runs = runs
        assert int(n_runs) <= budget
        got_lo, got_hi = device_prep.runs_to_planes(
            torch.from_numpy(starts)[None], as_int32(lo)[None], as_int32(hi)[None], size)
        ref_lo, ref_hi = device_prep.planes_from_small(small)
        np.testing.assert_array_equal(got_lo[0].numpy().view(np.uint32), ref_lo)
        np.testing.assert_array_equal(got_hi[0].numpy().view(np.uint32), ref_hi)

    small = downsample_label_map(maps[2], size)
    starts, lo, hi, n_runs = device_prep.rle_encode_map(small, 16)
    assert int(n_runs) == size * size and starts.shape == (16,)


def cpu_loader(ds, cfg, **kw):
    return DevicePrepLoader(ds, cfg, workers=1, device="cpu", **kw)


def test_loader_rle_and_dense_paths_agree(synth):
    """The RLE upload and the dense fallback (forced by a zero budget) give
    equal batches for the same seed."""
    ds, _ = synth
    cfg = prep_config(batch_size=2)
    rle_loader = cpu_loader(ds, cfg, seed=3, augment=False)
    assert rle_loader._rle_budget > 0
    dense_loader = cpu_loader(ds, cfg, seed=3, augment=False)
    dense_loader._rle_budget = 0

    b_rle = next(iter(rle_loader))
    b_dense = next(iter(dense_loader))
    # the prefetch thread may have prepared the next batch too
    assert rle_loader.route_counts["rle"] >= 1 and rle_loader.route_counts["dense"] == 0
    assert dense_loader.route_counts["dense"] >= 1 and dense_loader.route_counts["rle"] == 0
    assert list(b_rle) == list(b_dense)
    for k in b_dense:
        assert torch.equal(b_rle[k], b_dense[k]), k


def test_device_prep_loader_batches(synth):
    ds, _ = synth
    cfg = prep_config(batch_size=2)
    batch = next(iter(cpu_loader(ds, cfg, seed=0, augment=True)))
    s, g, a = cfg.image_size, cfg.max_gt_instances, cfg.num_anchors
    assert batch["images"].shape == (2, s, s, 3)
    assert batch["rpn_match"].shape == (2, a)
    assert batch["rpn_deltas"].shape == (2, a, 4)
    assert batch["gt_class_ids"].shape == (2, g)
    assert batch["gt_boxes"].shape == (2, g, 4)
    assert batch["gt_masks"].shape == (2, g, cfg.num_layers, s, s)
    assert all(v.device.type == "cpu" for v in batch.values())
    assert torch.isfinite(batch["images"]).all() and torch.isfinite(batch["rpn_deltas"]).all()
    assert batch["gt_class_ids"].sum() > 0
    m = batch["rpn_match"]
    assert ((m == 1).sum(1) <= cfg.rpn_train_anchors_per_image // 2).all()
    assert ((m != 0).sum(1) <= cfg.rpn_train_anchors_per_image).all()


def test_device_prefetch_exhaustion_and_error(synth):
    """The prefetch thread ends the iteration when its stream ends, raises
    the stream's failure on the consumer's side, and stops when the
    consumer does."""
    ds, _ = synth
    loader = cpu_loader(ds, prep_config(batch_size=1), seed=0, augment=False)

    finite = [{"x": i} for i in range(3)]
    loader._dispatch_stream = lambda: iter(finite)
    assert list(iter(loader)) == finite

    def failing():
        yield {"x": 0}
        raise RuntimeError("inner stream died")

    loader._dispatch_stream = failing
    it = iter(loader)
    assert next(it) == {"x": 0}
    with pytest.raises(RuntimeError, match="inner stream died"):
        next(it)

    loader._dispatch_stream = lambda: iter(finite * 100)
    it = iter(loader)
    next(it)
    it.close()


def test_device_prep_loader_rejects_legacy_dataset(synth, tmp_path, monkeypatch):
    """A dataset without .npz maps is refused when the loader is built,
    naming the port's converter."""
    ds, _ = synth
    real = ds.image_info[int(ds.image_ids[0])]["path"]
    missing = str(tmp_path / os.path.basename(real))
    shutil.copy(real, missing)
    monkeypatch.setitem(ds.image_info[int(ds.image_ids[0])], "path", missing)
    with pytest.raises(ValueError, match="device_prep.*sln_amodal_tpu_torch.cli.convert_dataset"):
        cpu_loader(ds, prep_config(), seed=0)


def test_overflow_skips_counted_separately(synth, capsys):
    """Overflow skips are counted apart from corrupt-data errors, with a
    warning once the rate is systematic. The multi-process loader, where
    the JAX module raises them, is ROADMAP item 13: the port refuses it."""
    ds, _ = synth
    cfg = prep_config(batch_size=1)
    with pytest.raises(NotImplementedError, match="item 13"):
        DevicePrepLoader(ds, cfg, device="cpu", process_index=0, process_count=2)

    loader = cpu_loader(ds, cfg, seed=0, augment=False)
    calls = [0]

    def alternating(image_id, rng):
        calls[0] += 1
        if calls[0] % 2 == 1:
            raise SampleOverflowError(f"sample {image_id} needs RLE runs")
        return {"ok": calls[0]}

    loader._make_one_sample = alternating
    stream = loader._sample_stream()
    got = [next(stream) for _ in range(8)]
    assert [g["ok"] for g in got] == [2, 4, 6, 8, 10, 12, 14, 16]
    assert loader.overflow_count == 8
    assert loader.error_count == 0
    out = capsys.readouterr().out
    assert "overflow_skips=" in out
    assert "systematically filtered" in out


def test_device_prep_defaults_to_the_card(synth):
    """Without a card, the default device raises: nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrepLoader(synth[0], prep_config())


def test_to_device_passes_tensors_through():
    batch = {"images": torch.zeros(1, 2, 2, 3), "rpn_match": np.zeros((1, 4), np.int32),
             "rpn_deltas": torch.zeros(1, 4, 4),
             "gt_class_ids": torch.zeros(1, 2, dtype=torch.int32),
             "gt_boxes": np.zeros((1, 2, 4), np.float64), "gt_masks": torch.zeros(1, 2, 1, 2, 2)}
    out = to_device(batch, "cpu")
    assert out["images"] is batch["images"] and out["gt_masks"] is batch["gt_masks"]
    assert out["gt_boxes"].dtype == torch.float32 and out["rpn_match"].dtype == torch.int32


# ------------------------------------------------------ the whole slice --


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def biased_root(tmp_path_factory):
    """64² training images whose ground truth sits on the RPN-biased
    model's first proposals (``chip_smoke.py::write_dataset``), with their
    sem-dist maps, so the heads see positive ROIs."""
    smoke = chip_smoke()
    root = str(tmp_path_factory.mktemp("biased"))
    cfg = Config(**CFG)
    smoke.write_dataset(root, 64, 4, seed=3, pair=smoke.biased_pair(cfg), subset="train",
                        layers=True)
    smoke.write_dataset(root, 64, 2, seed=5, pair=smoke.biased_pair(cfg), layers=True)
    return root


def test_heads_step_on_device_prep_batch_equals_jax(biased_root):
    """One float64 heads step on a ``DevicePrepLoader`` batch (augment off,
    the JAX keys' draws) against the JAX train step on the jitted JAX
    ``make_prepare_batch`` output of the same encoded batch: the batches
    equal, then the losses within 1e-6 relative and the parameters within
    1e-6 of the update's size (the reference of test_torch_train_slice.py)."""
    variables, port_sd = shared_weights()
    cfg = Config(**CFG)
    ds = AmodalDataset()
    ds.load_amodal(biased_root, "train")
    ds.prepare()
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    loader = cpu_loader(ds, cfg, seed=0, augment=False)
    loader._draws = lambda b: jax_draws(keys, cfg.num_anchors)
    encoded = []
    prepare = loader._prepare
    loader._prepare = lambda enc: encoded.append(enc) or prepare(enc)
    batch = next(iter(loader))

    jcfg = JaxConfig(**dict(CFG, compute_dtype="float32", param_dtype="float32"))
    ref = jax_prep.make_prepare_batch(jcfg, augment=False, rle=True)(
        {k: jnp.asarray(encoded[0][k]) for k in device_prep.RLE_KEYS},
        jnp.asarray(config_anchors(cfg)), keys)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert_equal_to_jax(batch, ref)
    assert (batch["rpn_match"] == 1).any()

    ref_losses, updated, uniforms, ref_class_ids = jax_reference_step(variables, ref, ("heads",))
    model = SLNAmodal(cfg, device="cpu")
    model.load_state_dict(port_sd)
    targets = []
    original = model.train_step_outputs

    def keep(*args, **kw):
        outputs = original(*args, **kw)
        targets.append(outputs.targets)
        return outputs

    model.train_step_outputs = keep
    losses = train_step(model, StagedSGD(model, "heads", LR), to_device(batch, "cpu"),
                        uniforms=uniforms)
    np.testing.assert_array_equal(targets[0].class_ids.numpy(), ref_class_ids)
    assert int(targets[0].positive.sum()) > 0 and ref_losses["layer"] > 0
    assert_step_equals_jax(model, port_sd, losses, ref_losses, updated["heads"])


def test_train_cli_device_prep_on_the_cpu(biased_root, monkeypatch, tmp_path, capsys):
    """``cli.train train --device_prep --device cpu`` in process, on the
    reduced config in float32: two heads steps and a validation batch from
    ``DevicePrepLoader``s, a checkpoint written."""
    _, port_sd = shared_weights()
    sd32 = {k: v.to(torch.float32) for k, v in port_sd.items()}
    monkeypatch.setattr(cli, "train_config", lambda args: Config(
        **dict(SMALL, name=args.data_type.lower(), batch_size=args.batch_size,
               steps_per_epoch=args.steps_per_epoch)))
    monkeypatch.setattr(cli, "init_params", lambda config, seed=0, device="cuda": {
        k: v.clone().to(device) for k, v in sd32.items()})
    built = []

    class Recording(DevicePrepLoader):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

    monkeypatch.setattr(cli, "DevicePrepLoader", Recording)
    logs = str(tmp_path / "logs")
    out = cli.main(["train", "--dataset", biased_root, "--logs", logs, "--device", "cpu",
                    "--batch_size", "2", "--stage", "heads", "--epochs", "1",
                    "--steps_per_epoch", "2", "--model", "random", "--validate_steps", "1",
                    "--device_prep"])
    printed = capsys.readouterr().out
    assert "step 2/2" in printed and "  val " in printed
    assert [(b.augment, b.device.type) for b in built] == [(True, "cpu"), (False, "cpu")]
    assert sum(b.route_counts["rle"] for b in built) >= 2
    assert out.trainer.step == 2 and os.path.exists(out.checkpoints[0])
    shutil.rmtree(logs, ignore_errors=True)
