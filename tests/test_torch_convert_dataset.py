"""The port's dataset converter (``cli/convert_dataset.py``) against the JAX
package's script (``scripts/convert_dataset.py``): on the data of
``tests/fixtures.py``, ``encode`` writes equal ``.npz`` sem-dist maps,
``check`` passes and flags a missing map alike, and ``d2s_to_amodal`` gives
equal amodal-COCO JSON, which the port's dataset reader loads."""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest

from fixtures import make_synthetic_dataset
from sln_amodal_tpu_torch.cli import convert_dataset
from sln_amodal_tpu_torch.data.dataset import AmodalDataset
from test_convert_d2s import make_raw_d2s

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

spec = importlib.util.spec_from_file_location(
    "jax_convert_dataset", os.path.join(REPO, "scripts", "convert_dataset.py"))
jax_convert = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_convert)


def dataset_args(root, data_type, min_size=4):
    return argparse.Namespace(dataset=root, subset="train", data_type=data_type, year="2014",
                              min_size=min_size, limit=-1)


def fixture_root(tmp_path, name, data_type):
    """The fixture set with its own .npz maps removed, so encode writes them."""
    root = make_synthetic_dataset(str(tmp_path / name), n_images=3, size=64, subset="train",
                                  data_type=data_type)
    img_dir = os.path.join(root, "train2014")
    for f in os.listdir(img_dir):
        if f.endswith(".npz"):
            os.remove(os.path.join(img_dir, f))
    return root


def layer_maps(root):
    img_dir = os.path.join(root, "train2014")
    return {f: np.load(os.path.join(img_dir, f))["layer"]
            for f in sorted(os.listdir(img_dir)) if f.endswith(".npz")}


@pytest.mark.parametrize("data_type", ["COCO", "D2S"])
@pytest.mark.parametrize("min_size", [4, 64])
def test_encode_writes_the_scripts_maps(tmp_path, data_type, min_size):
    port_root = fixture_root(tmp_path, "port", data_type)
    jax_root = fixture_root(tmp_path, "jax", data_type)
    convert_dataset.encode(dataset_args(port_root, data_type, min_size=min_size))
    jax_convert.encode(dataset_args(jax_root, data_type, min_size=min_size))
    ours, theirs = layer_maps(port_root), layer_maps(jax_root)
    assert list(ours) == list(theirs) == ["img_0001.npz", "img_0002.npz", "img_0003.npz"]
    for name in ours:
        assert ours[name].dtype == theirs[name].dtype == np.uint64
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    assert any(m.any() for m in ours.values())


def test_check_passes_and_flags_a_missing_map(tmp_path, capsys):
    root = fixture_root(tmp_path, "data", "COCO")
    args = dataset_args(root, "COCO")
    convert_dataset.encode(args)
    convert_dataset.check(args)
    assert "checked 3, problems: 0" in capsys.readouterr().out
    os.remove(os.path.join(root, "train2014", "img_0002.npz"))
    outs = []
    for module in (convert_dataset, jax_convert):
        with pytest.raises(SystemExit) as exc:
            module.check(args)
        assert exc.value.code == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "MISSING" in outs[0] and "problems: 1" in outs[0]


def test_d2s_to_amodal_dataset_equals_the_scripts():
    raw = make_raw_d2s()
    assert convert_dataset.d2s_to_amodal_dataset(raw) == jax_convert.d2s_to_amodal_dataset(raw)


def test_d2s_to_amodal_cli_writes_the_scripts_json(tmp_path):
    raw = make_raw_d2s()
    raw["annotations"][0]["image_id"] = np.int64(10)   # numpy scalars are written as ints
    raw_path = tmp_path / "D2S_amodal_training_rot0.json"
    raw_path.write_text(json.dumps(raw, cls=convert_dataset.NumpyEncoder))
    out_path = tmp_path / "root" / "annotations" / "D2SA_amodal_val2014.json"
    convert_dataset.main(["d2s_to_amodal", "--ann", str(raw_path), "--out", str(out_path)])
    ref_path = tmp_path / "ref.json"
    jax_convert.d2s_to_amodal(argparse.Namespace(ann=str(raw_path), out=str(ref_path)))
    assert out_path.read_text() == ref_path.read_text()

    from PIL import Image

    img_dir = tmp_path / "root" / "val2014"
    img_dir.mkdir(parents=True)
    for info in json.loads(out_path.read_text())["images"]:
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(img_dir / info["file_name"])
    ds = AmodalDataset()
    ds.load_amodal(str(tmp_path / "root"), "val", data_type="D2SA")
    ds.prepare()
    assert ds.num_images == 2
    amodal, class_ids, _, _ = ds.load_mask(0)
    assert amodal.shape == (32, 32, 3) and list(class_ids) == [1, 1, 1]
