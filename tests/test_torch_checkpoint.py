"""The port's checkpoint loader (``train/checkpoint.py``) on ``.pth`` files
written by the JAX package's exporter (``sln_amodal_tpu.convert.torch_export``):
each loads to a state_dict tensor-for-tensor equal to ``params_from_jax`` of
what the JAX package's converter reads from the same file."""

import numpy as np
import pytest
import torch

import jax

from sln_amodal_tpu.config import Config as JaxConfig
from sln_amodal_tpu.convert import torch_export, torch_weights
from sln_amodal_tpu.models.sln import init_params as jax_init
from sln_amodal_tpu_torch.convert import params_from_jax
from sln_amodal_tpu_torch.train import checkpoint as ckpt
from torch_port_helpers import random_variables

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33,
           compute_dtype="float32", param_dtype="float32")
ARCH = "resnet50"


@pytest.fixture(scope="module")
def variables():
    shapes = jax.eval_shape(lambda k: jax_init(JaxConfig(**CFG), k), jax.random.PRNGKey(0))
    v = random_variables(shapes, seed=1, dtype=np.float32)
    # the loader's template: other values, same shapes
    return v, jax.tree_util.tree_map(lambda a: a * np.float32(0.5) - np.float32(1.0), v)


def save(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return str(path)


@pytest.fixture(scope="module")
def files(variables, tmp_path_factory):
    """The exporter's files, written once (each holds ~70M values): a full
    checkpoint, one without GLM keys, and the standalone deeplabv2.pth."""
    v, _ = variables
    tmp = tmp_path_factory.mktemp("pth")
    return dict(
        full=torch_export.save_torch_checkpoint(v, str(tmp / "COCOA.pth"), architecture=ARCH),
        no_glm=torch_export.save_torch_checkpoint(v, str(tmp / "model.pth"),
                                                  architecture=ARCH, include_glm=False),
        glm=save(torch_export.export_deeplab_state_dict(v), tmp / "deeplabv2.pth"))


@pytest.fixture(scope="module")
def port_sds(variables):
    """(the variables, the loader's template) as port state_dicts; the
    loader reads the template and never writes to it."""
    v, template = variables
    return params_from_jax(v), params_from_jax(template)


def assert_state_dicts_equal(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        assert torch.equal(out[k], ref[k]), k


def test_full_checkpoint_with_glm(files, port_sds):
    path = files["full"]
    ref_tree = torch_weights.convert_full_checkpoint(
        torch_weights.load_torch_state_dict(path), ARCH)
    out = ckpt.load_weights(path, port_sds[1])
    assert_state_dicts_equal(out, params_from_jax(ref_tree))
    assert_state_dicts_equal(out, port_sds[0])


def test_checkpoint_without_glm_takes_deeplabv2(files, port_sds):
    path, glm = files["no_glm"], files["glm"]
    ref_tree = torch_weights.convert_full_checkpoint(
        torch_weights.load_torch_state_dict(path), ARCH)
    ref_tree["params"]["glm"] = torch_weights.convert_deeplab(
        torch_weights.load_torch_state_dict(glm), prefix="")
    out = ckpt.load_weights(path, port_sds[1], glm_path=glm)
    assert_state_dicts_equal(out, params_from_jax(ref_tree))
    assert_state_dicts_equal(out, port_sds[0])


def test_checkpoint_without_glm_or_deeplabv2_warns(files, port_sds, capsys):
    out = ckpt.load_weights(files["no_glm"], port_sds[1])
    assert "no GLM weights" in capsys.readouterr().err
    expected = dict(port_sds[0])
    expected.update({k: t for k, t in port_sds[1].items() if k.startswith("GLM_modual.")})
    assert_state_dicts_equal(out, expected)


def test_pre_surgery_coco_checkpoint(variables, files, port_sds, tmp_path):
    """The 81-class mask_rcnn_coco.pth: the four surgical layers come from
    the template, everything else from the file, the GLM from deeplabv2."""
    v, template = variables
    sd = torch_export.export_state_dict(v, ARCH, include_glm=False)
    rng = np.random.RandomState(3)
    for key, shape in (("classifier.linear_class.weight", (81, 1024)),
                       ("classifier.linear_class.bias", (81,)),
                       ("classifier.linear_bbox.weight", (324, 1024)),
                       ("classifier.linear_bbox.bias", (324,)),
                       ("mask.conv1.weight", (256, 256, 3, 3)),
                       ("mask.conv5.weight", (81, 256, 1, 1)),
                       ("mask.conv5.bias", (81,))):
        sd[key] = rng.randn(*shape).astype(np.float32)
    path = save(sd, tmp_path / "mask_rcnn_coco.pth")
    glm = files["glm"]
    jax_template = jax.tree_util.tree_map(np.asarray, template)
    assert torch_weights.is_pre_surgery(torch_weights.load_torch_state_dict(path), jax_template)
    ref_tree = torch_weights.convert_coco_init(
        torch_weights.load_torch_state_dict(path), jax_template, ARCH)
    ref_tree["params"]["glm"] = torch_weights.convert_deeplab(
        torch_weights.load_torch_state_dict(glm), prefix="")
    out = ckpt.load_weights(path, port_sds[1], glm_path=glm)
    assert_state_dicts_equal(out, params_from_jax(ref_tree))


def test_extra_keys_are_dropped_with_a_warning(variables, port_sds, tmp_path, capsys):
    sd = torch_export.export_state_dict(variables[0], ARCH)
    sd["fpn.C1.1.num_batches_tracked"] = np.zeros((), np.int64)
    path = save(sd, tmp_path / "D2SA.pth")
    out = ckpt.load_weights(path, port_sds[1])
    assert "fpn.C1.1.num_batches_tracked" in capsys.readouterr().err
    assert_state_dicts_equal(out, port_sds[0])


def test_missing_key_or_wrong_shape_raises(variables, port_sds, tmp_path):
    sd = torch_export.export_state_dict(variables[0], ARCH)
    bias = sd.pop("rpn.conv_shared.bias")
    with pytest.raises(KeyError, match="rpn.conv_shared.bias"):
        ckpt.load_weights(save(sd, tmp_path / "a.pth"), port_sds[1])
    sd["rpn.conv_shared.bias"] = np.zeros(bias.shape[0] + 3, np.float32)
    with pytest.raises(ValueError, match="rpn.conv_shared.bias"):
        ckpt.load_weights(save(sd, tmp_path / "b.pth"), port_sds[1])


def test_jax_ckpt_is_refused(variables, port_sds, tmp_path):
    from sln_amodal_tpu.train import checkpoint as jax_ckpt

    path = jax_ckpt.save(variables[0], str(tmp_path), "cocoa", 1)
    with pytest.raises(ValueError, match="sln_amodal_tpu.convert.torch_export CKPT OUT.pth"):
        ckpt.load_weights(path, port_sds[1])


def test_template_dtype_and_save_find_last(files, port_sds, tmp_path):
    tmpl64 = {k: t.double() for k, t in port_sds[1].items()}
    out = ckpt.load_weights(files["full"], tmpl64)
    assert all(t.dtype == torch.float64 for t in out.values())
    assert ckpt.find_last(str(tmp_path / "logs"), "cocoa") == (None, None)
    for epoch in (3, 12, 7):
        sd = out if epoch == 12 else {"x": torch.zeros(1)}
        written = ckpt.save(sd, str(tmp_path / "logs"), "COCOA", epoch)
        assert written == ckpt.checkpoint_path(str(tmp_path / "logs"), "cocoa", epoch)
    last, epoch = ckpt.find_last(str(tmp_path / "logs"), "cocoa")
    assert epoch == 12 and last.endswith("sln_amodal_cocoa_0012.pth")
    assert_state_dicts_equal(ckpt.load_weights(last, tmpl64), out)
