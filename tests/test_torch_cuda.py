"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.ops.nms import nms_sorted_batched_plain
from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL, nms_sorted_batched
from sln_amodal_tpu_torch.ops.roi_align import pyramid_roi_align_plain
from sln_amodal_tpu_torch.ops.roi_align_cuda import ROI_ALIGN_KERNEL, pyramid_roi_align
from torch_port_helpers import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def cluster_boxes(rng, n, centers=8, jitter=40.0):
    """Boxes around a few centers: suppression chains that cross the
    kernel's 64-box words."""
    c = rng.uniform(100, 900, (centers, 2))[rng.randint(0, centers, n)]
    half = rng.uniform(20, 120, (n, 2))
    b = np.concatenate([c - half, c + half], 1) + rng.randn(n, 4) * jitter
    b[:, 2:] = np.maximum(b[:, 2:], b[:, :2] + 1)
    return b.astype(np.float32)


@pytest.mark.parametrize("n,max_out,thr,at_equal", [
    (6000, 1000, 0.7, False),     # the proposal shape
    (6000, 1000, 0.5, True),
    (130, 200, 0.3, False),       # ragged last word, fewer boxes than slots
    (1, 4, 0.7, False),
])
def test_nms_kernel_matches_plain(cuda_device, n, max_out, thr, at_equal):
    rng = np.random.RandomState(n)
    boxes = torch.from_numpy(np.stack([cluster_boxes(rng, n) for _ in range(2)]))
    valid = torch.from_numpy(rng.rand(2, n) > 0.05)
    if n < 10:
        valid[1] = False
    args = (boxes.to(cuda_device), valid.to(cuda_device), max_out, thr)
    before = NMS_KERNEL.launches
    k, v = nms_sorted_batched(*args, suppress_at_equal=at_equal)
    assert NMS_KERNEL.launches == before + 1
    k_ref, v_ref = nms_sorted_batched_plain(*args, suppress_at_equal=at_equal)
    torch.cuda.synchronize()
    assert torch.equal(v, v_ref)
    assert torch.equal(k, k_ref)


def _pyramid(b, c, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, s, c), generator=g).to("cuda", dtype)
            for s in (256, 128, 64, 32)]


def _boxes(b, n, seed=1):
    rng = np.random.RandomState(seed)
    y1, x1 = rng.uniform(-0.1, 0.9, (2, b, n))
    h, w = rng.uniform(0.005, 0.6, (2, b, n))
    boxes = np.stack([y1, x1, y1 + h, x1 + w], axis=-1)
    special = [[0.0, 0.0, 1.0, 1.0], [0.0, 0.3, 0.4, 1.0],
               [0.05, 0.1, 0.75, 0.12], [0.3, 0.0, 0.32, 0.95],
               [0.6, 0.2, 0.2, 0.6], [0.2, 0.6, 0.6, 0.2]][:n]
    boxes[:, :len(special)] = special
    return torch.from_numpy(boxes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pool,n", [(7, 1000), (16, 100)])
def test_roi_align_kernel_matches_plain(cuda_device, dtype, pool, n):
    """Exact: same geometry, same lerp order, no contraction on either side."""
    feats = _pyramid(2, 256, dtype)
    boxes = _boxes(2, n).to(cuda_device, dtype)
    before = ROI_ALIGN_KERNEL.launches
    out = pyramid_roi_align(feats, boxes, (pool, pool), (1024, 1024))
    assert ROI_ALIGN_KERNEL.launches == before + 1
    ref = pyramid_roi_align_plain(feats, boxes, (pool, pool), (1024, 1024))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_roi_align_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    feats = _pyramid(1, 8, torch.float32)
    boxes = _boxes(1, 4).to(cuda_device, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        pyramid_roi_align([f.transpose(1, 2) for f in feats], boxes, (7, 7), (1024, 1024))
    with pytest.raises(ValueError, match="float32 or float64"):
        pyramid_roi_align([f.half() for f in feats], boxes, (7, 7), (1024, 1024))


def test_detector_on_card_matches_cpu(cuda_device):
    """The whole slice in float64 on the card (kernels) and on the CPU
    (plain versions), same seeded weights: equal boxes and classes."""
    cfg = Config(image_size=128, backbone="resnet50", glm_input_size=65,
                 pre_nms_limit=400, post_nms_rois_inference=64,
                 detection_max_instances=8, compute_dtype="float64",
                 param_dtype="float64")
    sd = init_params(cfg, seed=0, device="cpu")
    # keep the random heads' outputs O(1): spread scores, small deltas
    for key, s in (("rpn.conv_class.weight", 1e-3), ("rpn.conv_bbox.weight", 1e-4),
                   ("classifier.linear_class.weight", 1e-2),
                   ("classifier.linear_bbox.weight", 1e-3)):
        sd[key] = sd[key] * s
    sd["classifier.linear_class.bias"][1] = 2.0
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (128, 128, 3), np.uint8) for _ in range(2)]

    gpu = Detector(cfg, sd, device=cuda_device)
    counts = NMS_KERNEL.launches, ROI_ALIGN_KERNEL.launches
    det_gpu, masks_gpu = gpu._fetch(gpu.dispatch(images))
    assert (NMS_KERNEL.launches, ROI_ALIGN_KERNEL.launches) == (counts[0] + 1, counts[1] + 2)
    cpu = Detector(cfg, sd, device="cpu")
    det_cpu, masks_cpu = cpu._fetch(cpu.dispatch(images))
    assert (det_cpu[..., 4] > 0).sum() > 0
    np.testing.assert_array_equal(det_gpu[..., :5], det_cpu[..., :5])
    # float32 probabilities and mask logits: the card's and the CPU's
    # transcendentals may differ in the last bit
    np.testing.assert_allclose(det_gpu[..., 5], det_cpu[..., 5], rtol=1e-6)
    np.testing.assert_allclose(masks_gpu, masks_cpu, rtol=1e-5, atol=1e-6)
