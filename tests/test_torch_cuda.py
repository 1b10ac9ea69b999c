"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.ops.nms import nms_sorted_batched_plain
from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL, nms_sorted_batched
from sln_amodal_tpu_torch.ops.roi_align import (pyramid_roi_align_backward_plain,
                                                pyramid_roi_align_plain)
from sln_amodal_tpu_torch.ops.roi_align_cuda import (
    ROI_ALIGN_BACKWARD_KERNEL, ROI_ALIGN_KERNEL, level_scale_reciprocal,
    pyramid_roi_align, pyramid_roi_align_backward)
from torch_port_helpers import cuda_device  # noqa: F401  (fixture)
from torch_port_helpers import library_op_samples

pytestmark = pytest.mark.cuda


def cluster_boxes(rng, n, centers=8, jitter=40.0):
    """Boxes around a few centers: suppression chains that cross the
    kernel's 64-box words."""
    c = rng.uniform(100, 900, (centers, 2))[rng.randint(0, centers, n)]
    half = rng.uniform(20, 120, (n, 2))
    b = np.concatenate([c - half, c + half], 1) + rng.randn(n, 4) * jitter
    b[:, 2:] = np.maximum(b[:, 2:], b[:, :2] + 1)
    return b.astype(np.float32)


def sparse_boxes(rng, n):
    """Disjoint boxes on a grid (cells 12 px apart, boxes 4 px wide):
    nothing is suppressed, so keeps are 0, 1, 2, ... in order."""
    cell = np.arange(n)
    y, x = (cell // 100) * 12.0, (cell % 100) * 12.0
    b = np.stack([y, x, y + 4, x + 4], 1) + rng.uniform(0, 2, (n, 1))
    return b.astype(np.float32)


@pytest.mark.parametrize("n,max_out,thr,at_equal,layout", [
    (6000, 1000, 0.7, False, "cluster"),    # the proposal shape
    (6000, 1000, 0.5, True, "cluster"),
    (130, 200, 0.3, False, "cluster"),      # ragged last word, fewer boxes than slots
    (1, 4, 0.7, False, "cluster"),
    (6000, 100, 0.7, False, "sparse"),      # max_out reached in the middle of word 1
    (6000, 1000, 0.7, False, "sparse"),     # nothing suppressed: stops in word 15
    (6000, 1000, 0.7, False, "invalid_image"),  # image 1 has no valid box
    (63, 64, 0.5, False, "cluster"),
    (64, 64, 0.5, False, "cluster"),
    (65, 64, 0.5, False, "cluster"),
    (65, 80, 0.5, False, "sparse"),
])
def test_nms_kernel_matches_plain(cuda_device, n, max_out, thr, at_equal, layout):
    rng = np.random.RandomState(n)
    make = sparse_boxes if layout == "sparse" else cluster_boxes
    boxes = torch.from_numpy(np.stack([make(rng, n) for _ in range(2)]))
    valid = torch.from_numpy(rng.rand(2, n) > 0.05)
    if layout == "sparse":
        valid[:] = True
    if n < 10 or layout == "invalid_image":
        valid[1] = False
    args = (boxes.to(cuda_device), valid.to(cuda_device), max_out, thr)
    before = NMS_KERNEL.launches
    k, v = nms_sorted_batched(*args, suppress_at_equal=at_equal)
    assert NMS_KERNEL.launches == before + 1
    k_ref, v_ref = nms_sorted_batched_plain(*args, suppress_at_equal=at_equal)
    torch.cuda.synchronize()
    assert torch.equal(v, v_ref)
    assert torch.equal(k, k_ref)
    if layout == "sparse":
        kept = min(n, max_out)
        assert torch.equal(k[0, :kept].cpu(), torch.arange(kept, dtype=torch.int32))


def _pyramid(b, c, dtype, seed=0, sizes=(256, 128, 64, 32)):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, s, c), generator=g).to("cuda", dtype) for s in sizes]


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


def _box_dtype(dtype):
    """The boxes' dtype for levels of ``dtype``: float32 for bfloat16 levels
    (the model's), the levels' own otherwise."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _level_boundary_boxes(dtype):
    """Square boxes whose sqrt(hw) is 224/1024 * 2^k (integer levels) or
    224/1024 * 2^(k + 1/2) (where round() turns), each also one ulp of the
    box dtype either side, on y2 and on x2."""
    npdt = np.float64 if _box_dtype(dtype) == torch.float64 else np.float32
    sides = 224.0 / 1024.0 * 2.0 ** np.array([-2, -1.5, -1, -0.5, 0, 0.5, 1, 1.5, 2])
    rows = []
    for side in sides.astype(npdt):
        for d in (-1, 0, 1):
            s = side if d == 0 else np.nextafter(side, npdt(d * np.inf))
            rows += [[0, 0, s, side], [0, 0, side, s], [0.1, 0.2, 0.1 + s, 0.2 + s]]
    return torch.from_numpy(np.array(rows, dtype=npdt)[None].repeat(2, 0))


def _roi_case(case, dtype):
    """(levels, boxes [2, N, 4], crop, image shape) of one kernel case."""
    image = (1024, 1024)
    if case == "pool7":
        return _pyramid(2, 256, dtype), _boxes(2, 1000), (7, 7), image
    if case == "pool16":
        return _pyramid(2, 256, dtype), _boxes(2, 100), (16, 16), image
    if case == "level_boundaries":
        return _pyramid(2, 64, dtype), _level_boundary_boxes(dtype), (7, 7), image
    if case == "integer_samples":
        # one level 257 wide (dim - 1 = 256), pool 5 (recip 1/4 exact):
        # samples land on integers and on dim - 1 exactly
        edges = np.array([[0, 0, 1, 1], [0, 0, 0.5, 0.25], [0.25, 0.5, 1, 1],
                          [1 / 256, 2 / 256, 9 / 256, 6 / 256], [0.75, 0.75, 1, 1],
                          [0, 0.5, 1 + 4 / 256, 1]])
        return (_pyramid(2, 16, dtype, sizes=(257,)),
                torch.from_numpy(edges[None].repeat(2, 0)), (5, 5), image)
    if case == "crop_1x1":
        return _pyramid(2, 32, dtype), _boxes(2, 50), (1, 1), image
    if case in ("one_level", "two_levels", "three_levels"):
        k = ("one_level", "two_levels", "three_levels").index(case) + 1
        return (_pyramid(2, 24, dtype, sizes=(64, 32, 16)[:k]), _boxes(2, 60), (7, 7),
                (256, 256))
    if case == "outside":
        # entirely outside the image on each side, and straddling it
        edges = np.array([[1.2, 0.1, 1.5, 0.4], [-0.6, 0.1, -0.2, 0.4],
                          [0.1, 1.1, 0.4, 1.3], [0.1, -0.5, 0.4, -0.1],
                          [-0.3, -0.3, 1.3, 1.3], [1.5, 1.5, 2.5, 2.5]])
        return (_pyramid(2, 256, dtype), torch.from_numpy(edges[None].repeat(2, 0)),
                (7, 7), image)
    if case == "empty":
        return _pyramid(2, 256, dtype), torch.zeros((2, 0, 4), dtype=torch.float64), (7, 7), image
    if case == "padded":
        # as the train step samples: 30 real ROIs per image, 70 all-zero rows
        # (every sample of a zero box on cell (0, 0) of P2)
        boxes = _boxes(2, 100)
        boxes[:, 30:] = 0.0
        return _pyramid(2, 256, dtype), boxes, (16, 16), image
    if case == "crowded":
        # 100 small boxes on at most 4 rows of P2 (rows 9-12 of 256)
        rng = np.random.RandomState(7)
        y1 = rng.uniform(10 / 256, 10.5 / 256, (2, 100))
        x1 = rng.uniform(0.0, 0.9, (2, 100))
        h = rng.uniform(0.2 / 256, 1.0 / 256, (2, 100))
        w = rng.uniform(0.01, 0.1, (2, 100))
        boxes = np.stack([y1, x1, y1 + h, x1 + w], axis=-1)
        return _pyramid(2, 256, dtype), torch.from_numpy(boxes), (7, 7), image
    raise ValueError(case)


ROI_CASES = ["pool7", "pool16", "level_boundaries", "integer_samples", "crop_1x1",
             "one_level", "two_levels", "three_levels", "outside", "empty", "padded",
             "crowded"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("case", ROI_CASES)
def test_roi_align_kernel_matches_plain(cuda_device, dtype, case):
    """Exact: the kernel's own geometry equals sample_geometry on the card,
    same lerp order, no contraction on either side (bfloat16 levels: both
    interpolate in float32 and round once)."""
    feats, boxes, crop, image = _roi_case(case, dtype)
    boxes = boxes.to(cuda_device, _box_dtype(dtype))
    before = ROI_ALIGN_KERNEL.launches
    out = pyramid_roi_align(feats, boxes, crop, image)
    # one launch per call; none where there is no box
    assert ROI_ALIGN_KERNEL.launches == before + (boxes.shape[1] > 0)
    ref = pyramid_roi_align_plain(feats, boxes, crop, image)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("image", [(1024, 1024), (800, 600), (333, 517), (128, 128)])
def test_level_rule_divides_as_the_kernel_multiplies(cuda_device, image, dtype):
    """roi_levels divides by the host scalar 224 / sqrt(area); on the card
    ATen multiplies by the scalar's reciprocal, the value the kernel gets."""
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(1_000_000, generator=g, dtype=torch.float64) * 2).to(cuda_device, dtype)
    scale = 224.0 / math.sqrt(float(image[0] * image[1]))
    assert torch.equal(x / scale, x * level_scale_reciprocal(image, dtype))


def test_roi_align_kernel_takes_boxes_of_either_dtype(cuda_device):
    """float64 boxes over float32 levels and float32 boxes over float64
    levels: the level rule runs in the boxes' dtype, the geometry in f32."""
    for feat_dtype, box_dtype in ((torch.float32, torch.float64),
                                  (torch.float64, torch.float32)):
        feats = _pyramid(2, 64, feat_dtype)
        boxes = _boxes(2, 200).to(cuda_device, box_dtype)
        out = pyramid_roi_align(feats, boxes, (7, 7), (1024, 1024))
        ref = pyramid_roi_align_plain(feats, boxes, (7, 7), (1024, 1024))
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def test_roi_align_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    feats = _pyramid(1, 8, torch.float32)
    boxes = _boxes(1, 4).to(cuda_device, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        pyramid_roi_align([f.transpose(1, 2) for f in feats], boxes, (7, 7), (1024, 1024))
    with pytest.raises(ValueError, match="float32, float64 or bfloat16"):
        pyramid_roi_align([f.half() for f in feats], boxes, (7, 7), (1024, 1024))
    with pytest.raises(ValueError, match="boxes must be float32 or float64"):
        pyramid_roi_align(feats, boxes.half(), (7, 7), (1024, 1024))
    with pytest.raises(ValueError, match="multiple of 4"):
        pyramid_roi_align([f[..., :6].contiguous() for f in feats], boxes, (7, 7), (1024, 1024))
    # bfloat16 moves 8 channels per 16-byte vector
    with pytest.raises(ValueError, match="multiple of 8"):
        pyramid_roi_align([f[..., :4].to(torch.bfloat16) for f in feats], boxes, (7, 7),
                          (1024, 1024))
    with pytest.raises(ValueError, match="one dtype"):
        pyramid_roi_align([feats[0].to(torch.bfloat16)] + feats[1:], boxes, (7, 7),
                          (1024, 1024))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("case", ROI_CASES)
def test_roi_align_backward_kernel_matches_plain(cuda_device, dtype, case):
    """The backward kernels against the plain backward on the same card:
    within 1e-5 of the largest gradient (both sum in float32, in other
    orders; in bfloat16, where each sum is rounded once, within one
    bfloat16 ulp of the largest gradient), one counted launch per call
    (none without boxes), bit-equal across launches."""
    feats, boxes, crop, image = _roi_case(case, dtype)
    boxes = boxes.to(cuda_device, _box_dtype(dtype))
    b, n = boxes.shape[:2]
    g = torch.Generator().manual_seed(3)
    grad = torch.randn((b, n, *crop, feats[0].shape[-1]), generator=g).to(cuda_device, dtype)
    shapes = [tuple(f.shape[1:]) for f in feats]
    before = ROI_ALIGN_BACKWARD_KERNEL.launches
    out = pyramid_roi_align_backward(grad, boxes, shapes, crop, image, dtype)
    again = pyramid_roi_align_backward(grad, boxes, shapes, crop, image, dtype)
    assert ROI_ALIGN_BACKWARD_KERNEL.launches == before + 2 * (n > 0)
    ref = pyramid_roi_align_backward_plain(grad, boxes, shapes, crop, image, dtype)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref) if n else 0.0
    tol = (2.0 ** (math.floor(math.log2(max(scale, 1.0))) - 7) if dtype == torch.bfloat16
           else 1e-5 * max(scale, 1.0))
    for o, a, r in zip(out, again, ref):
        assert o.shape == r.shape and o.dtype == dtype
        assert torch.equal(o, a)
        assert float((o.float() - r.float()).abs().max()) <= tol
    if n == 0:
        assert all(float(o.abs().max()) == 0.0 for o in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", [7, 16])
def test_roi_align_backward_batch8_sampled(cuda_device, dtype, pool):
    """The backward kernels at the batch-8 train step's shapes (1024²
    pyramid, C=256, 100 ROIs per image) in the "sampled" layout, as the
    step pads them: 30 boxes 24-64 px on the top rows and 70 all-zero rows
    per image. Within the plain backward's tolerances above, bit-equal
    across launches."""
    rng = np.random.RandomState(8)
    b, n, c = 8, 100, 256
    size = rng.uniform(24, 64, (b, 30, 2))
    y1 = rng.uniform(0, 64, (b, 30)) - size[..., 0] / 2
    x1 = rng.uniform(0, 960, (b, 30))
    boxes = np.zeros((b, n, 4), np.float32)
    boxes[:, :30] = np.clip(np.stack([y1, x1, y1 + size[..., 0], x1 + size[..., 1]], -1),
                            0, 1024) / 1024
    boxes = torch.from_numpy(boxes).to(cuda_device)
    shapes = [(s, s, c) for s in (256, 128, 64, 32)]
    grad = torch.randn((b, n, pool, pool, c),
                       generator=torch.Generator().manual_seed(8)).to(cuda_device, dtype)
    args = (grad, boxes, shapes, (pool, pool), (1024, 1024), dtype)
    out = pyramid_roi_align_backward(*args)
    again = pyramid_roi_align_backward(*args)
    ref = pyramid_roi_align_backward_plain(*args)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref)
    tol = (2.0 ** (math.floor(math.log2(scale)) - 7) if dtype == torch.bfloat16
           else 1e-5 * scale)
    for o, a, r in zip(out, again, ref):
        assert o.shape == r.shape and o.dtype == dtype
        assert torch.equal(o, a)
        assert float((o.float() - r.float()).abs().max()) <= tol


def test_roi_align_autograd_uses_both_kernels(cuda_device):
    """Through autograd: the forward kernel once, the backward kernel once,
    no gradient into the boxes; the levels' gradient equals the backward
    wrapper's."""
    feats = [f.requires_grad_() for f in _pyramid(2, 64, torch.float32)]
    boxes = _boxes(2, 100).to(cuda_device, torch.float32)
    grad = torch.randn((2, 100, 16, 16, 64), device=cuda_device)
    counts = ROI_ALIGN_KERNEL.launches, ROI_ALIGN_BACKWARD_KERNEL.launches
    out = pyramid_roi_align(feats, boxes, (16, 16), (1024, 1024))
    out.backward(grad)
    assert (ROI_ALIGN_KERNEL.launches, ROI_ALIGN_BACKWARD_KERNEL.launches) == (
        counts[0] + 1, counts[1] + 1)
    ref = pyramid_roi_align_backward(grad, boxes, [tuple(f.shape[1:]) for f in feats],
                                     (16, 16), (1024, 1024), torch.float32)
    for f, r in zip(feats, ref):
        assert torch.equal(f.grad, r)
    with torch.no_grad():
        before = ROI_ALIGN_BACKWARD_KERNEL.launches
        assert not pyramid_roi_align(feats, boxes, (7, 7), (1024, 1024)).requires_grad
        assert ROI_ALIGN_BACKWARD_KERNEL.launches == before


OP_CASES = [("nms_sorted_batched", 0), ("nms_sorted_batched", 1), ("roi_align", 0),
            ("roi_align", 1), ("roi_align_backward", 0), ("roi_align_backward", 1)]


@pytest.mark.parametrize("name,case", OP_CASES)
def test_opcheck_on_cuda(cuda_device, name, case):
    """Each custom op on CUDA inputs passes ``torch.library.opcheck``: the
    fake implementation against the kernel, the schema, autograd, AOT
    dispatch."""
    args, kwargs = library_op_samples(cuda_device)[name][case]
    results = torch.library.opcheck(getattr(torch.ops.sln_amodal, name).default, args, kwargs)
    assert set(results.values()) == {"SUCCESS"}, results


class _TwoOps(torch.nn.Module):
    def forward(self, boxes, valid, feats, rois):
        keep, keep_valid = nms_sorted_batched(boxes, valid, 20, 0.5)
        return keep, keep_valid, pyramid_roi_align(feats, rois, (5, 5), (128, 128))


def test_exported_program_launches_the_kernels(cuda_device):
    """A program exported on the card holds the ops, and running it
    launches (and counts) each kernel, with the eager outputs."""
    samples = library_op_samples(cuda_device)
    (boxes, valid, *_), _ = samples["nms_sorted_batched"][0]
    (feats, rois, *_), _ = samples["roi_align"][0]
    args = (boxes, valid, [f.detach() for f in feats], rois)
    program = torch.export.export(_TwoOps(), args, strict=False).module()
    counts = NMS_KERNEL.launches, ROI_ALIGN_KERNEL.launches
    got = program(*args)
    assert (NMS_KERNEL.launches, ROI_ALIGN_KERNEL.launches) == (counts[0] + 1, counts[1] + 1)
    want = _TwoOps()(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


SMALL = dict(image_size=128, backbone="resnet50", glm_input_size=65, pre_nms_limit=400,
             post_nms_rois_inference=64, compute_dtype="float64", param_dtype="float64")


def detecting_weights(cfg):
    """Seeded weights whose random heads keep their outputs O(1): spread
    scores, small deltas, foreground-leaning classes."""
    sd = init_params(cfg, seed=0, device="cpu")
    for key, s in (("rpn.conv_class.weight", 1e-3), ("rpn.conv_bbox.weight", 1e-4),
                   ("classifier.linear_class.weight", 1e-2),
                   ("classifier.linear_bbox.weight", 1e-3)):
        sd[key] = sd[key] * s
    sd["classifier.linear_class.bias"][1] = 2.0
    return sd


def test_detector_on_card_matches_cpu(cuda_device):
    """The whole slice in float64 on the card (kernels) and on the CPU
    (plain versions), same seeded weights: equal boxes and classes."""
    cfg = Config(detection_max_instances=8, **SMALL)
    sd = detecting_weights(cfg)
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


def test_mesh_detector_two_replicas_on_one_card(cuda_device):
    """``Detector(mesh=(card, card))``: two replicas on the one card, a
    ragged batch of 3 padded to 4 and split in two blocks (one NMS launch
    each), equal to the ``Detector`` without a mesh on the same images
    (float64: boxes and classes equal, scores and masks to rounding)."""
    cfg = Config(detection_max_instances=8, **SMALL)
    sd = detecting_weights(cfg)
    rng = np.random.RandomState(1)
    images = [rng.randint(0, 255, (128, 128, 3), np.uint8) for _ in range(3)]
    single = Detector(cfg, sd, device=cuda_device)
    mesh = Detector(cfg, sd, mesh=(cuda_device, cuda_device))
    assert len(mesh._replicas) == 2 and mesh._replicas[0] is not mesh._replicas[1]
    det, masks = single._fetch(single.dispatch(images))
    before = NMS_KERNEL.launches
    pending = mesh.dispatch(images)
    det_m, masks_m = mesh._fetch(pending)
    assert NMS_KERNEL.launches == before + 2 and det_m.shape[0] == 4
    assert (det[..., 4] > 0).sum() > 0
    np.testing.assert_array_equal(det_m[:3, ..., :5], det[..., :5])
    np.testing.assert_allclose(det_m[:3, ..., 5], det[..., 5], rtol=1e-6)
    np.testing.assert_allclose(masks_m[:3], masks, rtol=1e-5, atol=1e-6)
    assert len(mesh.collect(pending)) == 3


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_nccl_world_one_step_equals_plain_step(cuda_device):
    """In a one-process NCCL group the optimizer averages the gradients
    (a sum of one, a division by 1) and the logged losses: the step equals
    the plain one bit for bit (128², float64, deterministic algorithms)."""
    import torch.distributed as dist

    from sln_amodal_tpu_torch.models.sln import SLNAmodal
    from sln_amodal_tpu_torch.parallel import multihost
    from sln_amodal_tpu_torch.profile_train import make_batch
    from sln_amodal_tpu_torch.train.optim import StagedSGD
    from sln_amodal_tpu_torch.train.trainer import step_uniforms, to_device, train_step
    from sln_amodal_tpu_torch.utils.synthetic import rpn_biased_variables

    cfg = Config(**dict(SMALL, post_nms_rois_training=64, train_rois_per_image=16,
                        max_gt_instances=8, batch_size=2))
    sd = rpn_biased_variables(init_params(cfg, seed=0, device="cpu"))
    batch = to_device(make_batch(cfg, 2, 0), cuda_device)
    uniforms = step_uniforms(torch.Generator().manual_seed(0), 2, cfg.post_nms_rois_training)

    def step():
        model = SLNAmodal(cfg, device=cuda_device)
        model.load_state_dict(sd)
        before = (NMS_KERNEL.launches, ROI_ALIGN_BACKWARD_KERNEL.launches)
        losses = train_step(model, StagedSGD(model, "all", 1e-3), batch, uniforms=uniforms)
        assert (NMS_KERNEL.launches, ROI_ALIGN_BACKWARD_KERNEL.launches) == \
            (before[0] + 1, before[1] + 2)
        return ({k: float(v) for k, v in losses.items()},
                {k: v.detach().cpu() for k, v in model.named_parameters()})

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        plain = step()
        multihost.init_group(f"localhost:{free_port()}", 1, 0, "nccl")
        try:
            assert dist.get_backend() == "nccl" and multihost.process_count() == 1
            grouped = step()
        finally:
            multihost.shutdown()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    assert grouped[0] == plain[0]
    moved = 0
    for k, v in plain[1].items():
        assert torch.equal(grouped[1][k], v), k
        moved += int(not torch.equal(v, sd[k]))
    assert moved > 0
