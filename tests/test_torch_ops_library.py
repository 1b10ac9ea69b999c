"""The kernels' custom ops (``ops/library.py``) on the CPU: each passes
``torch.library.opcheck`` (schema, fake implementation against the real
one, autograd registration, AOT dispatch), the gradient through
``sln_amodal::roi_align`` is ``pyramid_roi_align_backward_plain``'s, the
wrappers call the ops, and ``torch.export`` keeps each op as one node.
The same ``opcheck`` on CUDA inputs is in ``test_torch_cuda.py``."""

import pytest
import torch

from sln_amodal_tpu_torch.ops import library
from sln_amodal_tpu_torch.ops.nms import nms_sorted_batched_plain
from sln_amodal_tpu_torch.ops.nms_cuda import NMS_KERNEL, nms_sorted_batched
from sln_amodal_tpu_torch.ops.roi_align import (pyramid_roi_align_backward_plain,
                                                pyramid_roi_align_plain)
from sln_amodal_tpu_torch.ops.roi_align_cuda import (ROI_ALIGN_BACKWARD_KERNEL,
                                                     ROI_ALIGN_KERNEL, pyramid_roi_align,
                                                     pyramid_roi_align_backward)
from torch_port_helpers import library_op_samples

SAMPLES = library_op_samples("cpu")


@pytest.mark.parametrize("name,case", [(name, i) for name, cases in SAMPLES.items()
                                       for i in range(len(cases))])
def test_opcheck_on_cpu(name, case):
    args, kwargs = SAMPLES[name][case]
    op = getattr(torch.ops.sln_amodal, name).default
    results = torch.library.opcheck(op, args, kwargs)
    assert set(results.values()) == {"SUCCESS"}, results


def test_ops_live_in_one_namespace():
    assert library.NAMESPACE == "sln_amodal"
    for name in ("nms_sorted_batched", "roi_align", "roi_align_backward"):
        op = getattr(torch.ops.sln_amodal, name).default
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CPU")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CUDA")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_gradient_through_the_op_is_the_plain_backward(dtype):
    args, _ = SAMPLES["roi_align"][[torch.float32, torch.float64, torch.bfloat16].index(dtype)]
    feats, boxes, crop, image, _ = args
    feats = [f.detach().clone().requires_grad_() for f in feats]
    out = pyramid_roi_align(feats, boxes, crop, image)
    assert out.requires_grad and out.dtype == dtype
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(7), dtype=dtype)
    out.backward(grad)
    ref = pyramid_roi_align_backward_plain(grad, boxes, [tuple(f.shape[1:]) for f in feats],
                                           crop, image, dtype)
    assert boxes.grad is None
    for f, r in zip(feats, ref):
        assert f.grad.dtype == dtype and torch.equal(f.grad, r)


def test_no_gradient_state_under_no_grad():
    args, _ = SAMPLES["roi_align"][0]
    feats, boxes, crop, image, _ = args
    with torch.no_grad():
        out = pyramid_roi_align(feats, boxes, crop, image)
    assert not out.requires_grad and out.grad_fn is None
    plain = pyramid_roi_align([f.detach() for f in feats], boxes, crop, image)
    assert plain.grad_fn is None and torch.equal(out, plain)


def test_wrappers_are_the_ops_on_the_cpu():
    """On CPU tensors each wrapper returns its plain version's outputs and
    no kernel counts a launch."""
    counts = (NMS_KERNEL.launches, ROI_ALIGN_KERNEL.launches, ROI_ALIGN_BACKWARD_KERNEL.launches)
    (boxes, valid, max_out, thr, at_equal, pad), _ = SAMPLES["nms_sorted_batched"][0]
    got = nms_sorted_batched(boxes, valid, max_out, thr, at_equal, pad)
    want = nms_sorted_batched_plain(boxes, valid, max_out, thr, at_equal, pad)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    (feats, rois, crop, image, extra), _ = SAMPLES["roi_align"][1]
    feats = [f.detach() for f in feats]
    assert torch.equal(pyramid_roi_align(feats, rois, crop, image, extra),
                       pyramid_roi_align_plain(feats, rois, crop, image, extra))
    (grad, rois, heights, widths, crop, image, dtype), _ = SAMPLES["roi_align_backward"][1]
    shapes = [(h, w, grad.shape[-1]) for h, w in zip(heights, widths)]
    got = pyramid_roi_align_backward(grad, rois, shapes, crop, image, dtype)
    want = pyramid_roi_align_backward_plain(grad, rois, shapes, crop, image, dtype)
    assert isinstance(got, tuple) and all(torch.equal(g, w) for g, w in zip(got, want))
    assert counts == (NMS_KERNEL.launches, ROI_ALIGN_KERNEL.launches,
                      ROI_ALIGN_BACKWARD_KERNEL.launches)


def test_no_implementation_for_other_devices():
    """Only the CPU (plain version) and CUDA (kernel) have an
    implementation: the meta device computes shapes, nothing runs."""
    boxes = torch.zeros((2, 10, 4), device="meta")
    valid = torch.zeros((2, 10), dtype=torch.bool, device="meta")
    keep, keep_valid = nms_sorted_batched(boxes, valid, 7, 0.5)
    assert keep.shape == keep_valid.shape == (2, 7)
    assert (keep.dtype, keep_valid.dtype) == (torch.int32, torch.bool)
    feats = [torch.zeros((2, s, s, 8), dtype=torch.float64, device="meta") for s in (16, 8)]
    out = pyramid_roi_align(feats, boxes.double(), (3, 4), (64, 64))
    assert out.shape == (2, 10, 3, 4, 8) and out.dtype == torch.float64
    grads = pyramid_roi_align_backward(out, boxes, [(16, 16, 8), (8, 8, 8)], (3, 4), (64, 64),
                                       torch.float32)
    assert [tuple(g.shape) for g in grads] == [(2, 16, 16, 8), (2, 8, 8, 8)]
    assert all(g.dtype == torch.float32 for g in grads)


class _TwoOps(torch.nn.Module):
    def forward(self, boxes, valid, feats, rois):
        keep, keep_valid = nms_sorted_batched(boxes, valid, 20, 0.5)
        return keep, keep_valid, pyramid_roi_align(feats, rois, (5, 5), (128, 128))


def test_export_keeps_each_op_as_one_node():
    (boxes, valid, *_), _ = SAMPLES["nms_sorted_batched"][0]
    (feats, rois, *_), _ = SAMPLES["roi_align"][0]
    feats = [f.detach() for f in feats]
    args = (boxes, valid, feats, rois)
    program = torch.export.export(_TwoOps(), args, strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("sln_amodal.nms_sorted_batched.default") == 1
    assert targets.count("sln_amodal.roi_align.default") == 1
    assert not any("aten" in t for t in targets if "getitem" not in t), targets
    got, want = program.module()(*args), _TwoOps()(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
