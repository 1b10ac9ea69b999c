"""The Swin-S trunk of the port (``models/swin.py``) and its window-attention
op (``sln_amodal::window_attention``) on the CPU, against the plain float32
Swin reference of ``tests/swin_reference.py``; the trunk in ``Detector``,
``init_params`` and the trainer; the benchmark's copy of the reference
(``h100bench/reference/trunks/swin_s.py``) against this one. The CUDA
kernel against the op's CPU path is in ``test_torch_cuda.py``."""

import math
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import swin_reference as ref
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params
from sln_amodal_tpu_torch.infer import Detector
from sln_amodal_tpu_torch.models.sln import SLNAmodal
from sln_amodal_tpu_torch.models.swin import SwinFPN, SwinSize
from sln_amodal_tpu_torch.ops.window_attention_cuda import (WINDOW_ATTENTION_KERNEL,
                                                            window_attention)
from sln_amodal_tpu_torch.profile_train import make_batch
from sln_amodal_tpu_torch.train.optim import StagedSGD
from sln_amodal_tpu_torch.train.trainer import Trainer
from torch_port_helpers import Batches, one_intra_op_thread  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# head size 32 as Swin-S, at a quarter of its width and depth
SMALL = SwinSize(embed=32, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8))
SMALL_REF = ref.SwinSize(patch=4, embed=SMALL.embed, depths=SMALL.depths, heads=SMALL.heads,
                         window=7, mlp_ratio=4)
CFG = dict(image_size=64, backbone="swin_s", glm_input_size=33, pre_nms_limit=200,
           post_nms_rois_training=40, post_nms_rois_inference=40, train_rois_per_image=8,
           detection_max_instances=8, compute_dtype="float32")


def seeded_reference(size, out, seed):
    """The reference with every LayerNorm and bias table away from its
    start, so that both take part in the comparison."""
    torch.manual_seed(seed)
    net = ref.SwinFPN(size, out)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "norm" in name:
                p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * torch.randn(p.shape))
            elif name.endswith("relative_position_bias_table"):
                p.copy_(0.5 * torch.randn(p.shape))
    return net


def port_state(net):
    return {ref.port_key(k): v for k, v in net.state_dict().items()}


# ------------------------------------------------------------------ op --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("grid", [(9, 11), (14, 7), (7, 7)])
def test_op_cpu_path_matches_reference_attention(dtype, shift, grid):
    """The op between the qkv and proj linears of a block equals the
    reference's pad, roll, partition, attention, reverse, roll back and crop.

    float32: within 1e-5. bfloat16: the qkv linear is a channel selection
    (q, k, v are x and two permutations of it), so the bfloat16 qkv the op
    reads is exactly the reference's float32 qkv; the op computes in float32
    and rounds its output once, so it lies within one bfloat16 unit (2^-8 of
    the largest output) of the reference."""
    h, w = grid
    heads, c = 2, 64
    gen = torch.Generator().manual_seed(h * 100 + w + shift)
    block = ref.SwinTransformerBlock(c, heads, window_size=7, shift_size=shift)
    block.H, block.W = h, w
    attn = block.attn
    x = torch.randn((2, h * w, c), generator=gen)
    with torch.no_grad():
        if dtype == torch.bfloat16:
            x = x.to(dtype).float()
            perm = [torch.randperm(c, generator=gen) for _ in range(2)]
            attn.qkv.weight.copy_(torch.cat([torch.eye(c), torch.eye(c)[perm[0]],
                                             torch.eye(c)[perm[1]]]))
            attn.qkv.bias.zero_()
        else:
            attn.qkv.weight.copy_(torch.randn(attn.qkv.weight.shape, generator=gen) / 8)
            attn.qkv.bias.copy_(torch.randn(attn.qkv.bias.shape, generator=gen) / 8)
        attn.relative_position_bias_table.copy_(
            torch.randn(attn.relative_position_bias_table.shape, generator=gen))
        attn.proj.weight.copy_(torch.eye(c))
        attn.proj.bias.zero_()
        want = block.attention(x, ref.attention_mask(h, w, 7, 3)).reshape(2, h, w, c)

        hp, wp = math.ceil(h / 7) * 7, math.ceil(w / 7) * 7
        padded = F.pad(x.reshape(2, h, w, c), (0, 0, 0, wp - w, 0, hp - h))
        qkv = F.linear(padded, attn.qkv.weight, attn.qkv.bias).to(dtype)
        before = WINDOW_ATTENTION_KERNEL.launches
        got = window_attention(qkv, attn.relative_position_bias_table, heads, 7, shift)
    assert WINDOW_ATTENTION_KERNEL.launches == before
    assert got.dtype == dtype and got.shape == (2, hp, wp, c)
    err = float((got[:, :h, :w].float() - want).abs().max())
    assert err <= (1e-5 if dtype == torch.float32 else 2 ** -8 * float(want.abs().max())), err


# --------------------------------------------------------------- trunk --

def test_trunk_with_fpn_matches_reference():
    """The port's Swin trunk and FPN neck against the reference's P2..P6:
    seeded weights, head size 32, depths (2, 2, 2, 2), a 224-square frame
    (grids 56, 28, 14 and 7: padded, unpadded and a single window), float32."""
    net = seeded_reference(SMALL_REF, 32, 0)
    port = SwinFPN(SMALL, 32)
    port.load_state_dict(port_state(net), strict=True)
    image = 60.0 * torch.randn((1, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = net(image), port(image)
    assert [tuple(p.shape) for p in got] == [(1, 56, 56, 32), (1, 28, 28, 32),
                                             (1, 14, 14, 32), (1, 7, 7, 32), (1, 4, 4, 32)]
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_benchmark_reference_copy_equals_this_one():
    """The benchmark's Swin-S reference (its products through
    ``lowp.quantize``, switched off) and this one, at Swin-S's widths and
    depth on a 64-square frame, give equal P2..P6 from the same float32
    weights."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from h100bench.reference import trunks

    net = seeded_reference(ref.SWIN_S, 16, 2)
    bench = trunks.load("swin_s").network({"fpn_channels": 16})
    bench.load_state_dict(port_state(net), strict=True)
    image = 60.0 * torch.randn((1, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for g, w in zip(bench(image), net(image)):
            assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())


# ------------------------------------------------ the model, end to end --

@pytest.fixture(scope="module")
def swin_weights():
    return init_params(Config(**CFG), seed=0, device="cpu")


def test_init_params_for_swin(swin_weights):
    """LayerNorm weights one and biases zero; bias tables drawn (std 0.02);
    the keys are the model's, under ``fpn.C1..C5`` and the neck's names."""
    sd = swin_weights
    norms = [k for k in sd if k.startswith("fpn.C") and ".norm" in k and k.endswith("weight")]
    assert len(norms) == 1 + 3 + 24 * 2 + 4
    assert all(torch.equal(sd[k], torch.ones_like(sd[k])) for k in norms)
    assert all(not sd[k.replace("weight", "bias")].any() for k in norms)
    tables = [k for k in sd if k.endswith("relative_position_bias_table")]
    assert len(tables) == 24
    drawn = torch.cat([sd[k].flatten() for k in tables])
    assert 0.018 < float(drawn.std()) < 0.022 and len(set(drawn.tolist())) > 0.99 * drawn.numel()
    assert "fpn.C3.merge.reduction.weight" in sd and "fpn.C3.merge.reduction.bias" not in sd
    assert "fpn.P2_conv2.1.weight" in sd and sd["fpn.P2_conv1.weight"].shape[1] == 96
    assert set(sd) == set(SLNAmodal(Config(**CFG), device="cpu").state_dict())


def test_tiny_detector_detect_on_swin_s(swin_weights):
    """``Detector.detect`` on the Swin-S trunk runs end to end on the CPU
    (the op's plain path) and returns the detect contract."""
    det = Detector(Config(**CFG), swin_weights, device="cpu")
    image = np.random.RandomState(0).randint(0, 255, (48, 64, 3), np.uint8)
    before = WINDOW_ATTENTION_KERNEL.launches
    (result,) = det.detect([image])
    assert WINDOW_ATTENTION_KERNEL.launches == before
    assert set(result) >= {"rois", "class_ids", "scores", "masks"}
    assert result["masks"].shape[:2] == image.shape[:2]
    assert np.isfinite(result["scores"]).all()


@pytest.mark.parametrize("stage", ["5+", "4+", "3+", "all"])
def test_trunk_training_stages_raise_on_swin(swin_weights, stage):
    model = SLNAmodal(Config(**CFG), device="cpu")
    with pytest.raises(ValueError, match="backward and drop path"):
        StagedSGD(model, stage, 1e-3)


def test_one_heads_step_on_swin(swin_weights):
    """The ``heads`` stage trains on the Swin trunk (frozen, as ResNet's):
    finite losses, the heads move and the trunk does not."""
    cfg = Config(**CFG)
    trainer = Trainer(cfg, swin_weights, device="cpu")
    losses = trainer.train_stage(Batches(make_batch(cfg, 1, 0)), "heads", 1e-3, epochs=1,
                                 steps_per_epoch=1)
    assert losses and all(math.isfinite(v) for v in losses.values())
    after = trainer.model.state_dict()
    assert torch.equal(after["fpn.C4.blocks.0.attn.qkv.weight"],
                       swin_weights["fpn.C4.blocks.0.attn.qkv.weight"])
    assert not torch.equal(after["classifier.linear_class.weight"],
                           swin_weights["classifier.linear_class.weight"])
