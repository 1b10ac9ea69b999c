"""A configuration's trunk is files found by name (``reference/trunks/``).

The fingerprint: for each configuration, the reference's state-dict keys
in order, the seeded draw, the calibrated inference and training weights
and the FLOP totals are those the benchmark had when the trunk was ResNet
code inside ``model.py``, ``flops.py`` and ``weights.py``. The weights'
digests are of the CPU's float32 arithmetic at one thread (the calibration
pass's convolutions sum in another order at other thread counts).

A stub trunk written only into a temporary directory builds, calibrates
and counts through the same code, so a new trunk family needs no edit to
a file the benchmark has.
"""

import hashlib
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import data, flops, harness, weights
from h100bench.reference import host, trunks
from h100bench.reference.model import Reference
from h100bench.reference.train import trained

from .tiny import CFG

SEED = 2 ** 31 + 77
# keys, seeded, inference weights, training weights (tiny size);
# inference and training FLOP totals (tiny size, then the published width)
PARENT = {
    "sln_r101": ("ca1ff7e1814cda87", "4f3b3c83aa37a007", "8b822a6069e8ca1a",
                 "5a5f89415f01e24c", 27966413184.0, 60134672768.0,
                 1699293481344.0, 3113571191168.0),
    "sln_r50": ("b7271d079afa5113", "e424285fca7af7d4", "318a4642994d5c1d",
                "7f30195fd5bb4367", 27360336256.0, 58316441984.0,
                1544137787776.0, 2648104110464.0),
}


def digest(sd):
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def calibration_image(cfg):
    images = data.image_pool(SEED, 4, [[48, 64], [64, 48]])
    return torch.from_numpy(host.mold(images[0], cfg["image_size"]).copy())[None]


@pytest.mark.parametrize("config", sorted(PARENT))
def test_fingerprint_is_unchanged(config):
    want = PARENT[config]
    full = harness.config_file(config)
    cfg = dict(full, **CFG)
    with torch.device("meta"):
        keys = [(k, list(v.shape)) for k, v in Reference(cfg).state_dict().items()]
    assert hashlib.sha256(json.dumps(keys).encode()).hexdigest()[:16] == want[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = torch.device("cpu")
        calib = calibration_image(cfg)
        got = (digest(weights.seeded(Reference(cfg), SEED, cpu)),
               digest(weights.inference_weights(cfg, SEED, calib, cpu)),
               digest(weights.training_weights(cfg, SEED, calib, cpu)))
    finally:
        torch.set_num_threads(threads)
    assert got == want[1:4]
    assert (flops.inference_flops(cfg)["total"], flops.training_flops(cfg)["total"],
            flops.inference_flops(full)["total"], flops.training_flops(full)["total"]) \
        == want[4:]


STUB = '''"""A stub trunk: a patchifying stem with a batch norm, then at each level
a LayerNorm and a residual two-layer MLP, and a strided merge between
levels. Its FLOP layers are those of inference."""

import torch.nn.functional as F
from torch import nn

from h100bench.flops import Layer, conv_flops
from h100bench.reference.model import Conv2d, FrozenBN, Linear, nchw
from h100bench.reference.trunks._fpn import FPN, PART, neck_layers

WIDTHS = (16, 32, 64, 128)


class Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = nn.LayerNorm(c)
        self.fc1 = Linear(c, 2 * c)
        self.fc2 = Linear(2 * c, c)

    def forward(self, x):
        y = self.fc2(F.gelu(self.fc1(self.norm(x.permute(0, 2, 3, 1)))))
        return x + y.permute(0, 3, 1, 2)


class Stub(FPN):
    def __init__(self, out):
        super().__init__()
        self.stem = nn.Sequential(Conv2d(3, WIDTHS[0], 4, stride=4), FrozenBN(WIDTHS[0]))
        self.blocks = nn.ModuleList(Block(c) for c in WIDTHS)
        self.merges = nn.ModuleList(Conv2d(a, b, 2, stride=2)
                                    for a, b in zip(WIDTHS, WIDTHS[1:]))
        self.add_neck(WIDTHS, out)

    def forward(self, x):
        y, cs = self.stem(nchw(x)), []
        for k, block in enumerate(self.blocks):
            y = block(self.merges[k - 1](y) if k else y)
            cs.append(y)
        return self.neck(*cs)


def network(cfg):
    return Stub(cfg["fpn_channels"])


def flop_layers(cfg, trained_levels=()):
    n = cfg["image_size"] // 4
    layers, sizes = [Layer(conv_flops(n, n, 3, WIDTHS[0], 4), PART)], []
    for k, c in enumerate(WIDTHS):
        if k:
            n //= 2
            layers.append(Layer(conv_flops(n, n, WIDTHS[k - 1], c, 2), PART))
        layers += [Layer(2.0 * n * n * c * 2 * c, PART)] * 2
        sizes.append((n, c, False))
    neck, levels = neck_layers(sizes, cfg["fpn_channels"], False)
    return layers + neck, levels


def trained_pattern(levels):
    return "|".join(rf"blocks\\.{k - 2}\\." for k in levels)


def start(fpn, sd, gen):
    for k in sd:
        if k.endswith("norm.weight"):
            sd[k].fill_(1.0)


def branches(fpn):
    return [k for k in fpn.state_dict() if k.endswith("fc2.weight")]


def calibrated(fpn):
    return [fpn.stem[1]]
'''


def tree(root: Path):
    return {str(p): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_trunk_is_files_only(tmp_path, monkeypatch):
    before = tree(harness.ROOT)
    (tmp_path / "stub.py").write_text(STUB)
    monkeypatch.setattr(trunks, "DIR", tmp_path)
    assert trunks.names() == ["stub"]
    cfg = dict(harness.config_file("sln_r50"), **CFG, backbone="stub")
    cpu = torch.device("cpu")
    ref = Reference(cfg)
    sd = weights.seeded(ref, SEED, cpu)
    assert list(sd)[0] == "fpn.stem.0.weight"
    assert all(float(sd[f"fpn.blocks.{k}.norm.weight"].min()) == 1.0 for k in range(4))
    assert {n for n, _ in trained(ref, "4+") if n.startswith("fpn.blocks.")} == \
        {f"fpn.blocks.{k}.{p}" for k in (2, 3) for p in
         ("norm.weight", "norm.bias", "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")}

    calib = calibration_image(cfg)
    ref.load_state_dict(weights.inference_weights(cfg, SEED, calib, cpu))
    assert float(ref.fpn.stem[1].running_var.min()) != 1.0       # calibrated
    with FlopCounterMode(display=False) as counter:
        cands, levels, prior = ref.candidates(calib)
        boxes = cands.boxes[cands.detections]
        ref.masks_at(levels, prior, boxes)
    assert torch.isfinite(cands.margin).all()
    assert float(cands.margin.std()) > 0.5
    want = flops.inference_flops(cfg, rois=int(cands.boxes.shape[0]),
                                 detections=int(boxes.shape[0]))
    assert counter.get_total_flops() == pytest.approx(want["total"], rel=1e-9)
    assert tree(harness.ROOT) == before
