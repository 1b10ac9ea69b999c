"""ResNet-50-FPN: blocks (3, 4, 6, 3)."""

from h100bench.reference.trunks import _resnet

BLOCKS = (3, 4, 6, 3)


def network(cfg):
    return _resnet.ResNetFPN(BLOCKS, cfg["fpn_channels"])


def flop_layers(cfg, trained_levels=()):
    return _resnet.flop_layers(cfg, BLOCKS, trained_levels)


trained_pattern = _resnet.trained_pattern
start = _resnet.start
branches = _resnet.branches
calibrated = _resnet.calibrated
