"""A configuration's trunk, found by name: ``<backbone>.py`` in this
directory, where ``<backbone>`` is the configuration file's ``backbone``.
A new trunk family is a new file here and nothing else; files whose name
begins with ``_`` are modules the trunk files share, not trunks.

A trunk file is loaded as :func:`harness.reader` loads a metric (by path,
with absolute imports of ``h100bench``) and provides:

- ``network(cfg) -> nn.Module``: the reference's ``fpn`` module, the trunk
  and the FPN neck, NHWC image in, NHWC P2..P6 out. The neck keeps the
  names ``P{l}_conv1`` and ``P{l}_conv2`` (a ``Sequential`` whose ``[1]``
  is the smoothing conv: the weight recipe rescales it); ``_fpn.FPN`` is
  such a neck. Every convolution and matrix product takes its operands
  through ``lowp.quantize`` (``model.Conv2d``, ``model.Linear``), so the
  float8 control covers the trunk.
- ``flop_layers(cfg, trained_levels=()) -> (layers, levels)``: the
  ``flops.Layer`` list of the trunk and neck at ``cfg["image_size"]`` and
  the sizes of P2..P6; ``trained_levels`` names the pyramid levels (2..5,
  the trunk's outputs C2..C5) whose trunk weights train, as the training
  stage ``4+`` trains levels 4 and 5.
- ``trained_pattern(levels) -> str``: a regular expression over the
  network's parameter names (without the ``fpn.`` prefix) that matches
  the trunk's parameters of those levels.
- The trunk's part of the weight recipe (``weights.py``):
  ``start(fpn, sd, gen)`` sets, in ``sd`` (the network's own state-dict
  keys, tensors drawn or zeroed by ``weights.seeded``), every entry that
  the seeded draw of convolution and linear weights leaves at a wrong
  start, with ``gen`` for any further draw; ``branches(fpn)`` lists the
  keys of the weights that scale a residual branch (multiplied by
  ``weights.BRANCH_GAIN``); ``calibrated(fpn)`` lists the ``FrozenBN``
  modules whose statistics the calibration pass sets.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List

DIR = Path(__file__).resolve().parent
PROVIDES = ("network", "flop_layers", "trained_pattern", "start", "branches", "calibrated")
_LOADED: Dict[Path, object] = {}


def load(backbone: str):
    """The trunk file of ``backbone`` in :data:`DIR`, loaded once."""
    path = DIR / f"{backbone}.py"
    if path not in _LOADED:
        if backbone.startswith("_") or not path.is_file():
            raise FileNotFoundError(f"no trunk file {path} for backbone {backbone!r}")
        spec = importlib.util.spec_from_file_location(f"h100bench_trunk_{backbone}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        missing = [n for n in PROVIDES if not callable(getattr(mod, n, None))]
        if missing:
            raise AttributeError(f"trunk file {path} lacks {', '.join(missing)}")
        _LOADED[path] = mod
    return _LOADED[path]


def names() -> List[str]:
    """Every trunk in :data:`DIR`."""
    return sorted(p.stem for p in DIR.glob("*.py") if not p.stem.startswith("_"))
