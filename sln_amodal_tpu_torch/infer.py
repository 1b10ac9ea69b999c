"""High-level inference API: the reference's ``MaskRCNN.detect`` as a host
wrapper around :class:`~sln_amodal_tpu_torch.models.sln.SLNAmodal`.

The host molds inputs (PIL resize, uint8 upload; the mean pixel is
subtracted on the device) and unmolds outputs (box rescale, mask paste).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .models.sln import SLNAmodal
from .utils import image as image_utils


class PendingDetect(NamedTuple):
    """An in-flight detect batch: host inputs + device outputs."""

    images: List[np.ndarray]
    windows: np.ndarray
    out: Any


class Detector:
    """Runs the detection pipeline on raw images.

    Usage::

        det = Detector(config, state_dict)     # on the card
        results = det.detect([image])          # list of dicts, like reference

    ``state_dict`` has the reference layout (``convert.params_from_jax`` or
    ``convert.init_params``). ``detect_only=True`` (default) runs the graph
    for the ``detect()`` contract (rois/class_ids/scores/masks); pass False
    to also compute the GLM global label (``last_global_label``). ``device``
    is "cuda" by default and raises when no card is present, unless
    ``device="cpu"`` is passed.
    """

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 detect_only: bool = True, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.model = SLNAmodal(config, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        self.detect_only = detect_only
        self.last_global_label = None
        self._mean = torch.tensor(config.mean_pixel, dtype=torch.float32,
                                  device=self.device)

    def dispatch(self, images: List[np.ndarray]) -> PendingDetect:
        """Mold + launch the device work without waiting for it (CUDA
        launches are asynchronous)."""
        molded, windows = image_utils.mold_inputs(images, self.config)
        images_u8 = torch.from_numpy(molded).to(self.device)
        x = images_u8.to(torch.float32) - self._mean
        w = torch.as_tensor(windows, dtype=torch.float32, device=self.device)
        run = self.model.infer_detect_only if self.detect_only else self.model.infer
        return PendingDetect(images=images, windows=windows, out=run(x, w))

    def _fetch(self, pending: PendingDetect):
        out = pending.out
        if not self.detect_only:
            self.last_global_label = out.global_label.cpu().numpy()
        return out.detections.cpu().numpy(), out.masks.cpu().numpy()

    def collect(self, pending: PendingDetect) -> List[Dict[str, np.ndarray]]:
        """Wait for a dispatched batch and unmold it to the reference's
        per-image output contract."""
        detections, masks = self._fetch(pending)
        results = []
        for i, image in enumerate(pending.images):
            rois, class_ids, scores, full_masks = image_utils.unmold_detections(
                detections[i], masks[i], image.shape, pending.windows[i])
            results.append({"rois": rois, "class_ids": class_ids,
                            "scores": scores, "masks": full_masks})
        return results

    def collect_crops(self, pending: PendingDetect) -> List[Dict[str, Any]]:
        """Like :meth:`collect`, with masks as binary box crops (``"crops"``,
        a list of [h, w] uint8) instead of pasted [H, W, N] frames."""
        detections, masks = self._fetch(pending)
        results = []
        for i, image in enumerate(pending.images):
            rois, class_ids, scores, crops = image_utils.unmold_detections_parts(
                detections[i], masks[i], image.shape, pending.windows[i])
            results.append({"rois": rois, "class_ids": class_ids,
                            "scores": scores, "crops": crops,
                            "image_shape": image.shape})
        return results

    def detect(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """images: list of [H, W, 3] uint8 arrays (any sizes).

        Returns, per image: dict(rois [N, 4] px, class_ids [N], scores [N],
        masks [H, W, N]) — the reference's output contract."""
        return self.collect(self.dispatch(images))
