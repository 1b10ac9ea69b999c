"""High-level inference API: the reference's ``MaskRCNN.detect`` as a host
wrapper around :class:`~sln_amodal_tpu_torch.models.sln.SLNAmodal`.

The host molds inputs (PIL resize, uint8 upload; the mean pixel is
subtracted on the device) and unmolds outputs (box rescale, mask paste).
With a mesh (``parallel/mesh.py``) each batch is split over its devices,
one replica of the model on each.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .parallel.mesh import make_mesh, shard_batch
from .utils import image as image_utils


class PendingDetect(NamedTuple):
    """An in-flight detect batch: host inputs + device outputs (with a
    mesh, a list of each device's outputs, pad rows included)."""

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

    ``mesh`` (a tuple of devices, ``parallel.mesh.make_mesh``) turns on
    data-parallel serving and replaces ``device``: one replica of the model
    on each device of the mesh (two on a device listed twice), and each
    ``dispatch`` pads a ragged batch to a multiple of the mesh size by
    repeating its last image, then launches each device's row block from
    this thread; ``collect`` walks only the real images.
    """

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 detect_only: bool = True, device="cuda",
                 mesh: Optional[Sequence[torch.device]] = None):
        # imported here: a ServingDetector (serve/export.py) is a Detector
        # that runs without the model code
        from .models.sln import SLNAmodal

        self.config = config
        self.mesh = None if mesh is None else make_mesh(mesh)
        devices = [resolve_device(device)] if self.mesh is None else list(self.mesh)
        self._replicas = []
        for dev in devices:
            model = SLNAmodal(config, device=dev)
            model.load_state_dict(state_dict, strict=True)
            # the weights never change here: cast them to the compute dtype
            # once, not at every use
            self._replicas.append(model.cast_weights_to_compute_dtype())
        self.device, self.model = devices[0], self._replicas[0]
        self.detect_only = detect_only
        self.last_global_label = None
        self._mean = [torch.tensor(config.mean_pixel, dtype=torch.float32, device=dev)
                      for dev in devices]

    def _launch(self, replica: int, images_u8: torch.Tensor, windows: torch.Tensor):
        """The graph of replica ``replica`` on its block (uint8 images,
        float32 windows, on its device)."""
        model = self._replicas[replica]
        run = model.infer_detect_only if self.detect_only else model.infer
        return run(images_u8.to(torch.float32) - self._mean[replica], windows)

    def dispatch(self, images: List[np.ndarray]) -> PendingDetect:
        """Mold + launch the device work without waiting for it (CUDA
        launches are asynchronous)."""
        molded, windows = image_utils.mold_inputs(images, self.config)
        if self.mesh is None:
            out = self._launch(0, torch.from_numpy(molded).to(self.device),
                               torch.as_tensor(windows, dtype=torch.float32,
                                               device=self.device))
            return PendingDetect(images=images, windows=windows, out=out)
        # splitting over the mesh needs a divisible batch: repeat the last
        # row; collect walks only the real images
        pad = (-len(images)) % len(self.mesh)
        if pad:
            molded = np.concatenate([molded, np.repeat(molded[-1:], pad, axis=0)])
            windows = np.concatenate([windows, np.repeat(windows[-1:], pad, axis=0)])
        blocks = shard_batch((torch.from_numpy(molded),
                              torch.as_tensor(windows, dtype=torch.float32)), self.mesh)
        return PendingDetect(images=images, windows=windows,
                             out=[self._launch(i, *block) for i, block in enumerate(blocks)])

    def _fetch(self, pending: PendingDetect):
        def host(field):
            if self.mesh is None:
                return getattr(pending.out, field).cpu().numpy()
            return np.concatenate([getattr(o, field).cpu().numpy() for o in pending.out])
        if not self.detect_only:
            self.last_global_label = host("global_label")
        return host("detections"), host("masks")

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
