"""High-level inference API: the reference's ``MaskRCNN.detect`` as a host
wrapper around :class:`~sln_amodal_tpu_torch.models.sln.SLNAmodal`.

The host packs the raw frames (``utils/image.py::mold_inputs``) and
uploads them; the card squash-resizes them to the model's square frame
(``sln_amodal::resize_bilinear_u8``, bit-equal to PIL's bilinear) and
subtracts the mean pixel. The host unmolds outputs (box rescale, mask
paste).
On the card the device program runs as one captured CUDA graph per shape
(``compiled.py``), as the JAX package runs it as one jitted program. With a
mesh (``parallel/mesh.py``) each batch is split over its devices, one
replica of the model on each.

Each ``dispatch`` is a request, numbered from 0 per ``Detector``; its
spans (``utils/profiling.py``) carry that id: ``detector.dispatch`` with
``detector.mold`` (the packing), ``detector.upload`` (the raw bytes and the
windows), ``detector.resize`` (the op's launch: ``images``, ``launches`` of
its kernel) and ``detector.replay`` inside it,
and ``detector.collect`` with ``detector.wait`` and one
``detector.unmold`` per image. ``detector.wait`` is the host blocked on the
card: the outputs' copy to the host waits for all the work queued on the
launching stream (in a pipelined loop, the next batch's too), then copies.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .compiled import CapturedProgram, CudaGraphs
from .config import Config
from .device import resolve_device
from .ops.resize_cuda import RESIZE_KERNEL, resize_bilinear_u8
from .parallel.mesh import make_mesh
from .utils import image as image_utils
from .utils import profiling


class PendingDetect(NamedTuple):
    """An in-flight detect batch: host inputs + device outputs (with a
    mesh, a list of each device's outputs, pad rows included) and the
    dispatch's request id."""

    images: List[np.ndarray]
    windows: np.ndarray
    out: Any
    request: Optional[int] = None


def _frame_blocks(packed: np.ndarray, table: np.ndarray, windows: np.ndarray, devices):
    """The batch as one contiguous row block per device: [(the raw bytes of
    its frames on the device, their host table rebased to those bytes, its
    float32 windows on the device)]. The rows split evenly."""
    per = len(table) // len(devices)
    blocks = []
    for i, dev in enumerate(devices):
        rows = table[i * per:(i + 1) * per]
        start, end = rows[:, 0].min(), (rows[:, 0] + rows[:, 1] * rows[:, 2] * 3).max()
        blocks.append((torch.from_numpy(packed[start:end]).to(dev),
                       torch.from_numpy(rows - np.array([start, 0, 0])),
                       torch.as_tensor(windows[i * per:(i + 1) * per], dtype=torch.float32,
                                       device=dev)))
    return blocks


def _program(model, mean: torch.Tensor, detect_only: bool):
    """The device program of one replica: uint8 images and float32 windows
    in, the model's outputs out."""
    run = model.infer_detect_only if detect_only else model.infer

    def program(images_u8: torch.Tensor, windows: torch.Tensor):
        return run(images_u8.to(torch.float32) - mean, windows)

    return program


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
    repeating its last raw image, then uploads, resizes and launches each
    device's row block from this thread; ``collect`` walks only the real
    images.

    On a card, each replica's program (the mean subtraction and the model's
    ``infer_detect_only`` or ``infer``) is captured as a CUDA graph at the
    first ``dispatch`` of each shape and replayed after that
    (``compiled.CapturedProgram``, one per replica in ``programs``; the
    graphs of one ``Detector`` share a memory pool). A capture that fails
    raises. On the CPU the program runs eagerly. ``SLNAmodal.infer`` /
    ``infer_detect_only``, called directly, stay the eager graph.
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
        graphs = CudaGraphs()
        self.programs = [
            CapturedProgram(_program(model, mean, detect_only), graphs)
            for model, mean in zip(self._replicas, self._mean)]

    def _launch(self, replica: int, images_u8: torch.Tensor, windows: torch.Tensor):
        """The program of replica ``replica`` on its block (uint8 images,
        float32 windows, on its device): a graph replay on a card."""
        key = (self.config.compute_dtype, self.detect_only)
        return self.programs[replica](key, images_u8, windows)

    dispatches = 0      # dispatch calls so far: the next request id

    def dispatch(self, images: List[np.ndarray]) -> PendingDetect:
        """Pack, upload, resize on the device and launch the device work
        without waiting for it (CUDA launches are asynchronous)."""
        request = self.dispatches
        self.dispatches += 1
        with profiling.span("detector.dispatch", request, images=len(images)):
            with profiling.span("detector.mold"):
                packed, table, windows = image_utils.mold_inputs(images, self.config)
            if self.mesh is not None:
                # splitting over the mesh needs a divisible batch: repeat the
                # last raw image (its table row); collect walks only the real
                # images
                pad = (-len(images)) % len(self.mesh)
                if pad:
                    table = np.concatenate([table, np.repeat(table[-1:], pad, axis=0)])
                    windows = np.concatenate([windows, np.repeat(windows[-1:], pad, axis=0)])
            devices = [self.device] if self.mesh is None else list(self.mesh)
            with profiling.span("detector.upload") as upload:
                blocks = _frame_blocks(packed, table, windows, devices)
                upload.count(bytes=sum(raw.nbytes + w.nbytes for raw, _, w in blocks))
            with profiling.span("detector.resize", images=len(table)) as resize:
                launched = RESIZE_KERNEL.launches
                frames = [resize_bilinear_u8(raw, rows, self.config.image_size)
                          for raw, rows, _ in blocks]
                resize.count(launches=RESIZE_KERNEL.launches - launched)
            with profiling.span("detector.replay"):
                out = [self._launch(i, f, block[2])
                       for i, (f, block) in enumerate(zip(frames, blocks))]
            return PendingDetect(images, windows, out[0] if self.mesh is None else out,
                                 request)

    def _fetch(self, pending: PendingDetect):
        def host(field):
            if self.mesh is None:
                return getattr(pending.out, field).cpu().numpy()
            return np.concatenate([getattr(o, field).cpu().numpy() for o in pending.out])

        with profiling.span("detector.wait") as span:
            if not self.detect_only:
                self.last_global_label = host("global_label")
            detections, masks = host("detections"), host("masks")
            span.count(bytes=detections.nbytes + masks.nbytes)
        return detections, masks

    def collect(self, pending: PendingDetect) -> List[Dict[str, np.ndarray]]:
        """Wait for a dispatched batch and unmold it to the reference's
        per-image output contract."""
        with profiling.span("detector.collect", pending.request, images=len(pending.images)):
            detections, masks = self._fetch(pending)
            results = []
            for i, image in enumerate(pending.images):
                with profiling.span("detector.unmold") as span:
                    rois, class_ids, scores, full_masks = image_utils.unmold_detections(
                        detections[i], masks[i], image.shape, pending.windows[i])
                    span.count(detections=len(rois))
                results.append({"rois": rois, "class_ids": class_ids,
                                "scores": scores, "masks": full_masks})
            return results

    def collect_crops(self, pending: PendingDetect) -> List[Dict[str, Any]]:
        """Like :meth:`collect`, with masks as binary box crops (``"crops"``,
        a list of [h, w] uint8) instead of pasted [H, W, N] frames."""
        with profiling.span("detector.collect", pending.request, images=len(pending.images)):
            detections, masks = self._fetch(pending)
            results = []
            for i, image in enumerate(pending.images):
                with profiling.span("detector.unmold") as span:
                    rois, class_ids, scores, crops = image_utils.unmold_detections_parts(
                        detections[i], masks[i], image.shape, pending.windows[i])
                    span.count(detections=len(rois))
                results.append({"rois": rois, "class_ids": class_ids,
                                "scores": scores, "crops": crops,
                                "image_shape": image.shape})
            return results

    def detect(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """images: list of [H, W, 3] uint8 arrays (any sizes).

        Returns, per image: dict(rois [N, 4] px, class_ids [N], scores [N],
        masks [H, W, N]) — the reference's output contract."""
        return self.collect(self.dispatch(images))
