"""High-level inference API: the reference's ``MaskRCNN.detect`` as a host
wrapper around one device program per device.

The host packs the raw frames (``utils/image.py::mold_inputs``) and
uploads them; the card squash-resizes them to the model's square frame
(``sln_amodal::resize_bilinear_u8``, bit-equal to PIL's bilinear) and
runs :class:`DeviceProgram` (the mean pixel subtracted, then the model).
The host unmolds outputs (box rescale, mask paste).
On the card the device program runs as one captured CUDA graph per shape
(``compiled.py``), as the JAX package runs it as one jitted program. Each
batch is split over the detector's devices, one program on each: one
device, or a mesh's (``parallel/mesh.py``).

Each ``dispatch`` is a request, numbered from 0 per ``Detector``; its
spans (``utils/profiling.py``) carry that id: ``detector.dispatch`` with
``detector.mold`` (the packing), ``detector.upload`` (the raw bytes and the
windows), ``detector.resize`` (the op's launch: ``images``, ``launches`` of
its kernel) and ``detector.replay`` inside it,
and ``detector.collect`` with ``detector.wait`` and one
``detector.unmold`` per image.

On a card, ``dispatch`` queues each device's copy of the fetched outputs
into fresh page-locked host tensors right after that device's replay, on
the same stream, and records an event behind it. ``detector.wait`` is the
host blocked on those events: it waits for the batch's own replay and
copy, never for work queued after them (in a pipelined loop, the next
batch's graph). Its count ``ready`` is 1 where every copy had landed as
the wait began, as it always has on the CPU.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

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
    """An in-flight detect batch: host inputs, the list of each device's
    outputs (pad rows included), the dispatch's request id and the fetched
    fields' host copies (``Detector._copy_to_host``; None: ``_fetch``
    copies them)."""

    images: List[np.ndarray]
    windows: np.ndarray
    out: List[Any]
    request: Optional[int] = None
    host: Optional[Tuple[Dict[str, torch.Tensor], List[Any]]] = None


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


class DeviceProgram(torch.nn.Module):
    """The device program of one replica, which :class:`Detector` captures
    and ``serve.export_detector`` exports: uint8 frames [B, S, S, 3] and
    float32 windows [B, 4] in, the mean pixel subtracted, the model's
    ``infer_detect_only`` (``detect_only``) or ``infer`` (the GLM global
    label too), a plain tuple out whose fields ``outputs`` names."""

    def __init__(self, model, detect_only: bool):
        from .models.sln import DetectOutputs, InferenceOutputs

        super().__init__()
        self.model = model
        self.detect_only = detect_only
        self.outputs = (DetectOutputs if detect_only else InferenceOutputs)._fields
        self.register_buffer("mean", torch.tensor(model.config.mean_pixel, dtype=torch.float32,
                                                  device=model.anchors.device))

    def forward(self, images_u8: torch.Tensor, windows: torch.Tensor):
        run = self.model.infer_detect_only if self.detect_only else self.model.infer
        return tuple(run(images_u8.to(torch.float32) - self.mean, windows))


class Detector:
    """Runs the detection pipeline on raw images.

    Usage::

        det = Detector(config, state_dict)     # on the card
        results = det.detect([image])          # list of dicts, like reference

    ``state_dict`` has the reference layout (``convert.params_from_jax`` or
    ``convert.init_params``). ``detect_only=True`` (default) runs the graph
    for the ``detect()`` contract (rois/class_ids/scores/masks); pass False
    to also compute the GLM global label (``last_global_label``, a row per
    real image). ``device`` is "cuda" by default and raises when no card is
    present, unless ``device="cpu"`` is passed.

    ``mesh`` (a tuple of devices, ``parallel.mesh.make_mesh``) turns on
    data-parallel serving and replaces ``device``: one replica of the model
    on each device of the mesh (two on a device listed twice). Without a
    mesh the detector runs on a device list of one. Each ``dispatch`` pads
    the request to a multiple of the device count (a served detector, to
    its fixed ``batch``) by repeating its last raw image's table row, then
    uploads, resizes and launches each device's row block from this thread;
    ``collect`` walks only the real images.

    On a card, each device's program (a :class:`DeviceProgram`, or a
    loaded artifact's) is captured as a CUDA graph at the first
    ``dispatch`` of each shape and replayed after that
    (``compiled.CapturedProgram``, one per device in ``programs``; the
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

        mesh = make_mesh(mesh) if mesh is not None else None
        devices = list(mesh or [resolve_device(device)])
        programs = []
        for dev in devices:
            model = SLNAmodal(config, device=dev)
            model.load_state_dict(state_dict, strict=True)
            # the weights never change here: cast them to the compute dtype
            # once, not at every use
            programs.append(DeviceProgram(model.cast_weights_to_compute_dtype(), detect_only))
        self._setup(config, devices, programs, detect_only, programs[0].outputs, mesh=mesh)
        self.model = programs[0].model

    def _setup(self, config: Config, devices: List[torch.device], programs: Sequence,
               detect_only: bool, outputs: Sequence[str], batch: Optional[int] = None,
               mesh=None):
        """The initialiser of both constructors: one program per device (a
        tuple of the fields ``outputs`` names out); ``batch``, the fixed
        batch each dispatch pads to (None: a multiple of the devices)."""
        self.config = config
        self.mesh = mesh
        self.devices = devices
        self.device = devices[0]
        self.detect_only = detect_only
        self.batch = batch
        self.last_global_label = None
        graphs = CudaGraphs()
        self.programs = [CapturedProgram(p, graphs) for p in programs]
        self._outputs = collections.namedtuple("DeviceOutputs", list(outputs))
        self._key = (config.compute_dtype, detect_only)

    dispatches = 0      # dispatch calls so far: the next request id

    def dispatch(self, images: List[np.ndarray]) -> PendingDetect:
        """Pack, upload, resize on the device and launch the device work
        without waiting for it (CUDA launches are asynchronous)."""
        if self.batch is not None and len(images) > self.batch:
            raise ValueError(f"request batch {len(images)} > artifact batch {self.batch}; "
                             "split the request or re-export with a larger batch")
        request = self.dispatches
        self.dispatches += 1
        with profiling.span("detector.dispatch", request, images=len(images)):
            with profiling.span("detector.mold"):
                packed, table, windows = image_utils.mold_inputs(images, self.config)
            # the devices split the rows evenly: pad rows repeat the last
            # raw image's table row (a device uploads its frames once);
            # collect walks only the real images
            n = len(self.devices)
            pad = (self.batch or -(-len(images) // n) * n) - len(images)
            table, windows = (np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                              for a in (table, windows))
            with profiling.span("detector.upload") as upload:
                blocks = _frame_blocks(packed, table, windows, self.devices)
                upload.count(bytes=sum(raw.nbytes + w.nbytes for raw, _, w in blocks))
            with profiling.span("detector.resize", images=len(table)) as resize:
                launched = RESIZE_KERNEL.launches
                frames = [resize_bilinear_u8(raw, rows, self.config.image_size)
                          for raw, rows, _ in blocks]
                resize.count(launches=RESIZE_KERNEL.launches - launched)
            with profiling.span("detector.replay"):
                out = [self._outputs(*program(self._key, f, block[2]))
                       for program, f, block in zip(self.programs, frames, blocks)]
            return PendingDetect(images, windows, out, request, self._copy_to_host(out))

    def _copy_to_host(self, out: List[Any]) -> Tuple[Dict[str, torch.Tensor], List[Any]]:
        """The fields ``_fetch`` returns, each as one host tensor of every
        row, and one event a device that marks the end of its copies. On a
        card the tensors are fresh page-locked ones (results keep views of
        them) and each device copies its row block into its slice without
        blocking, on the stream its replay ran on: behind that replay and
        ahead of later work. On the CPU the outputs as they are (a mesh's
        blocks joined) and no events."""
        fields = ("detections", "masks") + (() if self.detect_only else ("global_label",))
        devices = [o.detections.device for o in out]
        if devices[0].type != "cuda":
            # one device: its tensor as it is, no copy
            return {f: torch.cat([getattr(o, f) for o in out]) if len(out) > 1
                    else getattr(out[0], f) for f in fields}, []
        host = {}
        for f in fields:
            blocks = [getattr(o, f) for o in out]
            host[f] = torch.empty((sum(len(b) for b in blocks),) + tuple(blocks[0].shape[1:]),
                                  dtype=blocks[0].dtype, pin_memory=True)
            for rows, block in zip(host[f].split([len(b) for b in blocks]), blocks):
                rows.copy_(block, non_blocking=True)
        events = [torch.cuda.Event() for _ in devices]
        for event, dev in zip(events, devices):
            event.record(torch.cuda.current_stream(dev))
        return host, events

    def _fetch(self, pending: PendingDetect):
        """(detections, masks) as host arrays of every row, pad rows
        included; the real images' GLM global label to
        ``last_global_label``."""
        with profiling.span("detector.wait") as span:
            host, copied = pending.host or self._copy_to_host(pending.out)
            ready = all(event.query() for event in copied)
            for event in copied:
                event.synchronize()
            arrays = {f: t.numpy() for f, t in host.items()}
            if not self.detect_only:
                self.last_global_label = arrays["global_label"][:len(pending.images)]
            detections, masks = arrays["detections"], arrays["masks"]
            span.count(bytes=detections.nbytes + masks.nbytes, ready=int(ready))
        return detections, masks

    def _collect(self, pending: PendingDetect, unmold, fields) -> List[Dict[str, Any]]:
        """Wait for a dispatched batch and unmold each real image with
        ``unmold``; ``fields(image, masks)`` gives a result's entries beside
        rois, class_ids and scores."""
        with profiling.span("detector.collect", pending.request, images=len(pending.images)):
            detections, masks = self._fetch(pending)
            results = []
            for i, image in enumerate(pending.images):
                with profiling.span("detector.unmold") as span:
                    rois, class_ids, scores, image_masks = unmold(
                        detections[i], masks[i], image.shape, pending.windows[i])
                    span.count(detections=len(rois))
                results.append({"rois": rois, "class_ids": class_ids, "scores": scores,
                                **fields(image, image_masks)})
            return results

    def collect(self, pending: PendingDetect) -> List[Dict[str, np.ndarray]]:
        """Wait for a dispatched batch and unmold it to the reference's
        per-image output contract."""
        return self._collect(pending, image_utils.unmold_detections,
                             lambda image, masks: {"masks": masks})

    def collect_crops(self, pending: PendingDetect) -> List[Dict[str, Any]]:
        """Like :meth:`collect`, with masks as binary box crops (``"crops"``,
        a list of [h, w] uint8) instead of pasted [H, W, N] frames."""
        return self._collect(pending, image_utils.unmold_detections_parts,
                             lambda image, crops: {"crops": crops, "image_shape": image.shape})

    def detect(self, images: List[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """images: list of [H, W, 3] uint8 arrays (any sizes).

        Returns, per image: dict(rois [N, 4] px, class_ids [N], scores [N],
        masks [H, W, N]) — the reference's output contract."""
        return self.collect(self.dispatch(images))
