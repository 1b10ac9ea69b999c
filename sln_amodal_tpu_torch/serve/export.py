"""Serving artifacts: the detect graph exported with ``torch.export``, and
the :class:`Detector` that runs it without the model code.

The port's counterpart of the JAX package's ``serve/export.py``, which
exports the jitted program as StableHLO. Here the artifact is a directory::

    model.pt2       torch.export.save of the program
                    (images_u8 [B, S, S, 3], windows [B, 4] f32) -> outputs,
                    the weights inside it
    manifest.json   format_version, config, batch, detect_only, device_type,
                    compute_dtype, torch_version, mesh_size, outputs

The program is the graph :class:`~sln_amodal_tpu_torch.infer.Detector`
launches: uint8 resized images in, the mean pixel subtracted on the device,
``infer_detect_only`` (``detect_only``) or ``infer`` (the GLM global label
too), the outputs as a tuple named by ``outputs``. The NMS and RoIAlign
kernels are in it as the custom ops of ``ops/library.py``, so the program
launches the kernels on the card and runs their plain versions on the CPU;
it is exported without decompositions, with the ATen ops the eager graph
runs, so it computes what :class:`Detector` computes bit for bit.

Device-bound constants (anchors, the mean pixel, ``arange`` devices) are
baked in on the export device: an artifact loads on the device type it was
exported on and refuses any other. The loading host needs the port's ops,
``config``, ``parallel.mesh`` and ``utils.image``, never
``sln_amodal_tpu_torch.models``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import Mapping, Optional, Sequence

import torch

from .. import ops  # noqa: F401  (registers the kernels' custom ops before a load)
from ..config import Config
from ..device import resolve_device
from ..infer import Detector, PendingDetect
from ..parallel.mesh import make_mesh

MODEL_FILE = "model.pt2"
MANIFEST_FILE = "manifest.json"
FORMAT_VERSION = 1


class _ServedGraph(torch.nn.Module):
    """uint8 images and float32 windows in, the graph's outputs out (a
    tuple): :class:`Detector`'s launch as one module."""

    def __init__(self, model, detect_only: bool):
        super().__init__()
        self.model = model
        self.detect_only = detect_only
        self.register_buffer("mean", torch.tensor(model.config.mean_pixel, dtype=torch.float32,
                                                  device=model.anchors.device))

    def forward(self, images_u8: torch.Tensor, windows: torch.Tensor):
        run = self.model.infer_detect_only if self.detect_only else self.model.infer
        return tuple(run(images_u8.to(torch.float32) - self.mean, windows))


def export_detector(
    config: Config,
    state_dict: Mapping[str, torch.Tensor],
    out_dir: str,
    *,
    batch: int = 8,
    detect_only: bool = True,
    device="cuda",
    mesh: Optional[Sequence] = None,
) -> str:
    """Export the detect graph of ``config`` with ``state_dict`` to
    ``out_dir`` (``model.pt2`` and ``manifest.json``); returns ``out_dir``.

    ``batch`` is the static serving batch (smaller requests are padded up
    by :class:`ServingDetector`); ``detect_only=False`` exports the full
    contract with the GLM global label. ``device`` is the card by default
    and raises without one; the artifact serves on that device type. With
    ``mesh`` (devices, ``parallel.mesh.make_mesh``) the artifact is the
    per-replica program at ``batch / len(mesh)``, exported on the mesh's
    first device, and loads over a mesh of the same size."""
    from ..models.sln import DetectOutputs, InferenceOutputs, SLNAmodal

    if mesh is not None:
        mesh = make_mesh(mesh)
        if batch % len(mesh):
            raise ValueError(f"batch {batch} not divisible by mesh size {len(mesh)}")
        device = mesh[0]
    dev = resolve_device(device)
    per_replica = batch // (len(mesh) if mesh is not None else 1)

    model = SLNAmodal(config, device=dev)
    model.load_state_dict(state_dict, strict=True)
    model.cast_weights_to_compute_dtype()      # as Detector holds them
    s = config.image_size
    example = (torch.zeros((per_replica, s, s, 3), dtype=torch.uint8, device=dev),
               torch.zeros((per_replica, 4), dtype=torch.float32, device=dev))
    with torch.no_grad():
        program = torch.export.export(_ServedGraph(model, detect_only), example, strict=False)

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, MODEL_FILE))
    manifest = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(config),
        "batch": batch,
        "detect_only": detect_only,
        "device_type": dev.type,
        "compute_dtype": config.compute_dtype,
        "torch_version": torch.__version__,
        "mesh_size": len(mesh) if mesh is not None else 1,
        "outputs": list((DetectOutputs if detect_only else InferenceOutputs)._fields),
    }
    with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def _config_from_manifest(fields: dict) -> Config:
    """The Config of a manifest: lists back to tuples (a Config is hashed),
    fields this Config does not have skipped, missing ones at their
    defaults."""
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in fields.items() if k in names})


class ServingDetector(Detector):
    """A :class:`Detector` that runs a loaded artifact in place of the model.

    Same ``dispatch`` / ``collect`` / ``collect_crops`` / ``detect`` API. A
    request of fewer images than the artifact's batch is padded up by
    repeating its last image (the pad rows are dropped before unmolding); a
    larger one raises. With a mesh, each device runs the per-replica
    program on its block of the batch."""

    def __init__(self, config: Config, programs: Sequence, device: torch.device, batch: int,
                 detect_only: bool, outputs: Sequence[str], mesh=None):
        self.config = config
        self.mesh = mesh
        self.device = device
        self.detect_only = detect_only
        self.last_global_label = None
        self.batch = batch
        self._programs = list(programs)
        self._outputs = collections.namedtuple("ServedOutputs", list(outputs))

    @classmethod
    def load(cls, artifact_dir: str, device=None, mesh: Optional[Sequence] = None
             ) -> "ServingDetector":
        """Load an artifact onto ``device`` (default: the device type it
        was exported on; another type raises, there is no fallback). A mesh
        artifact loads over ``mesh``, by default the first ``mesh_size``
        cards (on the CPU, the CPU ``mesh_size`` times); one copy of the
        program is placed on each distinct device."""
        with open(os.path.join(artifact_dir, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        kind = manifest["device_type"]
        mesh_size = int(manifest["mesh_size"])
        if mesh_size > 1 and mesh is None:
            mesh = ["cpu"] * mesh_size if kind == "cpu" else _first_cards(mesh_size)
        if mesh is not None:
            mesh = make_mesh(mesh)
            if len(mesh) != mesh_size:
                raise ValueError(f"the artifact was exported for a {mesh_size}-device mesh, "
                                 f"got {len(mesh)} devices")
            devices = list(mesh)
        else:
            devices = [resolve_device(device if device is not None else kind)]
        devices = [_indexed(d) for d in devices]
        if any(d.type != kind for d in devices):
            raise ValueError(f"the artifact was exported for {kind}; it does not run on "
                             f"{[str(d) for d in devices]}")
        path = os.path.join(artifact_dir, MODEL_FILE)
        modules = {}
        for d in devices:
            if d not in modules:
                program = torch.export.load(path)
                # the device the weights were exported on
                if next(iter(program.state_dict.values())).device != d:
                    from torch.export.passes import move_to_device_pass
                    program = move_to_device_pass(program, str(d))
                modules[d] = program.module()
        return cls(_config_from_manifest(manifest["config"]), [modules[d] for d in devices],
                   devices[0], batch=int(manifest["batch"]),
                   detect_only=bool(manifest["detect_only"]), outputs=manifest["outputs"],
                   mesh=mesh)

    def dispatch(self, images) -> PendingDetect:
        if len(images) > self.batch:
            raise ValueError(f"request batch {len(images)} > artifact batch {self.batch}; "
                             "split the request or re-export with a larger batch")
        return super().dispatch(images)

    def _launch(self, replica: int, images_u8: torch.Tensor, windows: torch.Tensor):
        """Replica ``replica``'s program on its block, padded up to the
        per-replica batch by repeating the last row; the pad rows of the
        outputs are dropped."""
        rows = images_u8.shape[0]
        pad = self.batch // len(self._programs) - rows
        if pad:
            images_u8 = torch.cat([images_u8, images_u8[-1:].expand(pad, *images_u8.shape[1:])])
            windows = torch.cat([windows, windows[-1:].expand(pad, -1)])
        out = self._programs[replica](images_u8, windows)
        return self._outputs(*(o[:rows] for o in out))


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the current card's index, so devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _first_cards(n: int):
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise ValueError(f"the artifact was exported for a {n}-device mesh; only {found} "
                         "card(s) available (pass mesh=)")
    return [torch.device("cuda", i) for i in range(n)]
