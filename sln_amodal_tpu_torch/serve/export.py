"""Serving artifacts: the detect graph exported with ``torch.export``, and
the :class:`Detector` that runs it without the model code.

The port's counterpart of the JAX package's ``serve/export.py``, which
exports the jitted program as StableHLO. Here the artifact is a directory::

    model.pt2       torch.export.save of the program
                    (images_u8 [B, S, S, 3], windows [B, 4] f32) -> outputs,
                    the weights inside it
    manifest.json   format_version, config, batch, detect_only, device_type,
                    compute_dtype, torch_version, mesh_size, outputs

The program is :class:`~sln_amodal_tpu_torch.infer.DeviceProgram`, the
module :class:`Detector` captures: uint8 resized images in, the mean pixel
subtracted on the device, ``infer_detect_only`` (``detect_only``) or
``infer`` (the GLM global label too), a tuple named by ``outputs``. The NMS and RoIAlign
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

import dataclasses
import json
import os
from typing import Mapping, Optional, Sequence

import torch

from .. import ops  # noqa: F401  (registers the kernels' custom ops before a load)
from ..config import Config
from ..device import resolve_device
from ..infer import DeviceProgram, Detector
from ..parallel.mesh import make_mesh

MODEL_FILE = "model.pt2"
MANIFEST_FILE = "manifest.json"
FORMAT_VERSION = 1


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
    from ..models.sln import SLNAmodal

    devices = make_mesh(mesh) if mesh is not None else (resolve_device(device),)
    if batch % len(devices):
        raise ValueError(f"batch {batch} not divisible by mesh size {len(devices)}")
    dev = devices[0]
    model = SLNAmodal(config, device=dev)
    model.load_state_dict(state_dict, strict=True)
    # the weights in the compute dtype, as Detector holds them
    graph = DeviceProgram(model.cast_weights_to_compute_dtype(), detect_only)
    s, rows = config.image_size, batch // len(devices)
    example = (torch.zeros((rows, s, s, 3), dtype=torch.uint8, device=dev),
               torch.zeros((rows, 4), dtype=torch.float32, device=dev))
    with torch.no_grad():
        # one eager call first: the constants the graph makes at first use
        # (the bfloat16 resize weights, the box std devs) are then tensors
        # on the device that the program holds, not host values it would
        # upload at every call (an upload that a CUDA graph cannot capture)
        graph(*example)
        program = torch.export.export(graph, example, strict=False)

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
        "mesh_size": len(devices),
        "outputs": list(graph.outputs),
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
    """A :class:`Detector` on a loaded artifact's program in place of the
    model, with the artifact's ``batch`` as its fixed batch: a request of
    fewer images is padded up by repeating its last image, a larger one
    raises. ``load`` ends in ``Detector``'s initialiser; the rest is
    :class:`Detector`'s (``programs``, the mesh, the captured graphs)."""

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
        if mesh is None and mesh_size > 1:
            mesh = ["cpu"] * mesh_size if kind == "cpu" else _first_cards(mesh_size)
        mesh = make_mesh(mesh) if mesh is not None else None
        devices = [_indexed(d) for d in mesh or [resolve_device(device or kind)]]
        if len(devices) != mesh_size:
            raise ValueError(f"the artifact was exported for a {mesh_size}-device mesh, "
                             f"got {len(devices)} devices")
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
        served = cls.__new__(cls)
        served._setup(_config_from_manifest(manifest["config"]), devices,
                      [modules[d] for d in devices], bool(manifest["detect_only"]),
                      manifest["outputs"], batch=int(manifest["batch"]), mesh=mesh)
        return served


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
