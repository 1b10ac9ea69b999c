"""Training: ``Trainer.train_stage(loader, stage, lr, ...)`` with the
``TrainLoader`` that ``cli/train.py::run_train`` builds by default, on a
COCOA-layout set of seeded JPEGs with sem-dist maps, as ``cli.train train
--stage <stage> --batch_size <batch>`` runs it.

Traffic parameters: ``pool`` images at the frame ``sizes``, ``regions``
per image in turn, ``batch``, ``stage``, ``warm_steps`` (the stage's first
steps: the eager step, the capture and the first replays, in set-up) and
``stretch_steps`` (the profiled steps after the window, in a traced run).

One ``train_stage`` call runs set-up, window and stretch: the feed that
wraps the loader marks them as the step loop asks for batches, and ends
the stage by raising :class:`WindowClosed`. The first three steps are the
ones the reference follows: their batches, the target layer's draws and
losses are kept, the momentum after the first (whence its gradient) and
the trained parameters after the third.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import data, flops, trace, weights
from ..reference import host
from ..reference.loader import LoaderCheck
from ..reference.model import Reference, anchors_of
from ..reference.train import sgd_steps

FOLLOWED = 3                    # steps the reference follows
NEGLIGIBLE = 1e-3               # a leaf whose reference gradient is under this share
                                # of the median leaf's moves by round-off alone


class WindowClosed(Exception):
    """Ends the stage's step loop when the window (and stretch) is over."""


class Cell:
    def __init__(self, ctx):
        self.ctx, self.t = ctx, ctx.traffic
        self.missing = 0
        self.profile = None
        self.kept = []           # (batch, uniforms, losses) of the first steps

    def setup(self):
        from sln_amodal_tpu_torch.data.dataset import AmodalDataset
        from sln_amodal_tpu_torch.data.pipeline import TrainLoader
        from sln_amodal_tpu_torch.train.trainer import Trainer

        ctx = self.ctx
        self.config = ctx.config.replace(batch_size=self.t["batch"])
        self.images = data.image_pool(ctx.seed, self.t["pool"], self.t["sizes"])
        self.regions = data.write_train_set(ctx.scratch, self.images, ctx.seed,
                                            self.t["regions"])
        dataset = AmodalDataset()
        dataset.load_amodal(ctx.scratch, "train", data_type="COCO")
        dataset.prepare()
        self.paths = [info["path"] for info in dataset.image_info]
        ctx.mark("data")
        calib = torch.from_numpy(host.mold(data.read_image(self.paths[0]),
                                           ctx.cfg["image_size"]).copy())[None]
        sd = weights.training_weights(ctx.cfg, ctx.seed, calib.to(ctx.device), ctx.device)
        ctx.mark("weights")
        self.trainer = Trainer(self.config, sd, device=ctx.device)
        ctx.mark("program")
        self.state = {k: v.cpu() for k, v in sd.items()}
        del sd
        self.loader = TrainLoader(dataset, self.config, seed=ctx.seed)
        run_step = self.trainer.run_step

        def kept(batch, uniforms):
            losses = run_step(batch, uniforms)
            if len(self.kept) < FOLLOWED:
                self.kept.append((batch, tuple(u.clone() for u in uniforms), losses))
            return losses

        self.trainer.run_step = kept

    def warm(self):
        """The stage's first steps run inside the window's call (the same
        trainer, step and loader); :meth:`window` marks where set-up ends."""

    def sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def feed(self, seconds: float, traced: bool):
        """The loader's batches, marking set-up, window and stretch."""
        names = [n for n, p in self.trainer.model.named_parameters()]
        stretch = contextlib.ExitStack()
        it = iter(self.loader)
        k, t0, closed = 0, None, None
        try:
            while True:
                if k == 1:
                    self.sync()
                    sgd = self.trainer.optimizer.sgd
                    self.momentum = {n: sgd.state[p]["momentum_buffer"].detach().cpu().clone()
                                     for n, p in zip(names, self.trainer.model.parameters())
                                     if p in sgd.state}
                if k == FOLLOWED:
                    self.sync()
                    self.after = {n: p.detach().cpu().clone() for n, p in
                                  self.trainer.model.named_parameters() if p.requires_grad}
                if k == self.t["warm_steps"]:
                    self.sync()
                    t0 = time.perf_counter()
                    self.window_start = (t0, k)
                if t0 is not None and closed is None and time.perf_counter() - t0 >= seconds:
                    self.sync()
                    closed = (time.perf_counter(), k)
                    self.window_end = closed
                    if not traced:
                        raise WindowClosed
                    self.profile = {}
                    stretch.enter_context(trace.profiled(self.profile))
                if closed is not None and k - closed[1] >= self.t["stretch_steps"]:
                    stretch.close()
                    raise WindowClosed
                a = time.perf_counter()
                batch = next(it)
                if traced:
                    self.waits.append((a, time.perf_counter()))
                k += 1
                yield batch
        finally:
            stretch.close()
            it.close()          # the loader's workers stop before its files go

    def run(self, seconds: float, traced: bool) -> Dict:
        self.waits = []
        stage, lr = self.t["stage"], self.config.learning_rate
        try:
            self.trainer.train_stage(self.feed(seconds, traced), stage, lr, 1,
                                     steps_per_epoch=10 ** 9, seed=self.ctx.seed)
        except WindowClosed:
            pass
        (t0, k0), (t1, k1) = self.window_start, self.window_end
        images = (k1 - k0) * self.t["batch"]
        return {"t0": t0, "t1": t1, "wall_s": t1 - t0, "images": images, "steps": k1 - k0,
                "attempted": images, "failed": 0,
                "metrics": {"train_images_per_s": images / (t1 - t0)}}

    def trace_spans(self, spans) -> None:
        spans.wrap(self.trainer, "run_step", "train.step")

    # --------------------------------------------------------------- judge --
    def judge(self):
        del self.trainer
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if len(self.kept) < FOLLOWED:
            self.missing = FOLLOWED - len(self.kept)
            return []
        images = [data.read_image(p) for p in self.paths]
        return [follow(self.ctx.cfg, self.state, self.kept, self.momentum, self.after,
                       self.t["stage"], images, self.regions, self.ctx.device)]

    def records(self, window, spans, profile) -> Dict:
        wait = [(n, a, b) for n, (a, b) in (("train.wait", w) for w in self.waits)]
        return {"window": window, "spans": spans.between(window["t0"], window["t1"])
                + [r for r in wait if r[1] >= window["t0"] and r[2] <= window["t1"]],
                "profile": self.profile or {},
                "flops_per_image": flops.training_flops(self.ctx.cfg)["total"],
                "stretch_steps": self.t["stretch_steps"],
                "backward": {"batch": self.t["batch"], "rois": self.ctx.cfg["train_rois_per_image"],
                             "pools": (self.ctx.cfg["pool_size"], self.ctx.cfg["mask_pool_size"]),
                             "levels": [(n, n, self.ctx.cfg["fpn_channels"]) for n in
                                        flops.trunk_fpn_layers(self.ctx.cfg)[1][:4]],
                             "bytes_per_element": 2}}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              reach: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norms, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger; leaves whose reference gradient ``reach`` is under
    ``NEGLIGIBLE`` of the median leaf's are left out."""
    norms = {n: float(want[n].norm()) for n in want}
    median = float(np.median(list(norms.values())))
    median_reach = float(np.median(list(reach.values())))
    gaps = {n: abs(float(got[n].norm()) - w) / max(w, median) for n, w in norms.items()
            if reach[n] >= NEGLIGIBLE * median_reach}
    worst = max(gaps, key=gaps.get)
    print(f"worst leaf {worst}: {gaps[worst]}, median leaf {np.median(list(gaps.values()))}",
          file=sys.stderr)
    return gaps


def follow(cfg, state, kept, momentum, after, stage, images, regions, device) -> Dict:
    """The training numbers: the loader's targets checked, and the three
    steps followed by the reference from the same weights, batches and
    draws."""
    check = LoaderCheck(cfg, images, regions, anchors_of(cfg))
    faults = sum(check.batch_faults(batch) for batch, _, _ in kept)
    want = reference_steps(cfg, state, kept, stage, device)
    wd = cfg["weight_decay"]
    # a parameter without momentum was never stepped: no gradient reached
    # the optimizer for it
    first = {n: momentum[n] - wd * state[n] if n in momentum else torch.zeros_like(state[n])
             for n in want[1]}
    after = {n: after.get(n, state[n]) for n in want[2]}
    got = ([float(losses["total"]) for _, _, losses in kept], first, after)
    log = {"program": [{k: float(v) for k, v in losses.items()} for _, _, losses in kept],
           "reference": want[3]}
    print("followed steps " + json.dumps(log), file=sys.stderr)
    return dict(compare(state, got, want), loader_faults=float(faults))


def reference_steps(cfg, state, kept, stage, device, half: bool = False):
    """The reference's three steps on the kept batches and draws: (losses,
    first clipped gradient, trained parameters after), on the CPU.
    ``half`` plants a fault: each batch's second half left out."""
    ref = Reference(cfg)
    ref.load_state_dict(state)
    ref = ref.to(device)
    batches, uniforms = [], []
    for batch, (pos, neg), _ in kept:
        b = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
        b["gt_boxes"] = b["gt_boxes"].float()
        if half:
            b = {k: v[: max(1, v.shape[0] // 2)] for k, v in b.items()}
        batches.append(b)
        uniforms.append((pos, neg))
    totals, first, params, terms = sgd_steps(ref, stage, batches, uniforms)
    return (totals, {n: g.cpu() for n, g in first.items()},
            {n: p.cpu() for n, p in params.items()}, terms)


def compare(state, got, want) -> Dict[str, float]:
    """``loss_gap``: the relative gap of the first step's loss;
    ``grad_gap``: the worst leaf's gap of the first gradient's norm;
    ``update_gap``: the median leaf's gap of the norm of the change over
    the steps (:func:`leaf_gaps`). The later steps' losses and the worst
    leaf's change are not compared: from the second step on the two sides
    start from weights that rounding already parted, and where an image's
    only positive ROIs hang on the order of nearly equal RPN scores, a
    reordering drops them on one side and its head losses with them (a
    seed read 0.23 of the loss and 0.24 of a classifier bias's change so,
    the program in eager and graphed form alike)."""
    losses, first, after = got[:3]
    want_losses, want_first, want_after = want[:3]
    reach = {n: float(g.norm()) for n, g in want_first.items()}
    changes = leaf_gaps({n: after[n] - state[n] for n in want_after},
                        {n: want_after[n] - state[n] for n in want_after}, reach)
    return {"loss_gap": abs(losses[0] - want_losses[0]) / abs(want_losses[0]),
            "grad_gap": max(leaf_gaps(first, want_first, reach).values()),
            "update_gap": float(np.median(list(changes.values())))}
