"""Training step and staged training loop: port of the JAX package's
``train/trainer.py`` (``:37-70``, ``:126-305``).

One step: the training graph (:meth:`SLNAmodal.train_step_outputs`), the
six losses of each image averaged over the batch (:func:`batched_losses`),
the backward (through the RoIAlign backward kernel on the card), then the
stage's clipped SGD step (:class:`.optim.StagedSGD`), which with
``accumulate_steps > 1`` steps on every k-th micro-batch only.

Data parallelism is one process per card in a ``torch.distributed`` group
(``parallel/multihost.py``), each on its local batch: the optimizer
averages the gradients over the processes before the clip, the logged and
the validation losses are averaged too, and every process starts from
process 0's parameters. What the JAX package's sharded step computes on the
concatenated batch, this computes across the processes.

Randomness: the target layer's draws come from a ``torch.Generator``
seeded from ``(seed, epoch)``, so a run resumed at epoch k draws what an
uninterrupted run drew from epoch k on (the JAX package folds the epoch
into its key, ``trainer.py:211``). Every process draws the global batch's
uniforms and takes its own rows (:func:`step_uniforms`), so N processes
sample the ROIs one process samples on their concatenated batches.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models.sln import SLNAmodal, TrainingOutputs
from ..parallel import multihost
from ..utils.logging import StepTimer, log
from . import checkpoint as ckpt_lib
from . import losses as losses_lib
from .optim import Stage, StagedSGD, StageSchedule

BATCH_KEYS = ("images", "rpn_match", "rpn_deltas", "gt_class_ids", "gt_boxes", "gt_masks")


def batched_losses(out: TrainingOutputs, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over images of each image's six loss terms and total."""
    per = [losses_lib.total_loss(
        rpn_match=batch["rpn_match"][i],
        rpn_target_deltas=batch["rpn_deltas"][i],
        rpn_logits=out.rpn_logits[i],
        rpn_pred_deltas=out.rpn_deltas[i],
        target_class_ids=out.targets.class_ids[i],
        roi_valid=out.targets.valid[i],
        mrcnn_class_logits=out.class_logits[i],
        target_deltas=out.targets.deltas[i],
        mrcnn_pred_deltas=out.bbox_deltas[i],
        target_masks=out.targets.masks[i],
        mask_logits=out.mask_logits[i],
    ) for i in range(out.rpn_logits.shape[0])]
    return {k: torch.stack([p[k] for p in per]).mean() for k in per[0]}


def to_device(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A loader's batch on ``device``: numpy arrays are copied there,
    tensors already there pass through (GT boxes as float32, as the JAX
    package's step casts them)."""
    def tensor(v):
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))

    out = {k: tensor(batch[k]).to(device, non_blocking=True) for k in BATCH_KEYS}
    out["gt_boxes"] = out["gt_boxes"].to(torch.float32)
    return out


def loss_on(model: SLNAmodal, batch: Mapping[str, torch.Tensor],
            generator: Optional[torch.Generator] = None,
            uniforms=None) -> Dict[str, torch.Tensor]:
    """The batch's losses through the training graph; ``uniforms`` =
    (pos_uniform, neg_uniform) feeds the target layer's draws."""
    pos, neg = uniforms if uniforms is not None else (None, None)
    out = model.train_step_outputs(
        batch["images"], batch["gt_class_ids"], batch["gt_boxes"], batch["gt_masks"],
        generator=generator, pos_uniform=pos, neg_uniform=neg)
    return batched_losses(out, batch)


def mean_over_processes(losses: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached losses, averaged over the process group (one all-reduce) when
    there is one: the global batch's mean, equal on every process."""
    if not multihost.is_distributed():
        return {k: v.detach() for k, v in losses.items()}
    keys = sorted(losses)
    values = torch.stack([losses[k].detach() for k in keys])
    multihost.all_reduce_mean_([values])
    return dict(zip(keys, values.unbind()))


def train_step(model: SLNAmodal, optimizer: StagedSGD, batch: Mapping[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               uniforms=None) -> Dict[str, torch.Tensor]:
    """One forward -> losses -> backward -> optimizer step (averaged over
    the processes, accumulated, clipped); returns the losses (device
    tensors, detached, averaged over the processes)."""
    losses = loss_on(model, batch, generator, uniforms)
    optimizer.zero_grad()
    losses["total"].backward()
    optimizer.step()
    return mean_over_processes(losses)


def step_uniforms(generator: torch.Generator, batch_size: int, rois: int):
    """This process's rows (pos, neg) [batch_size, rois] of the target
    layer's uniforms for the global batch of ``batch_size`` rows per
    process: every process draws all of them from the same generator. One
    process draws what the target layer draws itself."""
    rank, world = multihost.process_index(), multihost.process_count()
    draws = torch.rand((2, batch_size * world, rois), generator=generator, dtype=torch.float32)
    rows = draws[:, rank * batch_size:(rank + 1) * batch_size]
    return rows[0], rows[1]


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """The target layer's generator of one epoch, from (seed, epoch)."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


class Trainer:
    """Staged training of one model on one device, one of the processes of
    a data-parallel run if there is a process group (the reference's
    ``train_model``). ``state_dict`` has the reference layout; in a group,
    process 0's is broadcast to the others."""

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.model = SLNAmodal(config, device=self.device)
        self.model.load_state_dict(state_dict, strict=True)
        if multihost.is_distributed():
            multihost.broadcast_(self.model.state_dict().values())
        self.epoch = 0
        self.optimizer: Optional[StagedSGD] = None
        self.step = 0               # steps of the current stage

    def train_stage(self, loader: Iterable, stage: Stage, learning_rate: float,
                    epochs: int, steps_per_epoch: Optional[int] = None, seed: int = 0,
                    on_epoch_end: Optional[Callable[[int], None]] = None,
                    accumulate_steps: int = 1, resume_state_path: Optional[str] = None,
                    start_epoch: int = 0) -> Dict[str, float]:
        """Epochs ``start_epoch .. epochs - 1`` of one stage, with a fresh
        optimizer (momentum zero, step 0) unless ``resume_state_path`` (a
        ``.state`` file of :func:`checkpoint.save_train_state`) restores the
        parameters, the momentum, the accumulated gradients and the step
        counter of a run cut in the middle of the stage. A step is one
        micro-batch: the parameters move on every ``accumulate_steps``-th.
        Returns the last logged losses."""
        cfg = self.config
        steps = steps_per_epoch or cfg.steps_per_epoch
        self.optimizer = StagedSGD(
            self.model, stage, learning_rate, momentum=cfg.learning_momentum,
            weight_decay=cfg.weight_decay, clip_norm=cfg.gradient_clip_norm,
            accumulate_steps=accumulate_steps)
        self.step = 0
        if resume_state_path is not None:
            self.step = ckpt_lib.restore_train_state(resume_state_path, self.model,
                                                     self.optimizer)
        stage_name = stage if isinstance(stage, str) else "custom-mask"
        last: Dict[str, float] = {}
        it = iter(loader)
        timer = StepTimer()
        for epoch in range(start_epoch, epochs):
            log(f"Stage '{stage_name}' epoch {epoch + 1}/{epochs} lr={learning_rate}")
            generator = epoch_generator(seed, epoch)
            for step in range(steps):
                batch = to_device(next(it), self.device)
                uniforms = step_uniforms(generator, batch["images"].shape[0],
                                         cfg.post_nms_rois_training)
                losses = train_step(self.model, self.optimizer, batch, uniforms=uniforms)
                self.step += 1
                if step % 50 == 0 or step == steps - 1:
                    last = {k: float(v) for k, v in losses.items()}
                    dt = timer.tick()
                    log(f"  step {step + 1}/{steps} "
                        + " ".join(f"{k}={v:.4f}" for k, v in sorted(last.items()))
                        + f" ({dt:.2f}s)")
            self.epoch += 1
            if on_epoch_end is not None:
                on_epoch_end(self.epoch)
        return last

    @torch.no_grad()
    def validate(self, loader: Iterable, steps: Optional[int] = None,
                 seed: int = 1) -> Dict[str, float]:
        """Mean losses over ``steps`` validation batches; no update. In a
        process group each process runs its own batches, and each step's
        losses are averaged over the processes, as the sharded JAX
        validation averages over the global batch."""
        steps = steps or self.config.validation_steps
        generator = torch.Generator().manual_seed(seed)
        totals: Dict[str, float] = {}
        it = iter(loader)
        for _ in range(steps):
            batch = to_device(next(it), self.device)
            uniforms = step_uniforms(generator, batch["images"].shape[0],
                                     self.config.post_nms_rois_training)
            losses = mean_over_processes(loss_on(self.model, batch, uniforms=uniforms))
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + float(v)
        return {k: v / steps for k, v in totals.items()}

    def train(self, loader: Iterable, steps_per_epoch: Optional[int] = None,
              sticky_freeze: bool = False,
              on_epoch_end: Optional[Callable[[int], None]] = None,
              resume_epoch: int = 0, resume_state_path: Optional[str] = None,
              seed: int = 0) -> None:
        """The reference's three stages. ``resume_epoch`` skips the first N
        epochs of the schedule; where it lands inside a stage,
        ``resume_state_path`` restores that stage's momentum and step too (at
        a stage boundary a fresh stage has nothing more to restore). The
        model must already hold the resumed parameters."""
        sched = StageSchedule(self.config.learning_rate, sticky_freeze)
        done = resume_epoch
        self.epoch = resume_epoch
        for idx, (stage, lr, epochs) in enumerate(sched.stages):
            if done >= epochs:
                done -= epochs
                continue
            mask = sched.stage_mask(self.model, idx) if sticky_freeze else stage
            self.train_stage(loader, mask, lr, epochs, steps_per_epoch, seed=seed,
                             on_epoch_end=on_epoch_end,
                             resume_state_path=resume_state_path if done > 0 else None,
                             start_epoch=done)
            done = 0
            resume_state_path = None
