"""What the inference drivers share: the seeded image pool and weights, the
program's ``Detector``, the capture of the network outputs of sampled
answers, and the reference run that judges them."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import data, flops, judge, weights
from .reference import host
from .reference.model import Reference


class InferenceCell:
    """Base of the inference drivers. ``ctx`` is a ``harness.Context``;
    ``ctx.traffic`` holds ``pool`` (images) and ``sizes`` (frame sizes
    drawn from), ``batch`` and ``samples`` (answers judged per run)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.rng = np.random.default_rng([ctx.seed, 1])
        self.missing = 0
        self.captured: Dict = {}           # sample key -> (detections, masks)
        self.answers: Dict = {}            # sample key -> the program's host answer
        self.nms_pairs: Optional[int] = None

    # ------------------------------------------------------------ set-up --
    def build(self):
        from sln_amodal_tpu_torch.infer import Detector

        ctx = self.ctx
        self.images = data.image_pool(ctx.seed, self.t["pool"], self.t["sizes"])
        ctx.mark("images")
        calib = torch.from_numpy(host.mold(self.images[0], ctx.cfg["image_size"]).copy())[None]
        sd = weights.inference_weights(ctx.cfg, ctx.seed, calib.to(ctx.device), ctx.device)
        ctx.mark("weights")
        self.detector = Detector(ctx.config, sd, device=ctx.device)
        ctx.mark("program")
        # the reference is rebuilt from these after the window
        self.state = {k: v.cpu() for k, v in sd.items()}
        del sd

    def capture_outputs(self, key_of) -> None:
        """Keep the network outputs of the answers ``key_of(rows)`` names:
        ``key_of`` maps each row of a fetched batch to a sample key or None."""
        fetch = self.detector._fetch

        def kept(pending):
            dets, masks = fetch(pending)
            for row, key in enumerate(key_of(len(dets))):
                if key is not None:
                    self.captured[key] = (dets[row].copy(), masks[row].copy())
            return dets, masks

        self.detector._fetch = kept

    # ----------------------------------------------------------- judging --
    def reference(self) -> Reference:
        ref = Reference(self.ctx.cfg)
        ref.load_state_dict(self.state)
        return ref.to(self.ctx.device)

    def judge_samples(self, samples, host_check) -> List[Dict[str, float]]:
        """Judge each (key, image) in ``samples``: the network numbers, and
        ``host_check(key, image, detections, masks)`` as ``host_mismatch``.
        Frees the program first: the reference runs after it."""
        del self.detector
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = self.reference()
        out = []
        for key, image in samples:
            if key not in self.captured or key not in self.answers:
                self.missing += 1
                continue
            dets, masks = self.captured[key]
            nums = judge.network_numbers(ref, image, dets, masks, self.ctx.device)
            nums["host_mismatch"] = float(host_check(key, image, dets, masks))
            out.append(nums)
            self.nms_pairs = nums["nms_pairs"]
        return out

    # ----------------------------------------------------------- records --
    def base_records(self, window, spans, profile) -> Dict:
        cfg = self.ctx.cfg
        return {"window": window, "spans": spans.between(window["t0"], window["t1"]),
                "profile": profile, "flops_per_image": flops.inference_flops(cfg)["total"],
                "nms": {"batch": self.t["batch"], "n": cfg["pre_nms_limit"],
                        "max_out": cfg["post_nms_rois_inference"],
                        "pairs_per_image": self.nms_pairs}}
