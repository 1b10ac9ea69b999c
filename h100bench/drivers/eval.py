"""Offline evaluation: ``cli/train.py::predict`` over a COCOA-layout set of
seeded JPEGs, as ``cli.train evaluate`` runs it.

Traffic parameters: ``pool`` images at the frame ``sizes``, ``batch``
images per device batch, ``ids_per_call`` image ids per ``predict`` call
(the pool cycled), ``samples`` answers judged per run. The window calls
``predict`` until ``--seconds`` have passed; ``eval_images_per_s`` is all
images of all calls over their whole wall time.
"""

from __future__ import annotations

import os
import time
from typing import Dict

from .. import data, judge
from ..inference import InferenceCell


class Cell(InferenceCell):
    def setup(self):
        from sln_amodal_tpu_torch.cli import train as cli_train
        from sln_amodal_tpu_torch.data.dataset import AmodalDataset

        self.cli = cli_train
        self.build()
        ann = data.write_coco_amodal(self.ctx.scratch, self.images)
        self.dataset = AmodalDataset()
        self.dataset.load_amodal(self.ctx.scratch, "val", data_type="COCO")
        self.dataset.prepare()
        self.ctx.mark("data")
        self.coco_ids = [r["id"] for r in ann["images"]]
        self.paths = [os.path.join(self.ctx.scratch, "val2014", r["file_name"])
                      for r in ann["images"]]
        n = self.t["ids_per_call"]
        self.ids = [i % self.t["pool"] for i in range(n)]
        self.positions = sorted(self.rng.choice(n, self.t["samples"], replace=False).tolist())
        self.call, self.batch_index = -1, 0
        batch = self.t["batch"]

        def key_of(rows):
            start = self.batch_index * batch
            self.batch_index += 1
            self.row = 0
            return [(self.call, start + r) if start + r in self.positions else None
                    for r in range(rows)]

        self.capture_outputs(key_of)
        build = cli_train.build_coco_results_crops

        def kept(*args):
            results = build(*args)
            position = (self.batch_index - 1) * batch + self.row
            self.row += 1
            if position in self.positions:
                self.answers[(self.call, position)] = results
            return results

        cli_train.build_coco_results_crops = kept
        self._restore = lambda: setattr(cli_train, "build_coco_results_crops", build)

    def predict(self, ids) -> None:
        self.call += 1
        self.batch_index = 0
        self.cli.predict(self.detector, self.dataset, ids, self.t["batch"], progress=False)

    def warm(self):
        self.predict(self.ids[: 2 * self.t["batch"]])
        self.captured.clear()
        self.answers.clear()
        self.call = -1

    def window(self, seconds: float) -> Dict:
        t0 = time.perf_counter()
        images = 0
        while True:
            self.predict(self.ids)
            images += len(self.ids)
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        self.calls = self.call + 1
        return {"t0": t0, "t1": t1, "wall_s": t1 - t0, "images": images,
                "batches": images // self.t["batch"], "attempted": images, "failed": 0,
                "metrics": {"eval_images_per_s": images / (t1 - t0)}}

    def trace_spans(self, spans) -> None:
        spans.wrap(self.cli, "load_batch", "eval.load")
        spans.wrap(self.cli, "coco_results", "eval.drain")
        spans.wrap(self.detector, "dispatch", "eval.dispatch")

    def stretch(self) -> None:
        self.predict(self.ids[: 4 * self.t["batch"]])

    def judge(self):
        self._restore()
        calls = self.rng.integers(0, self.calls, len(self.positions))
        samples = [((int(c), p), data.read_image(self.paths[self.ids[p]]))
                   for c, p in zip(calls, self.positions)]
        size = self.ctx.cfg["image_size"]

        def host_check(key, image, dets, masks):
            coco_id = self.coco_ids[self.ids[key[1]]]
            return judge.coco_mismatch(image, coco_id, dets, masks, self.answers[key], size)

        return self.judge_samples(samples, host_check)

    def records(self, window, spans, profile) -> Dict:
        return self.base_records(window, spans, profile)
