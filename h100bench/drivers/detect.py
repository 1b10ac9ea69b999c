"""Single-image latency: a closed loop of one client calling
``Detector.detect([image])`` on in-memory images, as ``cli.test_images``
and a served pipeline call it.

Traffic parameters: ``pool`` images at the frame ``sizes`` (requests take
them in turn), ``batch`` (1), ``samples`` answers judged per run, drawn
from the first ``sample_within`` requests. Latency is from the call to the
returned dict; ``detect_ms_p50`` and ``detect_ms_p95`` are over every
request of the window.
"""

from __future__ import annotations

import time
from typing import Dict

from .. import judge
from ..inference import InferenceCell
from ..harness import quantile


class Cell(InferenceCell):
    def setup(self):
        from sln_amodal_tpu_torch.utils import image as image_utils

        self.image_utils = image_utils
        self.build()
        self.request = -1
        self.sampled = set(self.rng.choice(self.t["sample_within"], self.t["samples"],
                                           replace=False).tolist())
        self.capture_outputs(lambda rows: [self.request if self.request in self.sampled
                                           else None] * rows)

    def detect(self, i: int):
        self.request = i
        return self.detector.detect([self.images[i % len(self.images)]])[0]

    def warm(self):
        for i in range(2):
            self.detect(i)
        self.captured.clear()

    def window(self, seconds: float) -> Dict:
        latencies = []
        t0 = time.perf_counter()
        i = 0
        while True:
            a = time.perf_counter()
            result = self.detect(i)
            b = time.perf_counter()
            latencies.append((b - a) * 1e3)
            if i in self.sampled:
                self.answers[i] = result
            i += 1
            if b - t0 >= seconds:
                break
        self.requests = i
        return {"t0": t0, "t1": b, "wall_s": b - t0, "images": i, "requests": i,
                "latencies_ms": latencies, "attempted": i, "failed": 0,
                "metrics": {"detect_ms_p50": quantile(latencies, 50),
                            "detect_ms_p95": quantile(latencies, 95)}}

    def trace_spans(self, spans) -> None:
        spans.wrap(self.image_utils, "unmold_detections", "detect.unmold")
        spans.wrap(self.detector, "dispatch", "detect.dispatch")

    def stretch(self) -> None:
        self.request = None
        for i in range(16):
            self.detector.detect([self.images[i % len(self.images)]])

    def judge(self):
        samples = [(i, self.images[i % len(self.images)]) for i in sorted(self.sampled)
                   if i < self.requests]
        size = self.ctx.cfg["image_size"]

        def host_check(key, image, dets, masks):
            return judge.detect_mismatch(image, dets, masks, self.answers[key], size)

        return self.judge_samples(samples, host_check)

    def records(self, window, spans, profile) -> Dict:
        return self.base_records(window, spans, profile)
