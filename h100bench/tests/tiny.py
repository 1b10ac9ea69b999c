"""A small CPU size of the cells for the tests: the configuration's widths
(channels, heads, the GLM's classes) kept, the frame and the counts cut."""

import time

from h100bench import harness

CFG = dict(image_size=64, pre_nms_limit=300, post_nms_rois_inference=40,
           detection_max_instances=12, glm_input_size=33, post_nms_rois_training=40,
           train_rois_per_image=10)
TRAFFIC = dict(pool=4, sizes=[[48, 64], [64, 48]], samples=2)
PER_KIND = {"eval": dict(ids_per_call=16), "detect": dict(sample_within=3),
            "train": dict(batch=2, warm_steps=4, stretch_steps=2)}
CELLS = ("sln_r101.eval-b8", "sln_r50.detect-b1", "sln_r101.detect-b1")

# The training cell's entries: its driver runs, but BENCHMARK.json does not
# list it yet (PERF.md §7: its numbers do not yet tell the float8 control
# from bfloat16), so the tests that drive it add it here, with the limits
# they hold a float32 program to.
TRAIN = "sln_r101.train-4plus-b8"
TRAIN_ENTRIES = {
    "workload": {
        "name": "sln_r101.train-4plus-b8",
        "config": "sln_r101",
        "traffic": "train-4plus-b8",
        "chips": 1,
        "why": "cli train --stage 4+ at batch 8 on COCO-size JPEGs with 2-12 sem-dist regions: host TrainLoader, pageable upload, graphed fwd+bwd+SGD step"
    },
    "end_to_end": [
        {
            "name": "train_images_per_s",
            "unit": "images/s",
            "better": "higher",
            "bound": 0.05,
            "source": "host_clock",
            "workloads": [
                "sln_r101.train-4plus-b8"
            ]
        }
    ],
    "per_layer": [
        {
            "name": "train.loader_wait_ms",
            "unit": "ms",
            "better": "lower",
            "source": "program_span",
            "layer": "host loader",
            "moves": "train_images_per_s",
            "workloads": [
                "sln_r101.train-4plus-b8"
            ]
        },
        {
            "name": "train.h2d_ms",
            "unit": "ms",
            "better": "lower",
            "source": "device_trace",
            "layer": "captured train step",
            "moves": "train_images_per_s",
            "workloads": [
                "sln_r101.train-4plus-b8"
            ]
        },
        {
            "name": "mfu.train",
            "unit": "%",
            "better": "higher",
            "source": "host_clock",
            "layer": "model step",
            "moves": "train_images_per_s",
            "workloads": [
                "sln_r101.train-4plus-b8"
            ]
        },
        {
            "name": "roi_align_bwd_roofline",
            "unit": "%",
            "better": "higher",
            "source": "device_trace",
            "layer": "kernels",
            "moves": "train_images_per_s",
            "workloads": [
                "sln_r101.train-4plus-b8"
            ]
        },
        {
            "name": "idle.train",
            "unit": "%",
            "better": "lower",
            "source": "device_trace",
            "layer": "device",
            "moves": "train_images_per_s",
            "workloads": [
                "sln_r101.train-4plus-b8"
            ]
        }
    ]
}
TRAIN_LIMITS = {"loader_faults": 0, "loss_gap": 0.05, "grad_gap": 0.1, "update_gap": 0.1}


def bench():
    spec = harness.spec()
    return dict(spec, workloads=spec["workloads"] + [TRAIN_ENTRIES["workload"]],
                end_to_end=spec["end_to_end"] + TRAIN_ENTRIES["end_to_end"],
                per_layer=spec["per_layer"] + TRAIN_ENTRIES["per_layer"])


def traffic_changes(name, **extra):
    kind = harness.traffic_file(harness.workload(name, bench())["traffic"])["kind"]
    return dict(TRAFFIC, **dict(PER_KIND[kind], **extra))


def run(name, seed=2 ** 31 + 77, seconds=0.5, traced=False, cfg=None, traffic=None, **kw):
    if name == TRAIN:
        kw = dict(dict(bench=bench(), limits=TRAIN_LIMITS), **kw)
    return harness.run_cell(name, seed, seconds, traced, time.perf_counter(), device="cpu",
                            cfg_changes=dict(CFG, **(cfg or {})),
                            traffic_changes=traffic_changes(name, **(traffic or {})), **kw)
