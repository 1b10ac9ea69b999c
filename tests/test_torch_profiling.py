"""The port's ``utils/profiling.py``: the span recorder (nesting, parents,
request ids, threads, the bounded buffer, recording off, the profiler's
host ranges), ``trace`` and its ``spans.json``, the spans of
``Detector`` and ``cli.train.predict`` on a 64² config, and ``cli.train
evaluate --trace_dir`` on a 64² synthetic set."""

import collections
import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from fixtures import make_synthetic_dataset
from sln_amodal_tpu_torch.cli import train as port_train
from sln_amodal_tpu_torch.config import Config
from sln_amodal_tpu_torch.convert import init_params
from sln_amodal_tpu_torch.infer import Detector, PendingDetect
from sln_amodal_tpu_torch.utils import profiling
from sln_amodal_tpu_torch.utils.synthetic import detection_biased_variables
from torch_port_helpers import one_intra_op_thread  # noqa: F401  (autouse)

CFG = dict(image_size=64, backbone="resnet50", glm_input_size=33, pre_nms_limit=200,
           post_nms_rois_inference=32, detection_max_instances=8, mask_pool_size=2,
           compute_dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Each test starts from an empty recorder that records, and leaves it so."""
    profiling.clear()
    was = profiling.recording(True)
    yield
    profiling.recording(was)
    profiling.clear()


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_span_nesting_parents_and_request_ids():
    with profiling.span("outer", request=7, images=2) as outer:
        with profiling.span("inner") as inner:
            inner.count(bytes=64)
            with profiling.span("leaf", request=9):
                pass
        outer.count(images=3, detections=5)
    with profiling.span("alone"):
        pass
    spans = profiling.spans()
    assert [s.name for s in spans] == ["leaf", "inner", "outer", "alone"]  # order of ending
    leaf, inner, outer, alone = spans
    assert (outer.parent, inner.parent, leaf.parent, alone.parent) == (None, "outer", "inner",
                                                                       None)
    # a span without a request takes its parent's; one given keeps its own
    assert (outer.request, inner.request, leaf.request, alone.request) == (7, 7, 9, None)
    assert outer.counts == {"images": 3, "detections": 5} and inner.counts == {"bytes": 64}
    assert leaf.counts == {} and alone.counts == {}
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns
    assert leaf.end_ns <= inner.end_ns <= outer.end_ns <= alone.start_ns
    assert {s.thread for s in spans} == {threading.get_ident()}


def test_a_span_is_recorded_when_its_block_raises():
    with pytest.raises(ValueError):
        with profiling.span("outer", request=1):
            with profiling.span("failing"):
                raise ValueError("boom")
    assert [(s.name, s.parent) for s in profiling.spans()] == [("failing", "outer"),
                                                              ("outer", None)]
    with profiling.span("after"):
        pass
    assert profiling.spans()[-1].parent is None      # the stack was unwound


def test_two_threads_keep_their_own_parents():
    both_open = threading.Barrier(2, timeout=30)

    def work(request):
        with profiling.span(f"outer{request}", request=request):
            both_open.wait()             # both outer spans are open at once
            for _ in range(50):
                with profiling.span("inner"):
                    time.sleep(0)

    threads = [threading.Thread(target=work, args=(r,)) for r in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = profiling.spans()
    for request in (1, 2):
        (outer,) = by_name(spans, f"outer{request}")
        inner = [s for s in by_name(spans, "inner") if s.thread == outer.thread]
        assert len(inner) == 50
        assert all(s.parent == f"outer{request}" and s.request == request for s in inner)
    assert len({s.thread for s in spans}) == 2


def test_the_buffer_is_bounded_and_reports_its_oldest_start(monkeypatch):
    assert profiling.CAPACITY == 65536
    assert profiling._RECORDER.maxlen == profiling.CAPACITY
    assert profiling.oldest_start_ns() is None
    monkeypatch.setattr(profiling, "_RECORDER", collections.deque(maxlen=4))
    for i in range(10):
        with profiling.span(f"s{i}"):
            pass
    spans = profiling.spans()
    assert [s.name for s in spans] == ["s6", "s7", "s8", "s9"]
    assert profiling.oldest_start_ns() == spans[0].start_ns
    profiling.clear()
    assert profiling.spans() == [] and profiling.oldest_start_ns() is None


def test_spans_selects_those_wholly_inside_the_interval():
    with profiling.span("a"):
        pass
    mid = time.perf_counter_ns()
    with profiling.span("straddles"):
        with profiling.span("b"):
            pass
        end = time.perf_counter_ns()
    with profiling.span("c"):
        pass
    assert [s.name for s in profiling.spans(mid, end)] == ["b"]
    assert [s.name for s in profiling.spans(start_ns=mid)] == ["b", "straddles", "c"]
    assert [s.name for s in profiling.spans(end_ns=end)] == ["a", "b"]


def test_recording_off_records_nothing():
    assert profiling.recording(False) is True
    first, second = profiling.span("x", request=1), profiling.span("y", images=2)
    assert first is second                      # one shared no-op
    with first as s:
        s.count(bytes=8)
        with profiling.span("nested"):
            pass
    assert profiling.spans() == [] and profiling.oldest_start_ns() is None
    assert profiling.recording(True) is False
    with profiling.span("z"):
        pass
    assert [s.name for s in profiling.spans()] == ["z"]


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, *args):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "_host_range", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    for _ in range(3):
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    assert entered == [] and len(profiling.spans()) == 6
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("under_profiler"):
            pass
    assert entered == ["under_profiler"]


def test_spans_are_host_ranges_of_a_running_profiler():
    """Under a CPU ``torch.profiler`` each span is a host range of the same
    name, nested as the spans are, as long as the recorder says (within
    10% or 0.2 ms)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("layer.outer", request=3):
            time.sleep(0.004)
            with profiling.span("layer.inner"):
                (torch.ones(128, 128) @ torch.ones(128, 128)).sum()
                time.sleep(0.003)
    events = {e.name: e for e in prof.events() if e.name.startswith("layer.")}
    assert set(events) == {"layer.outer", "layer.inner"}
    outer, inner = events["layer.outer"].time_range, events["layer.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert events["layer.outer"].device_type == torch.autograd.DeviceType.CPU
    for s in profiling.spans():
        got = events[s.name].time_range
        ms, want = (got.end - got.start) / 1e3, (s.end_ns - s.start_ns) / 1e6
        assert abs(ms - want) <= max(0.1 * want, 0.2), (s.name, ms, want)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.span("before-the-trace"):
        pass
    with profiling.trace(str(tmp_path), cuda=False):
        with profiling.span("region-of-interest", request=4, images=1):
            with profiling.span("inside"):
                (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"region-of-interest", "inside", "aten::mm"} <= names


def test_trace_writes_the_spans_of_its_block(tmp_path):
    with profiling.span("before-the-trace"):
        pass
    with profiling.trace(str(tmp_path), cuda=False):
        with profiling.span("region-of-interest", request=4, images=1):
            with profiling.span("inside") as s:
                s.count(bytes=16)
    with open(tmp_path / "spans.json") as f:
        written = json.load(f)
    assert written["clock"] == "time.perf_counter_ns"
    got = written["spans"]
    assert [(s["name"], s["parent"], s["request"], s["counts"]) for s in got] == [
        ("inside", "region-of-interest", 4, {"bytes": 16}),
        ("region-of-interest", None, 4, {"images": 1})]
    assert got == [s._asdict() for s in profiling.spans()[1:]]


# ----------------------------------------------------------- the program --

@pytest.fixture(scope="module")
def biased_template():
    return detection_biased_variables(init_params(Config(**CFG), seed=0, device="cpu"))


@pytest.fixture(scope="module")
def detector(biased_template):
    return Detector(Config(**CFG), biased_template, device="cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = make_synthetic_dataset(str(tmp_path_factory.mktemp("data")), n_images=3, size=64,
                                  subset="val")
    ds = port_train.AmodalDataset()
    ds.load_amodal(root, "val")
    ds.prepare()
    return ds


def test_detect_records_its_request_in_order(detector, dataset):
    images = [dataset.load_image(0), dataset.load_image(1)]
    first = detector.dispatches
    detector.detect(images)
    detector.detect(images[:1])
    spans = profiling.spans()
    assert {s.request for s in spans} == {first, first + 1}
    mine = sorted((s for s in spans if s.request == first), key=lambda s: s.start_ns)
    assert [s.name for s in mine] == [
        "detector.dispatch", "detector.mold", "detector.upload", "detector.resize",
        "detector.replay", "detector.collect", "detector.wait", "detector.unmold",
        "detector.unmold"]
    parents = {s.name: s.parent for s in mine}
    assert parents["detector.dispatch"] is None and parents["detector.collect"] is None
    assert {parents[n] for n in ("detector.mold", "detector.upload", "detector.resize",
                                 "detector.replay")} == {"detector.dispatch"}
    assert {parents[n] for n in ("detector.wait", "detector.unmold")} == {
        "detector.collect"}
    named = {s.name: s for s in mine}
    wait, collect = named["detector.wait"], named["detector.collect"]
    assert wait.end_ns - wait.start_ns <= collect.end_ns - collect.start_ns
    assert named["detector.dispatch"].counts == {"images": 2}
    assert named["detector.collect"].counts == {"images": 2}
    # two raw uint8 frames and two float32 windows up; detections and masks down
    assert named["detector.upload"].counts == {"bytes": 2 * 64 * 64 * 3 + 2 * 4 * 4}
    # on the CPU the op's plain path resizes: no kernel launch
    assert named["detector.resize"].counts == {"images": 2, "launches": 0}
    assert named["detector.wait"].counts["bytes"] > 0
    unmolds = by_name(mine, "detector.unmold")
    assert all(s.counts["detections"] >= 0 for s in unmolds)


def test_dispatch_numbers_requests_and_pending_defaults(detector, dataset):
    """``PendingDetect`` built without the new fields (as
    ``profile_infer.eager_dispatch`` builds it) still collects."""
    images = [dataset.load_image(2)]
    first = detector.dispatches
    a, b = detector.dispatch(images), detector.dispatch(images)
    assert (a.request, b.request, detector.dispatches) == (first, first + 1, first + 2)
    bare = PendingDetect(a.images, a.windows, a.out)
    assert bare.request is None
    got, want = detector.collect(bare), detector.collect(a)
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    (collect, _) = by_name(profiling.spans(), "detector.collect")
    assert collect.request is None


def test_every_wait_counts_ready_on_the_cpu(detector, dataset):
    """On the CPU the outputs are on the host when the batch is dispatched:
    a dispatch's host copies are its outputs as they are, and every
    ``detector.wait`` (``detect``, a hand-built ``PendingDetect``, each batch
    of ``predict``) counts ``ready`` 1."""
    images = [dataset.load_image(0), dataset.load_image(1)]
    pending = detector.dispatch(images)
    host, events = pending.host
    assert events == [] and set(host) == {"detections", "masks"}
    assert host["detections"] is pending.out[0].detections
    assert host["masks"] is pending.out[0].masks
    detector.collect(pending)
    detector.detect(images[:1])
    detector.collect(PendingDetect(pending.images, pending.windows, pending.out))
    port_train.predict(detector, dataset, [0, 1, 2], 2, progress=False)
    waits = by_name(profiling.spans(), "detector.wait")
    assert len(waits) == 5
    assert all(w.counts["ready"] == 1 and w.counts["bytes"] > 0 for w in waits)


def test_mesh_dispatch_records_one_upload_and_replay(biased_template, dataset):
    det = Detector(Config(**CFG), biased_template, device="cpu", mesh=["cpu", "cpu"])
    images = [dataset.load_image(i) for i in range(3)]     # padded to 4 rows
    pending = det.dispatch(images)
    assert pending.request == 0 and len(pending.out) == 2
    results = det.collect(pending)
    assert len(results) == 3
    spans = profiling.spans()
    assert [len(by_name(spans, n)) for n in ("detector.upload", "detector.replay",
                                             "detector.unmold")] == [1, 1, 3]
    # the pad row repeats the last raw image's table row: its bytes go up once
    assert by_name(spans, "detector.upload")[0].counts == {"bytes": 3 * 64 * 64 * 3 + 4 * 16}
    assert by_name(spans, "detector.resize")[0].counts == {"images": 4, "launches": 0}


def test_predict_records_one_encode_per_image_under_its_drain(detector, dataset):
    ids = [0, 1, 2]
    first = detector.dispatches
    results = port_train.predict(detector, dataset, ids, 2, progress=False)
    assert results
    spans = profiling.spans()
    drains = sorted(by_name(spans, "predict.drain"), key=lambda s: s.start_ns)
    assert [d.request for d in drains] == [first, first + 1]
    assert [d.counts["images"] for d in drains] == [2, 1]
    encodes = by_name(spans, "predict.encode")
    assert len(encodes) == len(ids)
    for d in drains:
        inside = sorted((e for e in encodes if d.start_ns <= e.start_ns and e.end_ns <= d.end_ns),
                        key=lambda s: s.start_ns)
        assert len(inside) == d.counts["images"]
        assert all(e.parent == "predict.drain" and e.request == d.request for e in inside)
        (collect,) = [c for c in by_name(spans, "detector.collect") if c.request == d.request]
        assert collect.parent == "predict.drain"
        assert d.start_ns <= collect.start_ns and collect.end_ns <= d.end_ns
        # the batch's rows, the last batch's pad row too, then its real images' encodes
        unmolds = sorted((u for u in by_name(spans, "detector.unmold") if u.request == d.request),
                         key=lambda s: s.start_ns)
        assert len(unmolds) == 2 and unmolds[-1].end_ns <= inside[0].start_ns
        assert [u.counts["detections"] for u in unmolds[:len(inside)]] == [
            e.counts["detections"] for e in inside]
    loads = by_name(spans, "predict.load")
    assert [s.counts["images"] for s in loads] == [2, 1]
    assert all(s.parent is None and s.request is None for s in loads)


def test_predict_encode_counts_the_characters_of_its_rle_strings(detector, dataset):
    """Each image's ``predict.encode`` span counts its RLE strings'
    characters (``rle_bytes``) beside its detections."""
    ids = [0, 1, 2]
    results = port_train.predict(detector, dataset, ids, 2, progress=False)
    encodes = sorted(by_name(profiling.spans(), "predict.encode"), key=lambda s: s.start_ns)
    assert len(encodes) == len(ids)
    for image_id, encode in zip(ids, encodes):
        own = [r for r in results if r["image_id"] == dataset.image_info[image_id]["id"]]
        assert encode.counts["detections"] == len(own) > 0
        assert encode.counts["rle_bytes"] == sum(len(r["segmentation"]["counts"]) for r in own)
    assert len({dataset.image_info[i]["id"] for i in ids}) == len(ids)


def test_outputs_identical_with_recording_on_and_off(detector, dataset):
    images = [dataset.load_image(i) for i in range(2)]
    ids = [0, 1, 2]

    def run():
        return (detector.detect(images), detector.collect_crops(detector.dispatch(images)),
                port_train.predict(detector, dataset, ids, 2, progress=False))

    on = run()
    assert profiling.spans()
    profiling.recording(False)
    profiling.clear()
    off = run()
    assert profiling.spans() == []
    for a, b in zip(on[0] + on[1], off[0] + off[1]):
        assert set(a) == set(b)
        for k in a:
            if k == "crops":
                assert len(a[k]) == len(b[k])
                assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))
            elif k == "image_shape":
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert on[2] == off[2] and len(on[2]) > 0


def test_the_benchmarks_seams_are_called_as_it_wraps_them(biased_template, dataset,
                                                          monkeypatch):
    """What ``h100bench`` does to the program, here on the 64² config: it
    replaces ``_fetch`` on the instance (the judge's captured outputs, every
    row of each batch) and wraps ``image_utils.unmold_detections``,
    ``dispatch``, ``cli.train.load_batch``, ``coco_results`` and
    ``build_coco_results_crops`` by attribute (its span metrics). Each
    wrapper is called as often as the work it times."""
    from sln_amodal_tpu_torch.utils import image as image_utils

    det = Detector(Config(**CFG), biased_template, device="cpu")
    calls = collections.Counter()
    fetched = []

    def wrap(owner, attr):
        inner = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            calls[attr] += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(owner, attr, wrapped)

    fetch = det._fetch

    def kept(pending):
        detections, masks = fetch(pending)
        fetched.append((len(pending.images), detections.copy(), masks.copy()))
        return detections, masks

    monkeypatch.setattr(det, "_fetch", kept)
    wrap(image_utils, "unmold_detections")
    wrap(det, "dispatch")
    for attr in ("load_batch", "coco_results", "build_coco_results_crops"):
        wrap(port_train, attr)

    images = [dataset.load_image(i) for i in range(3)]
    assert len(det.detect(images)) == 3
    results = port_train.predict(det, dataset, [0, 1, 2], 2, progress=False)
    assert results
    assert calls == {"dispatch": 3, "unmold_detections": 3, "load_batch": 2,
                     "coco_results": 2, "build_coco_results_crops": 3}
    # every row of each batch: the detect's 3, predict's 2 and 2 (its last
    # batch of one image padded to 2 by load_batch)
    d, m2 = CFG["detection_max_instances"], 2 * CFG["mask_pool_size"]
    assert [(n, dets.shape, masks.shape[:4]) for n, dets, masks in fetched] == [
        (3, (3, d, 6), (3, d, m2, m2)), (2, (2, d, 6), (2, d, m2, m2)),
        (2, (2, d, 6), (2, d, m2, m2))]


def test_evaluate_trace_dir_writes_a_trace(biased_template, tmp_path, monkeypatch):
    """``evaluate --trace_dir`` on the CPU: a trace that holds the kernels'
    custom ops and the program's spans, ``spans.json`` beside it, and the
    results and sweeps of the run without it."""
    root = make_synthetic_dataset(str(tmp_path / "data"), n_images=3, size=64, subset="val")
    monkeypatch.setattr(port_train, "inference_config",
                        lambda **kw: Config(**dict(CFG, name=kw.get("name", "coco"))))
    monkeypatch.setattr(port_train, "init_params",
                        lambda config, seed=0, device="cuda": dict(biased_template))
    argv = ["evaluate", "--dataset", root, "--model", "random", "--eval_batch", "2",
            "--device", "cpu"]
    plain = port_train.main(argv)
    trace_dir = tmp_path / "trace"
    traced = port_train.main(argv + ["--trace_dir", str(trace_dir)])
    assert len(plain.results) > 0 and traced.results == plain.results
    assert all(np.array_equal(traced.stats[k], plain.stats[k]) for k in plain.stats)
    files = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # two batches: the proposals' NMS, both RoIAligns
    assert {"sln_amodal::nms_sorted_batched", "sln_amodal::roi_align"} <= names
    assert {"predict.drain", "detector.replay", "detector.unmold"} <= names
    assert os.path.getsize(files[0]) > 0
    with open(trace_dir / "spans.json") as f:
        written = collections.Counter(s["name"] for s in json.load(f)["spans"])
    assert written["predict.load"] == written["predict.drain"] == 2
    # three images in two batches of two: the last batch's pad row is unmolded, not encoded
    assert (written["predict.encode"], written["detector.unmold"]) == (3, 4)
