"""The port's spans and counters (`utils/profiling.py`: `span`, `count`,
`counters`, `span_summary`, `span_records`, `trace`'s `spans.json`) on the
CPU, at 64 px and batch 2, and the benchmark's readers of them.

  * With no profiler capture active a span records nothing, and the
    deployed program's outputs are bitwise those of a call under the
    profiler.
  * One deployed call under a CPU `torch.profiler` records the span tree
    of `inference.deployed_program`: the root 'deployed_program', the
    network's and the MCAQ transform's spans of the three scales, decode
    and NMS with the keep loop and its host-sync site (the MCAQ transform
    has none); every span shares the root's call id and names its parent.
  * `trace()` writes `spans.json` beside `trace.json`, where each program
    span is a `user_annotation`; self host times add up to the root's host
    time.
  * `nms_sweeps` and `host_syncs` count the keep sweeps of a chain of k
    boxes, each suppressing the next: k sweeps.
  * One train step records 'train_step' and its five phase spans, and
    calls `mark` with the same five names in the same order.
  * A count made on a thread with no open span counts into no span, and
    one given another thread's `span_stack()` (a backward on autograd's
    worker thread) counts into that thread's innermost span.
  * Under torch.export a span and a count do nothing, even with a
    profiler active.
  * Each of the seven new per-layer readers (`perfbench/metrics/`) reads a
    CPU summary: the counters a number, the stream times None (no CUDA
    events off the card).
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcaq_yolo_tpu_torch.inference import deployed_program
from mcaq_yolo_tpu_torch.models.losses import MCAQYOLOLoss
from mcaq_yolo_tpu_torch.models.mcaq_yolo import MCAQYOLO
from mcaq_yolo_tpu_torch.models.yolo import YOLOv8
from mcaq_yolo_tpu_torch.ops import nms
from mcaq_yolo_tpu_torch.train import Optimizer, make_train_step
from mcaq_yolo_tpu_torch.utils import profiling

PHASES = ["forward", "teacher", "loss", "backward", "optimizer"]
MCAQ = ["mcaq.analyzer", "mcaq.mapper", "mcaq.quantize"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return MCAQYOLO(variant="yolov8n", num_classes=80, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))


def _call(model, images):
    with torch.inference_mode():
        return deployed_program(model, images, 80, max_det=300)


@pytest.fixture(scope="module")
def traced_call(model, images, tmp_path_factory):
    """One deployed call inside `trace()`: its outputs, records, summary and
    the directory written."""
    before = profiling.counters()
    with profiling.trace(str(tmp_path_factory.mktemp("trace"))) as d:
        out = _call(model, images)
    after = profiling.counters()
    return {"out": out, "records": profiling.span_records(),
            "summary": profiling.span_summary(), "dir": d,
            "delta": {k: after[k] - before.get(k, 0) for k in after}}


def test_nothing_recorded_without_a_capture_and_outputs_bitwise(model, images, traced_call):
    recorded = profiling.span_records()
    before = profiling.counters()
    off = _call(model, images)
    assert profiling.span_records() == recorded
    assert profiling.counters()["host_syncs"] > before["host_syncs"]   # counters always count
    assert profiling.span("x") is profiling.span("y")   # one shared empty context
    with profile(activities=[ProfilerActivity.CPU]):   # a new capture: the program ran since
        with profiling.span("opened"):
            pass
    assert [r["name"] for r in profiling.span_records()] == ["opened"]
    assert len(off) == len(traced_call["out"])
    for a, b in zip(off, traced_call["out"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_deployed_call_span_tree(traced_call):
    recs = traced_call["records"]
    by_index = {r["index"]: r for r in recs}
    names = [r["name"] for r in recs]
    assert names[0] == "deployed_program" and recs[0]["parent"] is None
    assert {r["call"] for r in recs} == {recs[0]["call"]}
    assert all(r["parent"] in by_index for r in recs[1:])
    parent = {r["name"]: by_index[r["parent"]]["name"] for r in recs[1:]}
    for name in ["model.backbone", "model.neck", "model.head", "decode_and_nms"] + MCAQ:
        assert parent[name] == "deployed_program"
    # the MCAQ transform holds no sync site: the bilateral weights are a buffer
    # on the card, and clip's bounds are host scalars passed to the kernels
    assert not {"sync.bilateral_weights", "sync.clip_bounds"} & set(names)
    assert parent["nms.keep"] == "decode_and_nms"
    assert parent["sync.nms_sweep"] == "nms.keep"
    for name in MCAQ:
        assert sorted(r["attrs"]["scale"] for r in recs if r["name"] == name) == [3, 4, 5]
    s = traced_call["summary"]
    assert s["roots"] == 1 and s["by_root"]["deployed_program"]["count"] == 1
    counts = s["by_root"]["deployed_program"]["counters"]
    sweeps = counts["nms_sweeps"]
    # one read a keep sweep, and no other
    assert counts["host_syncs"] == sweeps and sweeps >= 1
    assert {k: traced_call["delta"][k] for k in counts} == counts
    assert all(v["stream_ms"] is None for v in s["spans"].values())


def test_trace_writes_spans_json_and_annotations(traced_call):
    from pathlib import Path

    d = Path(traced_call["dir"])
    assert json.loads((d / "spans.json").read_text()) == json.loads(
        json.dumps(traced_call["summary"]))
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {r["name"] for r in traced_call["records"]} <= annotated
    assert not any(n.startswith("pb:") for n in annotated)


def test_self_times_add_up_to_the_root(traced_call):
    spans = traced_call["summary"]["spans"]
    total_self = sum(v["self_host_ms"] for v in spans.values())
    root = spans["deployed_program"]["host_ms"]
    assert abs(total_self - root) <= 0.01 * root


@pytest.mark.parametrize("k", [1, 2, 5, 9])
def test_nms_sweeps_of_a_suppression_chain(k):
    """Boxes 40 px wide every 10 px: neighbours overlap at IoU 0.6, boxes
    two apart at 0.33, so each suppresses the next above 0.5 and greedy
    keeps every other box; the sweeps are the chain's depth, k."""
    x0 = torch.arange(k, dtype=torch.float32) * 10
    boxes = torch.stack([x0, torch.zeros(k), x0 + 40, torch.full((k,), 10.0)], -1)[None]
    before = profiling.counters()
    keep = nms.greedy_keep(boxes, torch.ones(1, k, dtype=torch.bool), 0.5)
    after = profiling.counters()
    assert keep[0].tolist() == [i % 2 == 0 for i in range(k)]
    assert after["nms_sweeps"] - before.get("nms_sweeps", 0) == k
    assert after["host_syncs"] - before.get("host_syncs", 0) == k


@pytest.fixture(scope="module")
def traced_step(tmp_path_factory):
    """A function that runs one train step inside `trace()` and returns its
    marks, records and summary."""
    nc, B = 4, 2
    model = MCAQYOLO(num_classes=nc, device="cpu")
    teacher = YOLOv8("yolov8n", nc, device="cpu")
    rng = np.random.default_rng(1)
    xy = rng.uniform(0, 40, (B, 3, 2))
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)),
             "gt_boxes": torch.from_numpy(np.concatenate([xy, xy + 20], -1).astype(np.float32)),
             "gt_classes": torch.from_numpy(rng.integers(0, nc, (B, 3)).astype(np.int32)),
             "gt_mask": torch.ones(B, 3, dtype=torch.bool)}
    step = make_train_step(model, MCAQYOLOLoss(nc, 4.0), teacher)
    opt = Optimizer(model, lambda s: 1e-3)

    def run():
        marks = []
        with profiling.trace(str(tmp_path_factory.mktemp("step"))):
            step(opt, batch, 1.0, 4.0, 0.01, 0.1, 0.5, 1e-4, quantize=True, use_kd=True,
                 mark=marks.append)
        return {"marks": marks, "records": profiling.span_records(),
                "summary": profiling.span_summary()}

    return run


def test_train_step_spans_and_marks(traced_step):
    traced = traced_step()
    assert traced["marks"] == PHASES
    recs = traced["records"]
    by_index = {r["index"]: r for r in recs}
    assert recs[0]["name"] == "train_step" and recs[0]["parent"] is None
    phases = [r["name"] for r in recs if r["parent"] == recs[0]["index"]]
    assert phases == [f"train.{p}" for p in PHASES]
    for r in recs:
        if r["name"] in MCAQ:
            assert by_index[r["parent"]]["name"] == "train.forward"
    s = traced["summary"]
    assert s["by_root"]["train_step"]["count"] == 1
    assert s["by_root"]["train_step"]["counters"] == {}   # no host sync, no other count


def _count_on_another_thread(name: str, stack=None) -> None:
    import threading

    worker = threading.Thread(target=profiling.count, args=(name, 2),
                              kwargs={"stack": stack})
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()


def test_count_on_a_thread_without_spans_counts_into_no_span():
    """A thread with no open span of its own (a data producer, a second
    server) counts into no span, though another thread has spans open."""
    before = profiling.counters().get("from_spanless", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("busy_root"):
            with profiling.span("busy_child"):
                _count_on_another_thread("from_spanless")
    assert profiling.counters()["from_spanless"] == before + 2
    recs = {r["name"]: r for r in profiling.span_records()}
    assert recs["busy_child"]["counts"] == {} and recs["busy_root"]["counts"] == {}
    assert profiling.span_summary()["by_root"]["busy_root"]["counters"] == {}


def test_count_given_a_span_stack_goes_to_its_innermost_span():
    """A count on another thread given this thread's `span_stack()` (a
    backward on autograd's worker thread, from its forward) lands in the
    innermost span open here, so its root counts it."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("waiting_root"):
            stack = profiling.span_stack()
            with profiling.span("waiting_child"):
                _count_on_another_thread("from_worker", stack)
            _count_on_another_thread("from_worker", stack)
        _count_on_another_thread("from_worker", stack)   # nothing open: no span
    recs = {r["name"]: r for r in profiling.span_records()}
    assert recs["waiting_child"]["counts"] == {"from_worker": 2}
    assert recs["waiting_root"]["counts"] == {"from_worker": 2}
    root = profiling.span_summary()["by_root"]["waiting_root"]
    assert root["count"] == 1 and root["counters"] == {"from_worker": 4}


def test_export_under_a_profiler_holds_no_profiler_op():
    class Spanned(torch.nn.Module):
        def forward(self, x):
            with profiling.span("exported"):
                profiling.count("exported_count")
                return x * 2.0

    with profile(activities=[ProfilerActivity.CPU]):
        ep = torch.export.export(Spanned(), (torch.ones(3),))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert "exported_count" not in profiling.counters()


def _reader(name):
    from perfbench import run

    return run.metric_reader(name)


@pytest.mark.parametrize("name,counter", [
    ("yolo_stream_ms.serve", False), ("mcaq_stream_ms.serve", False),
    ("nms_stream_ms.serve", False), ("host_syncs.serve", True), ("nms_sweeps.serve", True)])
def test_serving_readers_on_a_cpu_summary(model, images, name, counter, tmp_path):
    with profiling.trace(str(tmp_path)):
        _call(model, images)
    v = _reader(name)({"calls": 1, "images": 2})
    if counter:
        assert isinstance(v, float) and v >= 1
    else:
        assert v is None
    with pytest.raises(ValueError, match="traced calls"):
        _reader(name)({"calls": 2, "images": 4})


@pytest.mark.parametrize("name,counter", [("mcaq_stream_ms.train", False),
                                          ("host_syncs.train", True),
                                          ("frac_quant_launches.train", True)])
def test_training_readers_on_a_cpu_summary(traced_step, name, counter):
    traced_step()
    v = _reader(name)({"steps": 1})
    if counter:
        assert v == 0.0
    else:
        assert v is None
    with pytest.raises(ValueError, match="traced steps"):
        _reader(name)({"steps": 2})
