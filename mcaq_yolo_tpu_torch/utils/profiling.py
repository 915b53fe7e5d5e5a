"""
Tracing and profiling of the port (counterpart of
`mcaq_yolo_tpu/utils/profiling.py`):

  * `trace(...)`: a `torch.profiler` capture of host and CUDA activity,
    written as a Chrome trace (chrome://tracing, Perfetto), with the
    summary of the program's spans beside it (`spans.json`).
  * `span(name, **attrs)`, `count(name, n)`, `counters()`,
    `span_summary()`, `span_records()`: the program's own spans and
    counters (section "Spans and counters" below).
  * `cuda_kernels(...)`: the exact number of CUDA kernels one call
    launches, counted in a CUDA graph capture of the call.
  * `timed(...)`: steady-state seconds per call, the median over calls.
    On CUDA, CUDA events around each call with the host's enqueue included
    (as a caller sees it; `cuda_timing.cuda_ms`); on the CPU, the host
    clock.
  * `component_breakdown(...)`: per-stage milliseconds of the MCAQ
    inference forward (backbone / morphology / bit map + quantize / neck +
    head) from four sub-programs timed in turns (`interleaved_ms`), with
    `cost=True` each stage's FLOPs and its kernel-floor bytes.
  * `KernelFloorMode`: the FLOPs and the byte floor of a program, counted
    from the aten ops it dispatches.  XLA's cost model, which the JAX
    package reads, has no counterpart here; the floor follows the JAX
    package's `kernel_floor_bytes` rule: every convolution and matmul is a
    kernel of its own that reads its operands once and writes its result
    once (2 x MACs FLOPs; a convolution's backward counts as two
    convolutions, the input gradient and the weight gradient), every other
    op is taken as fused away at no cost, plus one read of the program's
    inputs (the arguments and the module's state) and one write of its
    outputs.  Real programs move more, so the bound it gives is a floor.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..device import resolve_device
from .cuda_timing import cuda_ms

aten = torch.ops.aten


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def device_stamp(device) -> Dict:
    """The device a result was measured on: its name, and on CUDA the card's
    name and power limit as nvidia-smi prints them."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return {"device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body (host, and CUDA when there is a card) and write
    `<log_dir>/trace.json` and the program's spans recorded meanwhile,
    `<log_dir>/spans.json` (`span_summary()`); yields the directory
    (default: a new one under the temporary directory, `tempfile.mkdtemp`)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="mcaq_trace_")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _new_capture()
    with profile(activities=activities) as prof:
        yield log_dir
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    (Path(log_dir) / "spans.json").write_text(json.dumps(span_summary(), indent=1))


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------
#
# A span is a named interval of the program, opened with `with span(name,
# **attrs):` at a layer boundary.  It records only while a `torch.profiler`
# capture is active (`trace()`, or any other profiler over the program):
# its parent (the span open around it on the same thread), the call id of
# its root span (every span of one deployed call or one train step shares
# it), its host start and end (`time.perf_counter_ns`), on a card a start
# and an end CUDA event on the current stream, and a `record_function`
# annotation of the same name, so it lands in the profiler's trace beside
# the kernels it launched, on the profiler's clock.  The time between its
# two events is its stream time: from when the stream reached the span to
# when its last kernel finished, the card's idle time inside the span
# included (the time the stream waited for the host to enqueue).
#
# With no capture active a span returns a shared empty context: no event,
# no annotation, no record.  Under `torch.compile` or `torch.export` it does
# nothing, so a traced program holds no profiler op.
#
# `count(name, n)` adds to a plain dict of ints (`counters()`), always; while
# a capture is active the count is also attached to the innermost open span,
# so `span_summary()` can give it per root span.  The program's counters:
#   host_syncs   one at every site of the deployed program and the train
#                step where the host waits for the card (a pageable copy to
#                the card, a read of a device value); each site runs inside
#                a span `sync.<site>`.  Counted at the site on any device,
#                so a CPU run counts the sites a card would block at.
#   nms_sweeps   the keep sweeps of `ops/nms.py:keep_fixed_point`.
#   bn_silu      the launches of the eval BatchNorm + SiLU kernel
#                (`ops/bn_silu.py`), one a ConvBnSiLU on the card in eval.
# The two older kernels' launch counters stay where they are
# (`spatial_quantize.launches`, `phi_tiles.launches`); `counters()` reports
# them beside these.

_COUNTERS: Dict[str, int] = {}
_NULL = contextlib.nullcontext()
_open = threading.local()     # .stack: the spans open on this thread


class _Capture:
    """The spans recorded while one profiler capture was active."""

    def __init__(self):
        self.records: List["_Span"] = []
        self.calls = 0


_capture = _Capture()
_between = True   # a span was opened with no capture active since the last record


def _new_capture() -> None:
    global _capture, _between
    _capture, _between = _Capture(), False


_streams: Dict[int, "torch.cuda.Stream"] = {}


def _current_stream():
    """The current CUDA stream, its Python object made once per raw handle
    (`torch.cuda.current_stream()` costs several microseconds a call)."""
    raw = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    s = _streams.get(raw)
    if s is None:
        s = _streams[raw] = torch.cuda.current_stream()
    return s


def _stack() -> list:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


class _Span:
    __slots__ = ("name", "attrs", "parent", "call", "index", "t0", "t1", "ev0", "ev1",
                 "counts", "_rf", "_stream")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs
        self.counts: Dict[str, int] = {}
        self.t1 = self.ev0 = self.ev1 = None

    def __enter__(self):
        global _between
        if _between:   # the profiler was off since the last record: a new capture
            _new_capture()
        st = _stack()
        cap = _capture
        self.parent = st[-1].index if st else None
        if st:
            self.call = st[-1].call
        else:
            self.call = cap.calls
            cap.calls += 1
        self.index = len(cap.records)
        cap.records.append(self)
        st.append(self)
        self._rf = torch.autograd.profiler.record_function(
            self.name, json.dumps(self.attrs) if self.attrs else None)
        self._rf.__enter__()
        if torch.cuda.is_initialized():
            self._stream = _current_stream()
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self._stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(self._stream)
        self.t1 = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        _stack().pop()
        return False


def span(name: str, **attrs):
    """A span of the program (section comment above): `with span('nms.keep'):`.
    Recording only under an active profiler capture; otherwise an empty
    context."""
    global _between
    if torch.autograd.profiler._is_profiler_enabled and not torch.compiler.is_compiling():
        return _Span(name, attrs)
    _between = True
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`, and to the innermost open span while a
    capture records (nothing under torch.compile / torch.export)."""
    if torch.compiler.is_compiling():
        return
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n
    if torch.autograd.profiler._is_profiler_enabled:
        st = _stack()
        if st:
            st[-1].counts[name] = st[-1].counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The program's counters since the process started: `count`'s, and the
    two kernels' launch counters."""
    from ..core.morphology_lanes import phi_tiles
    from ..ops.spatial_quant import spatial_quantize

    return {**_COUNTERS, "spatial_quantize_launches": spatial_quantize.launches,
            "phi_tiles_launches": phi_tiles.launches}


def _closed(cap: _Capture) -> List[_Span]:
    done = [r for r in cap.records if r.t1 is not None]
    if any(r.ev1 is not None for r in done):
        torch.cuda.synchronize()
    return done


def _stream_ms(r: _Span) -> Optional[float]:
    return r.ev0.elapsed_time(r.ev1) if r.ev1 is not None else None


def span_records() -> List[Dict]:
    """The closed spans of the latest capture in the order they opened:
    name, attrs, call id, index, parent index (None for a root), host ms,
    stream ms (None off the card) and the counts made inside it (not in
    its children)."""
    return [{"name": r.name, "attrs": dict(r.attrs), "call": r.call, "index": r.index,
             "parent": r.parent, "host_ms": (r.t1 - r.t0) * 1e-6,
             "stream_ms": _stream_ms(r), "counts": dict(r.counts)}
            for r in _closed(_capture)]


def span_summary() -> Dict:
    """The spans of the latest profiler capture (those recorded since
    `trace()` began, or since a span last ran with no capture active), by
    name: `count`, `host_ms`
    and `stream_ms` (sums; stream None off the card), `self_host_ms` and
    `self_stream_ms` (less what the span's children cover); by root name:
    `count` and `counters` (the counts made inside each root span, summed
    over them) and `counters_per_root` (one dict per root span); `roots`:
    the number of root spans."""
    recs = span_records()
    by_index = {r["index"]: r for r in recs}
    child_host: Dict[int, float] = {}
    child_stream: Dict[int, float] = {}
    for r in recs:
        p = r["parent"]
        if p is not None and p in by_index:
            child_host[p] = child_host.get(p, 0.0) + r["host_ms"]
            if r["stream_ms"] is not None:
                child_stream[p] = child_stream.get(p, 0.0) + r["stream_ms"]
    spans: Dict[str, Dict] = {}
    root_of: Dict[int, int] = {}
    per_root: Dict[int, Dict[str, int]] = {}
    for r in recs:
        s = spans.setdefault(r["name"], {"count": 0, "host_ms": 0.0, "stream_ms": 0.0,
                                         "self_host_ms": 0.0, "self_stream_ms": 0.0})
        s["count"] += 1
        s["host_ms"] += r["host_ms"]
        s["self_host_ms"] += r["host_ms"] - child_host.get(r["index"], 0.0)
        if r["stream_ms"] is None or s["stream_ms"] is None:
            s["stream_ms"] = s["self_stream_ms"] = None
        else:
            s["stream_ms"] += r["stream_ms"]
            s["self_stream_ms"] += r["stream_ms"] - child_stream.get(r["index"], 0.0)
        p = r["parent"]
        root = r["index"] if p is None else root_of.get(p)
        if root is None:
            continue   # under a span still open when the summary was read
        root_of[r["index"]] = root
        counts = per_root.setdefault(root, {})
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    roots: Dict[str, Dict] = {}
    for i, counts in per_root.items():
        entry = roots.setdefault(by_index[i]["name"], {"count": 0, "counters": {},
                                                        "counters_per_root": []})
        entry["count"] += 1
        entry["counters_per_root"].append(counts)
        for k, v in counts.items():
            entry["counters"][k] = entry["counters"].get(k, 0) + v
    return {"spans": spans, "by_root": roots, "roots": len(per_root)}


def timed(fn: Callable, *args, iters: int = 50, warmup: int = 3, device=None) -> float:
    """Steady-state seconds per call of fn(*args) on `device` (default CUDA;
    raises without a card unless device="cpu"): the median of `iters` timed
    calls."""
    device = resolve_device(device)
    ms = interleaved_ms({"fn": lambda _: fn(*args)}, None, iters, warmup, device)["fn"]
    return statistics.median(ms) * 1e-3


_CU_GRAPH_NODE_TYPE_KERNEL = 0  # CUgraphNodeType


def _graph_kernel_nodes(graph: int) -> int:
    """The kernel nodes of a captured cudaGraph_t (the driver's CUgraph),
    through the driver API."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    check(cu.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(ctypes.c_void_p(graph), nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kinds = ctypes.c_int()
    kernels = 0
    for node in nodes:
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kinds)),
              "cuGraphNodeGetType")
        kernels += kinds.value == _CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def _captured_kernels(fn: Callable, *args) -> int:
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn(*args)
    try:
        return _graph_kernel_nodes(graph.raw_cuda_graph())
    finally:
        graph.reset()


def cuda_kernels(fn: Callable, *args) -> int:
    """The number of CUDA kernels one call of fn(*args) launches (copies and
    memsets not counted), exactly: the call is captured into a CUDA graph
    and the graph's kernel nodes are counted.  Two captures, after a warm-up
    call (first calls may build, autotune or allocate); a count that
    differs between them raises.  fn must be capturable: no host
    synchronization and no copy from host memory.  Needs a card."""
    fn(*args)
    torch.cuda.synchronize()
    counts = [_captured_kernels(fn, *args) for _ in range(2)]
    if counts[0] != counts[1]:
        raise RuntimeError(f"two captures of one call hold {counts} kernels")
    return counts[0]


# ---------------------------------------------------------------------------
# FLOPs and the kernel-floor bytes, counted from the dispatched aten ops
# ---------------------------------------------------------------------------


def _conv_macs(out_or_grad, inp, weight, transposed) -> int:
    # weight (Cout, Cin/g, k...) or, transposed, (Cin, Cout/g, k...): each
    # output (input, transposed) element takes numel / shape[0] MACs
    per = weight.numel() // weight.shape[0]
    return (inp.numel() if transposed else out_or_grad.numel()) * per


def _conv(transposed):
    """Rule of a convolution op; `transposed` is a bool, or the index of the
    op's `transposed` argument (`aten.convolution`)."""

    def rule(args, kwargs, out):
        inp, weight = args[0], args[1]
        bias = args[2] if len(args) > 2 else (kwargs or {}).get("bias")
        t = transposed if isinstance(transposed, bool) else bool(args[transposed])
        flops = 2 * _conv_macs(out, inp, weight, t)
        return flops, _nbytes(inp) + _nbytes(weight) + _nbytes(bias) + _nbytes(out)

    return rule


def _conv_backward(args, kwargs, out):
    grad_out, inp, weight = args[0], args[1], args[2]
    mask = args[10]
    macs = _conv_macs(grad_out, inp, weight, bool(args[7]))
    flops = nbytes = 0
    if mask[0]:  # input gradient: grad_out (x) weight -> grad_input
        flops += 2 * macs
        nbytes += _nbytes(grad_out) + _nbytes(weight) + _nbytes(out[0])
    if mask[1]:  # weight gradient: grad_out (x) input -> grad_weight
        flops += 2 * macs
        nbytes += _nbytes(grad_out) + _nbytes(inp) + _nbytes(out[1])
    return flops, nbytes


def _mm(args, kwargs, out):
    a, b = args[-2], args[-1]  # mm(a, b); addmm(bias, a, b); bmm; baddbmm(c, a, b)
    flops = 2 * a.numel() * b.shape[-1]
    return flops, sum(_nbytes(t) for t in args[:3]) + _nbytes(out)


def _linear(args, kwargs, out):
    inp, weight = args[0], args[1]
    bias = args[2] if len(args) > 2 else (kwargs or {}).get("bias")
    flops = 2 * inp.numel() * weight.shape[0]
    return flops, _nbytes(inp) + _nbytes(weight) + _nbytes(bias) + _nbytes(out)


def _matmul(args, kwargs, out):
    a, b = args[0], args[1]
    return 2 * out.numel() * a.shape[-1], _nbytes(a) + _nbytes(b) + _nbytes(out)


# Under autograd the composite ops (conv2d, linear, matmul) reach the
# dispatch mode decomposed (convolution, addmm, mm); under inference_mode
# they reach it whole.  Either way each kernel is counted once.
_RULES = {
    aten.convolution: _conv(6),
    aten.conv1d: _conv(False), aten.conv2d: _conv(False), aten.conv3d: _conv(False),
    aten.conv_transpose1d: _conv(True), aten.conv_transpose2d: _conv(True),
    aten.conv_transpose3d: _conv(True),
    aten.convolution_backward: _conv_backward,
    aten.mm: _mm, aten.addmm: _mm, aten.bmm: _mm, aten.baddbmm: _mm,
    aten.linear: _linear, aten.matmul: _matmul,
}


class KernelFloorMode(TorchDispatchMode):
    """Counts, over the ops dispatched inside it, `flops` and
    `kernel_bytes` of the convolution and matmul ops (module docstring),
    and how many of each op ran (`ops`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.kernel_bytes = 0
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rule = _RULES.get(func.overloadpacket)
        if rule is not None:
            flops, nbytes = rule(args, kwargs, out)
            self.flops += flops
            self.kernel_bytes += nbytes
            self.ops[str(func.overloadpacket)] += 1
        return out


def program_cost(fn: Callable, *args, state=()) -> Dict:
    """Run fn(*args) once and count its FLOPs and byte floor: `flops`,
    `kernel_bytes` (the convolutions and matmuls), `io_bytes` (one read of
    the tensors in `args` and `state`, one write of the outputs) and
    `floor_bytes` (their sum), plus the counted `ops`."""
    with KernelFloorMode() as mode:
        out = fn(*args)
    io = sum(_nbytes(t) for t in tree_leaves(list(args) + list(state)))
    io += sum(_nbytes(t) for t in tree_leaves(out))
    return {"flops": float(mode.flops), "kernel_bytes": float(mode.kernel_bytes),
            "io_bytes": float(io), "floor_bytes": float(mode.kernel_bytes + io),
            "ops": dict(mode.ops)}


# ---------------------------------------------------------------------------
# Per-stage attribution of the MCAQ forward
# ---------------------------------------------------------------------------


def breakdown_programs(model) -> Dict[str, Callable]:
    """The four sub-programs of the eval forward, each a function of the
    images (the model's own structure: `backbone_features`,
    `complexity_analyzer`, `mcaq_transform`, then neck and head):
    'full' -> (raw maps, aux); 'backbone_only' -> (C3, C4, C5);
    'with_complexity' -> the three complexity maps; 'with_mcaq' -> the three
    quantized features, NHWC, as the forward feeds the neck."""

    def nhwc(f):
        return f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)

    def full(x):
        return model(x, temperature=1.0, training=False)

    def backbone_only(x):
        return model.backbone_features(x)

    def with_complexity(x):
        return [model.complexity_analyzer(nhwc(f)) for f in model.backbone_features(x)]

    def with_mcaq(x):
        return [model.mcaq_transform(f, i, 1.0, True, False)[0].permute(0, 2, 3, 1)
                for i, f in enumerate(model.backbone_features(x))]

    return {"full": full, "backbone_only": backbone_only,
            "with_complexity": with_complexity, "with_mcaq": with_mcaq}


def interleaved_ms(progs: Dict[str, Callable], x, iters: int, warmup: int = 3,
                   device=None) -> Dict[str, list]:
    """Per program, its milliseconds in each of `iters` rounds, every round
    calling each program once in turn (CUDA events around each call, the
    host included; on the CPU the host clock), after `warmup` rounds.
    Taken in turns, two programs see the same drift of the host's pace."""
    device = torch.device(device if device is not None else x.device)

    def one(fn):
        if device.type == "cuda":
            return cuda_ms(lambda k: fn(x), reps=1, warmup=0)
        t0 = time.perf_counter()
        fn(x)
        return (time.perf_counter() - t0) * 1e3

    for _ in range(warmup):
        for fn in progs.values():
            fn(x)
    times = {name: [] for name in progs}
    for _ in range(iters):
        for name, fn in progs.items():
            times[name].append(one(fn))
    return times


def paired_median_ms(times: Dict[str, list], later: str, earlier: str) -> float:
    """The median over rounds of `later`'s time minus `earlier`'s in the
    same round: a stage's time as the difference of two programs."""
    return statistics.median(a - b for a, b in zip(times[later], times[earlier]))


def component_breakdown(model, images, iters: int = 30, cost: bool = False) -> Dict:
    """Milliseconds of the MCAQ inference forward by stage: `full_ms` and
    `backbone_ms` (medians), and the deltas `morphology_ms` (complexity
    maps over the backbone), `bitmap_quantize_ms` (bit mapper and
    quantizer over that) and `neck_head_ms` (the full forward over that),
    each the median of the per-round differences of `interleaved_ms`: the
    host paces much of the forward, and its pace drifts more between
    programs timed one after the other than a small stage takes.

    cost=True adds `<program>_gflops` and `<program>_gb_floor` for the
    programs full / backbone / cum_complexity / cum_mcaq and the same
    per-stage deltas; `<...>_gb` (XLA's op-count bytes in the JAX package)
    is None: it has no counterpart here."""
    progs = breakdown_programs(model)
    device = images.device
    with torch.inference_mode():
        t = interleaved_ms(progs, images, iters, device=device)
    out = {
        "full_ms": statistics.median(t["full"]),
        "backbone_ms": statistics.median(t["backbone_only"]),
        "morphology_ms": paired_median_ms(t, "with_complexity", "backbone_only"),
        "bitmap_quantize_ms": paired_median_ms(t, "with_mcaq", "with_complexity"),
        "neck_head_ms": paired_median_ms(t, "full", "with_mcaq"),
        **device_stamp(device),
    }
    if cost:
        state = list(model.state_dict().values())
        names = {"full": "full", "backbone": "backbone_only",
                 "cum_complexity": "with_complexity", "cum_mcaq": "with_mcaq"}
        with torch.inference_mode():
            for key, prog in names.items():
                c = program_cost(progs[prog], images, state=state)
                out[f"{key}_gflops"] = c["flops"] / 1e9
                out[f"{key}_gb_floor"] = c["floor_bytes"] / 1e9
                out[f"{key}_gb"] = None
        for suffix in ("gflops", "gb_floor"):
            out[f"morphology_{suffix}"] = (out[f"cum_complexity_{suffix}"]
                                           - out[f"backbone_{suffix}"])
            out[f"bitmap_quantize_{suffix}"] = (out[f"cum_mcaq_{suffix}"]
                                                - out[f"cum_complexity_{suffix}"])
            out[f"neck_head_{suffix}"] = out[f"full_{suffix}"] - out[f"cum_mcaq_{suffix}"]
        for stage in ("morphology", "bitmap_quantize", "neck_head"):
            out[f"{stage}_gb"] = None
    return out

