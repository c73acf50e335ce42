"""The program's tracing (utils/profiling.py): its spans, their frame
indices and threads, the switch, the counters and the stage timings, and
the benchmark's reduction of them (oft_bench/program.py) with the readers
of the metrics that read it (oft_bench/metrics/).

On the CPU: spans and counters of ``VideoPipeline`` at 48^2, and the
reduction on synthetic profiler events. On the card (``cuda``-marked,
skipped here): a captured step's stage events against its replay's device
interval, the counts of captures and replays, and the replay's kernels
against its ``graph.launch`` span.
"""

import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from oft_bench import frames as oftb_frames
from oft_bench import program, spec, trace
from optical_flow_tpu_torch import kernels
from optical_flow_tpu_torch.config import VideoConfig
from optical_flow_tpu_torch.kernels import _lib
from optical_flow_tpu_torch.pipeline.graphs import StepGraph
from optical_flow_tpu_torch.pipeline.video import VideoPipeline
from optical_flow_tpu_torch.utils import profiling

SIZE = 48


def _frames(n=14, hw=(72, 128)):
    return oftb_frames.ring(7, hw, n)


def _profile(device=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device else [])
    return profile(activities=acts, experimental_config=profiling.profiler_config())


@pytest.fixture
def tracing_on():
    before = profiling.set_tracing(True)
    profiling.reset_stages()
    try:
        yield
    finally:
        profiling.set_tracing(before)
        profiling.reset_stages()


def _program_events(prof):
    """(span name, frame index or None, thread, start ns, end ns) of the
    program's spans in a profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name, _, ident = e.name().partition("#")
        if name in program.PROGRAM_SPANS and e.device_type() == DeviceType.CPU:
            out.append((name, int(ident) if ident else None, e.start_thread_id(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


def _drive(pipe, frames, chunk):
    """The benchmark's loops in small: pushes under ``push`` spans, then
    one chunked call with its chunks pulled under ``next_chunk`` spans."""
    for f in frames[:6]:
        with record_function("push"):
            pipe.push(f)
    gen = pipe.run_chunked(frames, chunk_size=chunk, prefetch=2)
    while True:
        with record_function("next_chunk"):
            r = next(gen, None)
        if r is None:
            break


# ------------------------------------------------------------ the switch


def test_tracing_off_draws_no_program_span():
    assert not profiling.tracing()
    assert profiling.span("graph.replay", 3) is profiling.span("upload.pin")
    assert profiling.stage("stage.flow", "cpu") is profiling.span("step.eager")
    pipe = VideoPipeline(VideoConfig.fast(size=(SIZE, SIZE)), device="cpu")
    with _profile() as prof:
        _drive(pipe, _frames(), 5)
    assert _program_events(prof) == []
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "push" in names and "next_chunk" in names  # the benchmark's own spans are there


def test_trace_turns_tracing_on_for_its_block(tmp_path):
    with profiling.trace(str(tmp_path)):
        assert profiling.tracing()
        with profiling.span("step.eager", 4):
            torch.ones(4).sum()
    assert not profiling.tracing()
    assert '"step.eager#4"' in (tmp_path / "trace.json").read_text()


# ------------------------------------------------------- spans and frames


def test_spans_carry_frame_indices_and_nest_in_the_loops_spans(tracing_on):
    frames = _frames()
    pipe = VideoPipeline(VideoConfig.fast(size=(SIZE, SIZE)), device="cpu")
    with _profile() as prof:
        main = threading.get_ident()
        _drive(pipe, frames, 5)
    spans = _program_events(prof)
    loop = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("push", "next_chunk") and e.device_type() == DeviceType.CPU:
            loop.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert main and len(loop) == 1
    (main_thread, outer), = loop.items()
    by = {}
    for name, ident, th, s, e in spans:
        by.setdefault(name, []).append((ident, th, s, e))
    # every push is a step run eagerly on the CPU, frames 0-5; then the
    # chunked call's first chunk (frame 0), its second (frame 5) and the
    # tail's pushes (frames 10-13)
    assert sorted(i for i, *_ in by["step.eager"]) == [0, 0, 1, 2, 3, 4, 5, 5, 10, 11, 12, 13]
    # the worker pulls, stacks and stages chunks of 5 frames: 14 frames are
    # two chunks and a tail of 4
    for name in ("prefetch.pull", "upload.pin", "upload.stage"):
        assert sorted(i for i, *_ in by[name]) == [0, 5, 10]
        assert {th for _, th, _, _ in by[name]} != {main_thread}
    assert sorted(i for i, *_ in by["prefetch.wait"]) == [0, 5, 10]
    # the main thread's spans lie inside the loop's, on the profiler's one clock
    for name in ("step.eager", "prefetch.wait", "stage.flow"):
        for _, th, s, e in by[name]:
            assert th == main_thread
            assert any(a <= s and e <= b for a, b in outer), name
    # the worker's lie between the chunked call's first and last next_chunk
    first, last = min(a for a, _ in outer[6:]), max(b for _, b in outer[6:])
    for _, th, s, e in by["prefetch.pull"]:
        assert first <= s and e <= last
    for st in ("stage.preprocess", "stage.features", "stage.pyramid", "stage.flow",
               "stage.gesture"):
        assert by[st], st


def test_counters_count_eager_steps_and_launches():
    profiling.reset_counters()
    pipe = VideoPipeline(VideoConfig.fast(size=(SIZE, SIZE)), device="cpu")
    frames = _frames()
    for f in frames[:6]:
        pipe.push(f)
    assert profiling.read_counters() == dict(profiling.counters, **{"step.eager": 6})
    list(pipe.run_chunked(frames, chunk_size=5, prefetch=0))
    c = profiling.read_counters()
    # two chunks (the first one, then a steady one) and the tail of 4 pushes
    assert c["step.eager"] == 6 + 2 + 4
    assert c["graph.captures"] == c["graph.replays"] == c["stage.unread"] == 0
    # a replay adds its graph's launches; the benchmark's snapshot reads them
    before = program.snapshot()
    _lib.add_launches({"oft_lk": 1, "oft_pyramid": 1, "oft_pyrup_warp_lk": 3})
    _lib.add_launches({"oft_lk": 1, "oft_pyramid": 1, "oft_pyrup_warp_lk": 3})
    after = program.snapshot()
    delta = {k: after["counters"][k] - before["counters"].get(k, 0) for k in after["counters"]}
    assert delta["launches.oft_lk"] == 2 and delta["launches.oft_pyrup_warp_lk"] == 6
    assert delta["step.eager"] == 0
    kernels.reset_launch_counts()
    profiling.reset_counters()


# ------------------------------------------- stage readings and the switch


class _Event:
    """A completed CUDA timing event, as far as the stage readings use one."""

    def __init__(self, t_ms):
        self.t = t_ms

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


class _Graph:
    def replay(self):
        pass


def _stub_graph():
    """A ``StepGraph`` that was captured with tracing on: one stage of 1.5 ms."""
    g = StepGraph.__new__(StepGraph)
    g.x, g.state, g.out, g.launches = torch.zeros(2), (), torch.zeros(1), {}
    g.graph = _Graph()
    g.marks = profiling.StageMarks(1)
    g.marks.events.append(("stage.flow", _Event(0.0), _Event(1.5)))
    return g


def test_graph_stage_readings_stop_when_tracing_goes_off(tracing_on):
    g = _stub_graph()
    g.replay(torch.ones(2), ())
    g.replay(torch.ones(2), ())  # reads the first replay's stages
    assert profiling.stage_totals() == {"stage.flow": {"ms": 1.5, "frames": 1}}
    profiling.set_tracing(False)  # drops the second replay's recording
    for _ in range(3):
        g.replay(torch.ones(2), ())
    profiling.flush_stages()
    assert profiling.stage_totals() == {"stage.flow": {"ms": 1.5, "frames": 1}}
    profiling.set_tracing(True)
    g.replay(torch.ones(2), ())
    profiling.flush_stages()
    assert profiling.stage_totals() == {"stage.flow": {"ms": 3.0, "frames": 2}}


def test_warm_up_frames_time_no_stage(tracing_on, monkeypatch):
    opened = []
    marks = profiling.stage_marks

    def recording(frames, queue=True):
        opened.append(frames)
        return marks(frames, queue)

    monkeypatch.setattr(profiling, "stage_marks", recording)
    pipe = VideoPipeline(VideoConfig.fast(size=(SIZE, SIZE)), device="cpu")
    for f in _frames(4):
        pipe.push(f)
    assert opened == [1, 1]  # the two warm-up frames open none


# ----------------------------------------------- the reduction, synthetic


class _OldEvent:
    """A profiler event as a torch without ``activity_type`` gives it."""

    def __init__(self, name, device, start_us, dur_us, thread=1, kind=None):
        self._name, self._dev, self._kind = name, device, kind
        self._s, self._d, self._th = int(start_us * 1000), int(dur_us * 1000), thread

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._th


class _NewEvent(_OldEvent):
    def activity_type(self):
        return self._kind


def _timeline(cls, program_spans=True, drawn_on_device=False):
    """A 1000 us window on thread 1; device work at 0-115, 130-210,
    250-450, 600-700 us."""
    ev = [cls("window", False, 0, 1000, kind="user_annotation"),
          cls("push", False, 100, 300, kind="user_annotation"),
          cls("read", False, 400, 100, kind="user_annotation")]
    for s, e, n in ((0, 115, "k0"), (130, 210, "k1"), (250, 450, "k2")):
        ev.append(cls(n, True, s, e - s, kind="kernel"))
    ev.append(cls("Memcpy HtoD (Pinned -> Device)", True, 600, 100, kind="gpu_memcpy"))
    if program_spans:
        ev += [cls("step.eager#0", False, -50, 110, kind="cpu_op"),
               cls("upload.pin#3", False, 110, 40, kind="cpu_op"),
               cls("graph.replay#3", False, 150, 200, kind="cpu_op"),
               cls("graph.copy_in#3", False, 160, 40, kind="cpu_op"),
               cls("graph.launch#3", False, 200, 100, kind="cpu_op"),
               cls("graph.clone_out#3", False, 300, 40, kind="cpu_op"),
               cls("prefetch.wait#8", False, 500, 20, kind="cpu_op"),
               cls("prefetch.pull#4", False, 50, 70, thread=2, kind="cpu_op"),
               cls("upload.pin#4", False, 120, 60, thread=2, kind="cpu_op"),
               cls("upload.stage#4", False, 180, 10, thread=2, kind="cpu_op")]
    if drawn_on_device:
        ev.append(cls("graph.launch#3", True, 205, 90, kind="gpu_user_annotation"))
    return ev


BEFORE = {"counters": {"graph.replays": 5, "graph.captures": 1, "launches.oft_lk": 2,
                       "host_memory.num_host_alloc": 3},
          "stages": {"stage.flow": {"ms": 1.0, "frames": 2}}}
AFTER = {"counters": {"graph.replays": 9, "graph.captures": 1, "launches.oft_lk": 6,
                      "host_memory.num_host_alloc": 3, "step.eager": 1},
         "stages": {"stage.flow": {"ms": 3.0, "frames": 6},
                    "stage.gesture": {"ms": 0.5, "frames": 4},
                    "stage.pyramid": {"ms": 0.2, "frames": 0}}}


@pytest.mark.parametrize("cls", [_NewEvent, _OldEvent], ids=["activity_type", "older_api"])
def test_summarize_program_leaves_the_old_keys(cls):
    video = {"faithful_prev_diff": False}
    old = trace.summarize(_timeline(cls, False), frames=4, video=video)
    new = trace.summarize(_timeline(cls, True), frames=4, video=video)
    assert new == old  # the program's host spans move none of the benchmark's keys
    assert set(new["host_spans"]) <= set(trace.SPANS)
    # a program range drawn on the device's timeline is no device operation
    # for the benchmark's keys either, on both paths
    drawn = _timeline(cls, True, drawn_on_device=True)
    assert trace.summarize(program.benchmark_events(drawn), frames=4, video=video) == old
    p = program.summarize(_timeline(cls, True, drawn_on_device=True), BEFORE, AFTER)
    us = 1e-6
    assert p["spans"]["graph.replay"] == {"total_s": pytest.approx(200 * us),
                                          "self_s": pytest.approx(20 * us), "calls": 1}
    assert p["spans"]["graph.launch"]["self_s"] == pytest.approx(100 * us)
    # both threads' pins; the eager step clipped to the window
    assert p["spans"]["upload.pin"] == {"total_s": pytest.approx(100 * us),
                                        "self_s": pytest.approx(100 * us), "calls": 2}
    assert p["spans"]["step.eager"]["total_s"] == pytest.approx(60 * us)
    assert p["spans"]["prefetch.pull"]["calls"] == 1
    # the range drawn on the device's timeline is no device work: the gap
    # at 210-250 us stays whole, under graph.launch
    assert p["idle"] == {"upload.pin": pytest.approx(15 * us),
                         "graph.launch": pytest.approx(40 * us),
                         "-": pytest.approx(450 * us)}
    assert p["counters"] == {"graph.replays": 4, "graph.captures": 0, "launches.oft_lk": 4,
                             "host_memory.num_host_alloc": 0, "step.eager": 1}
    assert p["stages"] == {"stage.flow": {"ms": 2.0, "frames": 4},
                           "stage.gesture": {"ms": 0.5, "frames": 4}}


READINGS = {
    "upload.pin_ms_per_frame": 0.025,
    "upload.device_wait_ms_per_frame": 0.00375,
    "upload.pinned_allocs": 0.0,
    "graphs.replay_ms_per_frame": 0.05,
    "graphs.device_wait_ms_per_frame": 0.01,
    "graphs.eager_share": 20.0,
    "graphs.captures": 0.0,
    "frame_loop.prefetch_wait_ms_per_frame": 0.005,
    "kernels.launches_per_frame": 1.0,
    "stage.preprocess_ms_per_frame": None,
    "stage.features_ms_per_frame": None,
    "stage.pyramid_ms_per_frame": None,
    "stage.flow_ms_per_frame": 0.5,
    "stage.gesture_ms_per_frame": 0.125,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_program_metric_readers(name):
    summary = trace.summarize(_timeline(_NewEvent), frames=4, video={})
    read = spec.metric_reader(name)
    assert read(summary) is None  # no program key: a run with the program's tracing off
    summary["program"] = program.summarize(_timeline(_NewEvent), BEFORE, AFTER)
    want = READINGS[name]
    assert read(summary) == (None if want is None else pytest.approx(want))
    if name.endswith("device_wait_ms_per_frame"):  # no device trace, as on the CPU
        assert read(dict(summary, device_events=0)) is None


# ---------------------------------------------------- on the card (marked)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_frames(n):
    return oftb_frames.ring(11, (720, 1280), n)


@pytest.mark.cuda
def test_stage_events_of_a_replay_sum_to_its_device_interval(cuda_device, tracing_on):
    pipe = VideoPipeline(VideoConfig.fast(), device=cuda_device)
    for f in _card_frames(4):  # two warm-up frames, the eager step, the capture
        pipe.push(f)
    (g,) = pipe._graphs.values()
    assert g.marks is not None and [n for n, *_ in g.marks.events] == [
        "stage.preprocess", "stage.features", "stage.pyramid", "stage.flow", "stage.gesture"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the SM clock in kHz = cycles per ms
    cycles_per_ms = getattr(torch.cuda.get_device_properties(cuda_device), "clock_rate", 0) or 2e6
    for _ in range(3):  # the graph's own buffers, replayed as they stand
        # the card sleeps while the host launches the graph, so the start
        # event times the graph's work and not the launch's host time
        torch.cuda._sleep(int(2 * cycles_per_ms))
        start.record()
        g.graph.replay()
        end.record()
        torch.cuda.synchronize()
        interval = start.elapsed_time(end)
        stages = sum(b.elapsed_time(c) for _, b, c in g.marks.events)
        assert 0.9 * interval <= stages <= interval, (stages, interval)


@pytest.mark.cuda
def test_replays_and_captures_are_counted(cuda_device):
    profiling.reset_counters()
    kernels.reset_launch_counts()
    pipe = VideoPipeline(VideoConfig.fast(size=(270, 270)), device=cuda_device)
    frames = _card_frames(9)
    for f in frames:
        pipe.push(f)
    torch.cuda.synchronize()
    c = profiling.read_counters()
    # 2 warm-up frames and the step before the capture run eagerly; 6 replays,
    # the first copying in the eager step's state
    assert c == dict(c, **{"graph.captures": 1, "graph.replays": 6, "step.eager": 3,
                           "graph.state_copy_ins": 1, "stage.unread": 0})
    # K1 and K3's levels once a result, K2 once a frame after the first
    launches = kernels.launch_counts()
    assert launches["oft_lk"] == 7 and launches["oft_pyramid"] == 8
    assert launches["oft_pyrup_warp_lk"] > 0 and launches["oft_pyrup_warp_lk"] % 7 == 0
    pipe.restore(pipe.state())  # a state that is not the graph's own
    pipe.push(frames[0])
    assert profiling.read_counters()["graph.state_copy_ins"] == 2
    profiling.reset_counters()
    kernels.reset_launch_counts()


@pytest.mark.cuda
def test_replay_kernels_start_after_their_launch_span(cuda_device, tracing_on):
    pipe = VideoPipeline(VideoConfig.fast(size=(270, 270)), device=cuda_device)
    frames = _card_frames(10)
    for f in frames[:4]:
        pipe.push(f)
    torch.cuda.synchronize()
    cycles_per_ms = getattr(torch.cuda.get_device_properties(cuda_device), "clock_rate", 0) or 2e6
    with _profile(device=True) as prof:
        for f in frames[4:]:
            # the trace's device timestamps can lie 0.1-0.2 ms off its host
            # clock: the card sleeps 2 ms before each push, so a replay's
            # kernels start well after its span opens (the previous
            # replay's, synced by the read, well before)
            torch.cuda._sleep(int(2 * cycles_per_ms))
            r = pipe.push(f)
            r.gesture.votes.item()
    events = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.name().partition("#")[0] == "graph.launch"
                   and e.device_type() == DeviceType.CPU)
    assert len(spans) == 6
    calls = {}
    for e in events:
        if e.name() == "cudaGraphLaunch":
            (span,) = [(a, b) for a, b in spans if a <= e.start_ns() <= b]
            calls[e.correlation_id()] = span
    assert len(calls) == 6
    # and before the next replay's span opens
    following = dict(zip(spans, [b[0] for b in spans[1:]] + [float("inf")]))
    seen = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.correlation_id() in calls:
            span = calls[e.correlation_id()]
            assert span[0] <= e.start_ns() < following[span], e.name()
            seen[span] = seen.get(span, 0) + 1
    assert len(seen) == 6 and min(seen.values()) >= 5  # K2, K1, K3 x 3 at least
