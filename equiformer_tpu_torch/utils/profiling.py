"""Profiling utilities: a profiler trace context, step timing, and the
timing and card helpers the measurement tools share (``tools/``).

Counterpart of ``equiformer_tpu/utils/profiling.py``: ``trace`` is a
``torch.profiler`` context in place of ``jax.profiler.trace``, and
``StepTimer.stop`` waits for the result's device streams in place of
``jax.block_until_ready``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``torch.profiler`` trace of the block (CPU, and CUDA where a card is
    present), written to ``logdir`` as a chrome / TensorBoard trace when the
    block ends; a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


def _tensors(result):
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _tensors(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            yield from _tensors(v)


def wait_for(result) -> None:
    """Wait until the work that produces ``result`` (a tensor, or a dict,
    list or tuple holding tensors) is done: the current stream of each CUDA
    device it lies on is synchronized, and nothing else."""
    devices = {t.device for t in _tensors(result) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class StepTimer:
    """Blocking per-step wall-clock timing."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            wait_for(result)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean_ms(self):
        return 1000 * sum(self.times) / max(len(self.times), 1)


def device_time_ms(fn: Callable[[], object], device: torch.device, reps: int = 5,
                   inner: int = 5, warmup: int = 2) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls
    of ``fn``: CUDA events on a CUDA device, the host clock (waiting for
    each call's result) on the CPU."""
    out = None
    for _ in range(warmup):
        out = fn()
    wait_for(out)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                out = fn()
            wait_for(out)
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


# profiler traces kernel_ms takes before it gives up on one that holds no kernel
KERNEL_MS_TRACES = 3


def kernel_ms(fn: Callable[[], object], calls: int, path: Path) -> Dict[str, Tuple[float, float]]:
    """Device time and launches per call of each kernel that ``calls``
    back-to-back calls of ``fn`` launch, {kernel name: (ms, launches)}, from
    a ``torch.profiler`` trace of them written to ``path`` (after one
    warm-up call).  Launches per call are rounded to whole numbers and the
    time per call is the mean launch's times that: the trace can miss the
    first kernel of the window.  A trace now and then comes back without
    any kernel: each retake is reported on stderr with what that trace held
    (its events by category), up to ``KERNEL_MS_TRACES`` traces, then this
    raises."""
    wait_for(fn())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen: Dict[str, Tuple[float, int]] = {}
    for attempt in range(1, KERNEL_MS_TRACES + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        for e in events:
            if e.get("cat") == "kernel" and "dur" in e:
                us, n = seen.get(e["name"], (0.0, 0))
                seen[e["name"]] = (us + float(e["dur"]), n + 1)
        if seen:
            break
        if attempt < KERNEL_MS_TRACES:
            cats = collections.Counter(str(e.get("cat")) for e in events)
            print(f"kernel_ms: trace {attempt} of {KERNEL_MS_TRACES} at {path} holds no kernel "
                  f"(events by category: {dict(cats)}); taking it again", file=sys.stderr,
                  flush=True)
    if not seen:
        raise RuntimeError(f"the trace {path} holds no kernel")
    out = {}
    for name, (us, n) in seen.items():
        per_call = max(1, round(n / calls))
        out[name] = (us / n / 1e3 * per_call, float(per_call))
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def resolve_device(name: Optional[str]) -> torch.device:
    """The device a tool runs on: the card unless ``name`` is "cpu"; raises
    when asked for the card and none is present (no fallback)."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is false); "
                         "pass --device cpu to run the plain versions on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(name or "cuda:0")
