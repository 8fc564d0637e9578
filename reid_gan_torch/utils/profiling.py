"""Tracing and step timing (port of ``reid_gan_tpu/utils/profiling.py``).

- ``trace``: a context manager around ``torch.profiler`` (the host and, on
  a card, CUDA activity) that writes a Chrome trace into ``log_dir``
  (open it in Perfetto or ``chrome://tracing``).
- ``annotate``: a named host range (``torch.profiler.record_function``), so
  that clustering or IO phases show in a trace.
- ``StepTimer``: a wall-clock step meter for the ``Time x.xxx (x.xxx)`` log
  lines, and the throughput.
- ``timeit`` and ``flops_of``: the speed scripts' (``scripts/torch_profile_
  *.py``) ms a call and GFLOP a call, one copy for all of them.
"""

import contextlib
import os
import os.path as osp
import time

import torch

from .meters import AverageMeter


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Profile the block and write ``<log_dir>/trace_<pid>_<ns>.json``;
    yields the ``torch.profiler.profile`` (its ``events()`` and
    ``key_averages()``) and, after the block, keeps the file's path in its
    ``trace_path``. The card, where there is one, is synchronised before the
    profiler stops. ``enabled=False`` yields None and records nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.trace_path = osp.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def annotate(name):
    """A named host range inside a trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """``start()`` once, then ``tick()`` after each step: ``avg`` is the
    mean step time (s) and ``throughput()`` ``items_per_step / avg``."""

    def __init__(self, items_per_step=None):
        self.meter = AverageMeter()
        self.items = items_per_step
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.meter.update(now - self._last)
        self._last = now

    @property
    def avg(self):
        return self.meter.avg

    def throughput(self):
        if not self.items or self.meter.avg == 0:
            return 0.0
        return self.items / self.meter.avg


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, iters=30, warmup=3):
    """Wall-clock ms a call of ``fn(*args)``: ``warmup`` calls, then
    ``iters`` calls with one synchronisation of the card after the last, as
    the JAX scripts' ``timeit`` blocks once on the last output. Dispatch and
    the host are in it: it is not the card's time (CUDA events)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters * 1e3


def flops_of(fn, *args):
    """GFLOP of one call of ``fn(*args)``, as torch's ``FlopCounterMode``
    counts them: the matmuls and convolutions the call runs, forward and
    backward; elementwise work, norms and the hand-written kernels count
    nothing. It stands in for the JAX scripts' XLA ``cost_analysis``: the
    two agree within 1% on ResNet-50's eval forward, and torch's count of
    its forward and backward is about 5% under XLA's."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops() / 1e9
