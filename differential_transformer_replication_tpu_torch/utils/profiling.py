"""The trainer's profiler window and throughput counter.

Counterpart of the JAX package's ``utils/profiling.py`` on
``torch.profiler``:

  - ``ProfilerWindow`` captures a fixed window of training iterations
    and writes one Chrome trace into its directory; the trainer drives
    it from the loop. On a CUDA device it records the device's activity
    (every kernel by name, the port's hand-written ones included, and
    the copies): the host side of a step is the span tracer's
    (obs/spans.py), as in the JAX package, and recording every host op
    of a step's ~90,000 launches would multiply the trace and slow the
    steps it watches. On the CPU it records the host ops,
  - ``Throughput`` computes rolling tokens/sec between metric logs; the
    trainer attaches it to every log_step record.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


class ProfilerWindow:
    """Capture iterations [start, start+n) of a training loop.

    Handles the edge cases an inline start/stop pair gets wrong: resuming
    from a checkpoint past the window start (never calls stop without a
    matching start) and loops that end inside the window (``close()``
    finalizes the trace so it is never left running/unwritten). The trace
    is ``<logdir>/trace_<start>-<stop>.json`` (Chrome trace events; open
    in Perfetto or ``chrome://tracing``).
    """

    def __init__(self, logdir: Optional[str], start: int, n_steps: int = 5,
                 device="cpu"):
        self.logdir = logdir
        self.start = start
        self.stop = start + n_steps
        self.active = False
        self.path: Optional[str] = None
        self._activity = (torch.profiler.ProfilerActivity.CUDA
                          if torch.device(device).type == "cuda"
                          else torch.profiler.ProfilerActivity.CPU)
        self._prof = None

    def step(self, iter_num: int) -> None:
        """Call once per loop iteration with the post-increment iteration
        number."""
        if not self.logdir:
            return
        if not self.active and iter_num == self.start:
            self._prof = torch.profiler.profile(activities=[self._activity])
            self._prof.__enter__()
            self.active = True
        elif self.active and iter_num >= self.stop:
            self._finalize()

    def close(self) -> None:
        """Finalize if the loop ended while the window was open."""
        if self.active:
            self._finalize()

    def _finalize(self) -> None:
        if self._activity == torch.profiler.ProfilerActivity.CUDA:
            torch.cuda.synchronize()  # the window's device work lands in it
        t0 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self.active = False
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(self.logdir,
                                 f"trace_{self.start}-{self.stop}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        print(f"Profiler trace written to {self.path} "
              f"({os.path.getsize(self.path) / 1e6:.1f} MB) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


class Throughput:
    """Rolling tokens/sec between ``update`` calls (a copy of the JAX
    package's): ``update(total_tokens)`` takes the cumulative token count
    and returns the rate since the previous call (None on the first call,
    when there is no interval yet). Wall-clock based, so it reflects
    everything the user waits for."""

    def __init__(self) -> None:
        self._last_t: Optional[float] = None
        self._last_tokens = 0

    def update(self, total_tokens: int) -> Optional[float]:
        now = time.perf_counter()
        rate = None
        if self._last_t is not None and now > self._last_t:
            rate = (total_tokens - self._last_tokens) / (now - self._last_t)
        self._last_t = now
        self._last_tokens = total_tokens
        return rate
