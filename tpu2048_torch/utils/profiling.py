"""Timing on the card (counterpart of ``tpu2048/utils/profiling.py``'s
``Timer``): the device's own time of a piece of work beside the host's.

A loop of small launches is usually bound by the host: CUDA events around it
would time the host's enqueue rate. :func:`device_ms` therefore holds the
stream with a sleep kernel while the host enqueues the calls, so that they
then run back to back, and times them with CUDA events.
"""

from __future__ import annotations

import functools
import statistics
import time

import torch


@functools.cache
def cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card,
    taken after a first sleep has let the clocks rise from idle. A guess
    only: :func:`device_ms` checks every sleep it asks for."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, calls: int = 50) -> tuple:
    """(device ms, host enqueue ms) of one ``fn()``, which must not wait on
    the device.

    The sleep must outlast the host's enqueueing. It can fall short in two
    ways: the clock runs faster than :func:`cycles_per_ms` guessed, or the
    device's queue of pending launches fills and the host blocks until the
    sleep ends. After a short sleep the next try sleeps longer and enqueues
    half as many calls; the function raises after a dozen tries."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    cycles = int((2 * (time.perf_counter() - t0) * 1e3 + 5) * cycles_per_ms())
    for _ in range(12):
        begin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        begin.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        end.record()
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        slept = begin.elapsed_time(start)
        if enqueue < slept:
            return start.elapsed_time(end) / calls, enqueue / calls
        cycles = int(cycles * max(2.0, 2 * enqueue / slept))
        calls = max(1, calls // 2)
    raise RuntimeError(f"the host was still enqueueing after a {slept:.3f} ms "
                       f"sleep ({enqueue:.3f} ms for {calls} calls): fn waits "
                       "on the device")


def host_ms(fn, reps: int = 50) -> float:
    """Median host ms of ``fn()`` followed by ``torch.cuda.synchronize()``."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
