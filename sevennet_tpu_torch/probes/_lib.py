"""What the probes share: the launch stream, the device check of their
wrappers and CUDA-event timing of captured calls."""

from __future__ import annotations

import ctypes

import torch

# (n1, n2, tries) of diff_ms for the TPU scripts' timing methods: the r2
# scripts' difftime (r2_pallas_mm.py:14-29, r2_pallas_fma.py:19-34) and the
# fold scripts' timed (r3_fold_probe.py:99-117, r4_fold_probe.py:167-187)
R2_TIME = (50, 250, 3)
FOLD_TIME = (3, 9, 3)
# cycles of the spin a replay of one_call_queued_ms waits behind on the
# device (about 0.5 ms at the H100's clock): longer than the host takes to
# enqueue the start event, the replay and the end event
QUEUE_CYCLES = 1_000_000


def stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check_device(plain: bool, *tensors) -> bool:
    """True when the plain version runs: ``plain``, on any device. Else the
    kernel: every tensor must lie on one CUDA device (a CPU tensor raises)."""
    if plain:
        return True
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"the probe kernels run on one CUDA device, got {sorted(map(str, devs))}; "
                         "pass plain=True for the plain version")
    return False


def _capture(fn, n: int):
    """A CUDA graph of ``n`` back-to-back calls of ``fn``, replayed once.
    ``fn`` runs once on a side stream before the capture (build and
    first-launch set-up stay out of the graph)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()  # warm
    return graph


def _replay_ms(graph, replays: int, queued: bool) -> float:
    best = float("inf")
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def graph_ms(fn, n: int, replays: int = 1) -> float:
    """ms of ``n`` back-to-back calls of ``fn`` on the device alone: the
    calls are captured in one CUDA graph, whose replay is timed by CUDA
    events, so that the host's cost per call (the wrapper's checks and
    allocation, the launch) is not in the time; the least of ``replays``
    replays. ``fn`` runs once on a side stream before the capture (build and
    first-launch set-up stay out of the graph). The host's latency to launch
    the replay lies between the events: a replay of one short call is
    mostly that latency (:func:`one_call_queued_ms` leaves it out)."""
    return _replay_ms(_capture(fn, n), replays, queued=False)


def one_call_queued_ms(fn, replays: int = 20) -> float:
    """ms of one call of ``fn`` alone, as :func:`graph_ms` ``(fn, 1,
    replays)`` times it but with each replay and its events queued behind a
    spin on the device (``QUEUE_CYCLES``): the host's latency to launch the
    replay falls outside the events, the launch on the device and the
    kernel stay in."""
    return _replay_ms(_capture(fn, 1), replays, queued=True)


def diff_ms(fn, n1: int, n2: int, tries: int) -> float:
    """Device ms per call of ``fn``, the TPU probe scripts' differential
    method: the difference of ``n2`` and ``n1`` back-to-back calls over ``n2
    - n1``, best of ``tries``, after one call as warm-up, which removes the
    fixed cost of a run; each run of calls is one CUDA graph
    (:func:`graph_ms`)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(tries):
        t1, t2 = graph_ms(fn, n1), graph_ms(fn, n2)
        best = min(best, (t2 - t1) / (n2 - n1))
    return best
