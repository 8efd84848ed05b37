"""Per-stream scratch, the current stream's handle and the launch counts,
for the wrappers.  The scratch serves the wrappers whose kernels need fp32
scratch between two launches of one call (the paged kernels' partials, the
WKV6 scan's segment states).

Launches on one stream run in order, so one host thread's calls on one
stream never overlap: a call's first kernel starts after the previous
call's last one.  Each (device, stream) therefore keeps one buffer, grown
as needed and shared by every such wrapper, and a call pays no
allocation; another stream gets its own.  Two host threads on one stream
would interleave their split and combine launches over that one buffer,
so every thread that launches concurrently with another runs on a stream
of its own: the replica fleet's threads each run under their replica's
stream (``serving/replica.py``).  Under CUDA-graph capture the scratch is
allocated afresh from the graph's pool, so that every captured graph owns
its own.

Each wrapper counts its launches on its own ``launches`` attribute through
:func:`launched`, under one lock, so that concurrent replica threads lose
no count.
"""
from __future__ import annotations

import threading

import torch

_SCRATCH: dict = {}
_COUNT = threading.Lock()


def launched(fn) -> None:
    """Add one to ``fn.launches`` (a wrapper's launch count) under a lock:
    ``+=`` on an attribute is not atomic across threads."""
    with _COUNT:
        fn.launches += 1


def scratch(dev, stream, n):
    """fp32 scratch of at least ``n`` elements on ``stream`` of device
    index ``dev``, or ``None`` (a null pointer) when ``n`` is 0."""
    if n == 0:
        return None
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(n, dtype=torch.float32, device=dev)
    buf = _SCRATCH.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[dev, stream] = torch.empty(n, dtype=torch.float32,
                                                  device=dev)
    return buf


def current(dev):
    """The current stream's handle on device index ``dev``, as an int.
    torch.cuda.current_stream builds a Stream object (about 5 microseconds
    of host time on the H100 machines, a third of the paged wrapper's);
    the raw getter, which PyTorch's own Triton launchers use, does not."""
    return torch._C._cuda_getCurrentRawStream(dev)
