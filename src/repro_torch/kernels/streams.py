"""Per-stream scratch and the current stream's handle, for the wrappers
whose kernels need fp32 scratch between two launches of one call (the
paged kernels' partials, the WKV6 scan's segment states).

Calls on one stream run in order (a call's first kernel starts after the
previous call's last one), so each (device, stream) keeps one buffer,
grown as needed and shared by every such wrapper, and a call pays no
allocation; another stream gets its own.  Under CUDA-graph capture the
scratch is allocated afresh from the graph's pool, so that every captured
graph owns its own.
"""
from __future__ import annotations

import torch

_SCRATCH: dict = {}


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
