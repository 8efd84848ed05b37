"""Checkpoints of a flat ``{name: tensor}`` dict (atomic write, exact dtype
and shape).

A port of ``repro.checkpoint.ckpt``'s contract without msgpack.  Format:
one numpy ``.npz`` archive (``numpy.savez``, uncompressed) holding array
``"{i}"`` for the i-th tensor in the dict's order, copied to the host, and
``"__meta__"``, the UTF-8 JSON ``{"names": [...], "dtypes": [...],
"shapes": [...]}`` as uint8.  A bfloat16 tensor is stored as its uint16
bit pattern and its dtype recorded as ``"bfloat16"``, so it round-trips
bit for bit.  The archive is written to a temporary file in the target's
directory and moved into place with ``os.replace``; a failed write removes
the temporary file and leaves any earlier checkpoint as it was.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def save_checkpoint(path: str, params: dict) -> None:
    """Write ``params`` to ``path`` atomically (see the module docstring)."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        meta = {"names": list(params),
                "dtypes": [str(t.dtype).removeprefix("torch.")
                           for t in params.values()],
                "shapes": [list(t.shape) for t in params.values()]}
        arrays = {str(i): _to_numpy(t) for i, t in enumerate(params.values())}
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                           np.uint8)
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: dict, device=None) -> dict:
    """Restore the dict ``like`` describes (its names, count and shapes are
    checked; a mismatch raises) with the saved dtypes, on ``device`` (the
    device of ``like``'s tensors when None)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(z["__meta__"].tobytes().decode())
        names = meta["names"]
        if len(names) != len(like):
            raise ValueError(f"checkpoint has {len(names)} leaves, "
                             f"expected {len(like)}")
        if set(names) != set(like):
            raise KeyError(f"checkpoint names differ: missing "
                           f"{sorted(set(like) - set(names))[:4]}, "
                           f"unexpected {sorted(set(names) - set(like))[:4]}")
        out = {}
        for i, (name, dtype, shape) in enumerate(
                zip(names, meta["dtypes"], meta["shapes"])):
            ref = like[name]
            if tuple(shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {name}: {tuple(shape)} "
                                 f"vs {tuple(ref.shape)}")
            t = _from_numpy(z[str(i)], dtype).reshape(shape)
            out[name] = t.to(ref.device if device is None else device)
    return {name: out[name] for name in like}
