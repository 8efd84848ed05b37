"""Weight and cache bridge between the reference's pytrees and the port.

``params_from_numpy`` turns a ``repro`` parameter tree held as numpy arrays
(``jax.tree.map(np.asarray, params)``) into the port's flat parameter dict:
the scanned ``blocks/p{i}`` leaves are unstacked along their leading layer
dim, and every weight keeps its reference layout (an attention block's
``attn``/``ffn`` leaves, a MoE block's ``ffn.router``, ``ffn.we_*`` over
the padded experts and ``ffn.shared_*``, a cross block's ``lnx`` and
``xattn`` leaves, and an RWKV block's ``tm``/``cm`` leaves alike); the
encoder's stacked ``encoder/blocks`` leaves become ``encoder.blocks.{i}.*``
beside ``encoder.final_ln``.
``cache_to_numpy`` goes the other way for caches (K/V rows, page pools, a
cross layer's ``ck``/``cv``, or an RWKV layer's
``tm_prev``/``wkv``/``cm_prev``), so a test can compare the
port's per-layer caches with the reference's stacked cache pytree leaf by
leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import layer_slots


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes: no direct torch view
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)    # own, writable copy


def _block_leaves(blk):
    """``(dotted name, leaf)`` of one block's tree: ``ln1`` and the like at
    the top, ``attn.wq``, ``tm.wr`` and the like one level down."""
    for name, node in blk.items():
        if isinstance(node, dict):
            for sub, leaf in node.items():
                yield f"{name}.{sub}", leaf
        else:
            yield name, node


def params_from_numpy(cfg, tree, device="cpu") -> dict:
    """A reference parameter tree (numpy leaves) -> the port's params."""
    out = {f"embed.{k}": _tensor(v, device)
           for k, v in tree["embed"].items()}
    out["final_ln"] = _tensor(tree["final_ln"], device)
    for i, (_, group, key, index) in enumerate(layer_slots(cfg)):
        for name, leaf in _block_leaves(tree[group][key]):
            out[f"layers.{i}.{name}"] = _tensor(
                leaf if index is None else leaf[index], device)
    if cfg.encoder_layers:
        enc = tree["encoder"]
        for name, leaf in _block_leaves(enc["blocks"]):
            for i in range(cfg.encoder_layers):
                out[f"encoder.blocks.{i}.{name}"] = _tensor(leaf[i], device)
        out["encoder.final_ln"] = _tensor(enc["final_ln"], device)
    if cfg.reward_head:
        out["reward_head.w"] = _tensor(tree["reward_head"]["w"], device)
        out["reward_head.b"] = _tensor(tree["reward_head"]["b"], device)
    return out


def cache_to_numpy(cfg, cache) -> dict:
    """The port's per-layer cache list -> the reference's cache pytree
    layout (``{"blocks": {"p{i}": stacked leaves}, "rem": {...}}``) as
    float32 numpy arrays.  Any per-layer leaves convert: dense decode rows,
    page pools with their scales, cross KV, RWKV state, and the caches
    ``Model.prefill`` returns (padded to capacity, or ring buffers for
    window layers)."""
    groups: dict = {"blocks": {}, "rem": {}}
    for (_, group, key, index), layer in zip(layer_slots(cfg), cache):
        arrays = {k: v.detach().float().cpu().numpy() for k, v in layer.items()}
        if index is None:
            groups["rem"][key] = arrays
        else:
            groups["blocks"].setdefault(key, []).append(arrays)
    out = {"blocks": None, "rem": groups["rem"] or None}
    if groups["blocks"]:
        out["blocks"] = {
            key: {k: np.stack([a[k] for a in reps]) for k in reps[0]}
            for key, reps in groups["blocks"].items()}
    return out
