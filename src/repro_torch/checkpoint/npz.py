"""Checkpoints in the reference's .npz layout: path-keyed arrays in one
file, a JSON sidecar with the step and metadata, atomic rename,
versioned ``step_%08d.npz`` files pruned to the newest ``keep``.

Port of ``repro.checkpoint.npz``. A file written by either package loads
in the other. Keys are the reference's ``jax.tree_util`` paths: a dict key
as itself, a NamedTuple field as ``.field``, joined by ``/``
(``.params/embed``, ``.opt/.mu/segments/0/mixer/wq``, ``.opt/.count``,
``.step``). The port holds a segment as a list of per-layer dicts; the
reference stacks a segment's layers on a leading axis (its ``lax.scan``
layout), and so does the file. The port's AdamW moments are lists in the
order of ``optim.adamw.leaves(params)``; in the file they take the
parameters' paths, as the reference's moment trees do. Ints (the step and
AdamW's count) are int32 scalars.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.steps import TrainState
from repro_torch.optim.adamw import leaves


def _like_params(params, flat):
    """A list of tensors in ``leaves(params)`` order, in the tree shape of
    ``params``."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(params)


def _tree(state):
    """A TrainState's moments in the parameters' tree shape."""
    if isinstance(state, TrainState):
        opt = state.opt
        return state._replace(opt=opt._replace(
            mu=_like_params(state.params, opt.mu),
            nu=_like_params(state.params, opt.nu)))
    return state


def _is_layers(node) -> bool:
    """A segment: a list of per-layer dicts, stacked in the file."""
    return isinstance(node, list) and bool(node) \
        and all(isinstance(v, dict) for v in node)


def _walk(node, prefix: str, out: Dict[str, Any]) -> None:
    """``out[key] = leaf`` for every leaf of ``node``; a segment's leaves
    as lists of per-layer leaves under one key."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for name, v in zip(node._fields, node):
            _walk(v, f"{prefix}.{name}/", out)
    elif isinstance(node, dict):
        for k, v in node.items():
            _walk(v, f"{prefix}{k}/", out)
    elif _is_layers(node):
        per_layer = []
        for layer in node:
            one: Dict[str, Any] = {}
            _walk(layer, "", one)
            per_layer.append(one)
        for key in per_layer[0]:
            out[prefix + key] = [one[key] for one in per_layer]
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = node


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, list):                  # a segment's layers
        return np.stack([_array(x) for x in leaf])
    if isinstance(leaf, torch.Tensor):         # bfloat16 widened (exact):
        leaf = leaf.detach().cpu()             # the restore casts it back
        return (leaf.float() if leaf.dtype == torch.bfloat16
                else leaf).numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def to_arrays(tree) -> Dict[str, np.ndarray]:
    """Path-keyed numpy arrays of a TrainState or a tree of tensors."""
    out: Dict[str, Any] = {}
    _walk(_tree(tree), "", out)
    return {k: _array(v) for k, v in out.items()}


def save_pytree(path: str, tree, *, metadata: Optional[dict] = None):
    """Atomic save: write a temporary file beside ``path``, then rename."""
    save_arrays(path, to_arrays(tree), metadata=metadata)


def save_arrays(path: str, arrays: Dict[str, np.ndarray], *,
                metadata: Optional[dict] = None):
    """Atomic save of path-keyed arrays (see :func:`save_pytree`)."""
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def _rebuild(node, prefix: str, data):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_rebuild(v, f"{prefix}.{name}/", data)
                            for name, v in zip(node._fields, node)))
    if isinstance(node, dict):
        return {k: _rebuild(v, f"{prefix}{k}/", data)
                for k, v in node.items()}
    if _is_layers(node):
        return [_rebuild(layer, prefix, _Layer(data, j))
                for j, layer in enumerate(node)]
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, f"{prefix}{i}/", data)
                          for i, v in enumerate(node))
    arr = data[prefix[:-1]]
    if isinstance(node, torch.Tensor):
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"{prefix[:-1]}: shape {arr.shape} in the file, "
                             f"{tuple(node.shape)} in the state")
        return torch.tensor(arr, dtype=node.dtype, device=node.device) \
            .requires_grad_(node.requires_grad)
    return type(node)(arr.item())


class _Layer:
    """Layer ``j`` of the stacked arrays of a segment."""

    def __init__(self, data, j: int):
        self.data, self.j = data, j

    def __getitem__(self, key):
        return self.data[key][self.j]


def load_pytree(path: str, like) -> Any:
    """The state saved at ``path`` in the structure, dtypes and devices of
    ``like`` (a TrainState or a tree of tensors; its paths must be in the
    file)."""
    with np.load(path) as data:
        state = _rebuild(_tree(like), "", data)
    if isinstance(like, TrainState):
        opt = state.opt
        state = state._replace(opt=opt._replace(mu=leaves(opt.mu),
                                                nu=leaves(opt.nu)))
    return state


def save_server_state(path: str, state) -> None:
    """A DVQ-AE ``ServerState`` in the reference's ``.state.npz`` layout
    (``convert.server_state_to_numpy``), written atomically."""
    from repro_torch.convert import server_state_to_numpy
    save_arrays(path, server_state_to_numpy(state))


def load_server_state(path: str, cfg, *, device=None):
    """A ``.state.npz`` written by either package -> a ``ServerState`` on
    ``device`` (cuda unless ``device="cpu"``)."""
    from repro_torch.convert import server_state_from_numpy
    with np.load(path) as data:
        return server_state_from_numpy(dict(data), cfg, device=device)


def _checkpoints(ckpt_dir: str):
    return sorted(f for f in os.listdir(ckpt_dir)
                  if f.startswith("step_") and f.endswith(".npz"))


def save(ckpt_dir: str, step: int, state, *, keep: int = 3,
         metadata: Optional[dict] = None) -> str:
    """Versioned save: ``ckpt_dir/step_00000042.npz`` with its JSON
    sidecar (``metadata`` and the step), pruned to the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    save_pytree(path, state, metadata={**(metadata or {}), "step": step})
    for old in _checkpoints(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
        side = os.path.join(ckpt_dir, old + ".json")
        if os.path.exists(side):
            os.remove(side)
    return path


def restore(ckpt_dir: str, like) -> Tuple[Optional[Any], int]:
    """The latest checkpoint in ``ckpt_dir`` in ``like``'s structure and
    its step, or (None, 0) when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None, 0
    ckpts = _checkpoints(ckpt_dir)
    if not ckpts:
        return None, 0
    latest = ckpts[-1]
    step = int(latest[len("step_"):-len(".npz")])
    return load_pytree(os.path.join(ckpt_dir, latest), like), step
