"""Sharding rules: parameter-path names -> partition specs, and specs ->
DTensor placements.

Port of ``repro.distributed.sharding``, its rules copied in logic:

  embed (V, d)                 vocab on 'model'  (fallback d)
  head  (d, V)                 V on 'model'
  column-parallel  (.., in, out)   out on 'model'   [wq wk wv wi wg up_proj
                                                     in_proj x_proj w_in
                                                     wq_a wq_b wkv_a wkv_b
                                                     ffn_up router]
  row-parallel     (.., in, out)   in on 'model'    [wo down_proj out_proj
                                                     dt_proj ffn_down]
  experts (.., E, in, out)     E on 'model' (expert parallelism)
  scale/bias/1-D               replicated

Models with >= ``FSDP_THRESHOLD`` parameters also shard a second dim over
the data axes (training; inference only where the tensor-parallel shard
passes ``INFER_TP_BYTES_LIMIT``). A preferred dim that the axis does not
divide falls back to the largest free dim it divides, or to replication.

A spec is the port's :class:`P`, a tuple with one entry a tensor dim: an
axis name, a tuple of names, or None. Specs are computed on the
reference's shapes and paths: a segment's leaves are stacked on a leading
layer axis there (never sharded), so the port's per-layer leaf takes the
stacked leaf's spec without its first entry (:func:`param_specs`).
:func:`to_placements` turns a spec into the ``Shard``/``Replicate``
placements of a ``DeviceMesh`` whose dims carry the axis names;
:func:`shard_tree` distributes a tree of tensors by a tree of specs. A mesh
here is a ``DeviceMesh`` or a :class:`repro_torch.launch.mesh.AbstractMesh`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

FSDP_THRESHOLD = 10_000_000_000

COLUMN_NAMES = {"wq", "wk", "wv", "wi", "wg", "up_proj", "in_proj", "x_proj",
                "w_in", "wq_a", "wq_b", "wkv_a", "wkv_b", "ffn_up", "router",
                "w_if", "proj"}
ROW_NAMES = {"wo", "down_proj", "out_proj", "dt_proj", "ffn_down"}
EMBED_NAMES = {"embed"}
HEAD_NAMES = {"head"}

# TP-only param bytes above which inference keeps FSDP (the reference's
# v5e HBM budget: leave room for caches and activations)
INFER_TP_BYTES_LIMIT = 12e9


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``;
    dims past its length are replicated and a tuple of one axis is that
    axis, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def _default_dp_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def data_axis_size(mesh) -> int:
    """Size of the data axes (1 without a mesh): a sharded SimEngine
    round needs the cohort size to divide by it."""
    if mesh is None:
        return 1
    return _axis_size(mesh, _default_dp_axes(mesh))


def _place(spec: list, shape, dim: int, axes, size: int,
           taken: set) -> bool:
    """Try to put ``axes`` on ``dim``; greedy fallback over free dims."""
    order = [dim] + sorted((d for d in range(len(shape)) if d != dim),
                           key=lambda d: -shape[d])
    for d in order:
        if d in taken or spec[d] is not None:
            continue
        if shape[d] % size == 0 and shape[d] >= size:
            spec[d] = axes if isinstance(axes, str) else tuple(axes)
            taken.add(d)
            return True
    return False


def _leaf_spec(path_names: Tuple[str, ...], shape, mesh, *, fsdp: bool,
               dp_axes, model_axis="model") -> P:
    ndim = len(shape)
    spec: list = [None] * ndim
    taken: set = set()
    msize = _axis_size(mesh, model_axis)
    dsize = _axis_size(mesh, dp_axes)
    name = path_names[-1] if path_names else ""
    in_experts = "experts" in path_names
    # stacked segments have a leading layer axis; skip it for rule dims
    lead = 1 if ("segments" in path_names and ndim >= 2) else 0
    if in_experts:
        lead += 1  # expert axis sits after the layer axis

    if ndim == 0 or ndim == 1 or name in {"scale", "bias", "dt_bias", "A_log",
                                          "D", "skip_scale"}:
        return P()

    if in_experts and ndim - lead >= 2:
        # expert-parallel: expert dim on model axis
        edim = lead - 1
        _place(spec, shape, edim, model_axis, msize, taken)
        if fsdp:
            _place(spec, shape, ndim - 1 if name != "wo" else ndim - 2,
                   dp_axes, dsize, taken)
        return P(*spec)

    if name in EMBED_NAMES:
        _place(spec, shape, 0, model_axis, msize, taken)
        if fsdp:
            _place(spec, shape, 1, dp_axes, dsize, taken)
        return P(*spec)
    if name in HEAD_NAMES:
        _place(spec, shape, ndim - 1, model_axis, msize, taken)
        if fsdp:
            _place(spec, shape, ndim - 2, dp_axes, dsize, taken)
        return P(*spec)
    if name in COLUMN_NAMES or (name == "kernel" and ndim >= 3):
        _place(spec, shape, ndim - 1, model_axis, msize, taken)
        if fsdp:
            _place(spec, shape, ndim - 2, dp_axes, dsize, taken)
        return P(*spec)
    if name in ROW_NAMES:
        _place(spec, shape, ndim - 2, model_axis, msize, taken)
        if fsdp:
            _place(spec, shape, ndim - 1, dp_axes, dsize, taken)
        return P(*spec)
    # unknown matrices: model on the last dim, fsdp on the second-to-last
    _place(spec, shape, ndim - 1, model_axis, msize, taken)
    if fsdp:
        _place(spec, shape, ndim - 2, dp_axes, dsize, taken)
    return P(*spec)


def _unstacked(spec: P, names) -> P:
    """A stacked leaf's spec without its layer entry, which must be
    unsharded (no config shards it)."""
    if spec and spec[0] is not None:
        raise ValueError(f"{'/'.join(names)}: the rules shard the stacked "
                         f"layer axis ({spec}); the port holds layers apart")
    return P(*spec[1:])


def param_specs(params, cfg, mesh, *, dp_axes=None, mode: str = "train"):
    """The spec tree of the port's LM parameter tree (tensors, meta
    tensors or anything with ``.shape``), the same structure: each
    leaf's spec is the reference's ``param_specs`` of the leaf at its
    reference path and stacked shape, the layer entry dropped for a leaf
    of ``segments`` or ``encoder``.

    mode="train": >= 10 B models FSDP over the data axes. mode="infer":
    parameters stay TP-only wherever the per-device TP shard fits the
    budget; only models whose TP shard exceeds it keep FSDP."""
    dp_axes = dp_axes or _default_dp_axes(mesh)
    fsdp = cfg.param_count() >= FSDP_THRESHOLD
    if mode == "infer" and fsdp:
        tp_bytes = cfg.param_count() * 2 / _axis_size(mesh, "model")
        if tp_bytes <= INFER_TP_BYTES_LIMIT:
            fsdp = False

    def leaf(names, shape):
        return _leaf_spec(names, tuple(shape), mesh, fsdp=fsdp,
                          dp_axes=dp_axes)

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (str(k),)) for k, v in node.items()}
        return leaf(names, node.shape)

    def stack(layers, names):
        """Per-layer dicts of one stack -> their specs, each from the
        leaf stacked over the stack's layers."""
        n = len(layers)

        def one(node, path):
            if isinstance(node, dict):
                return {k: one(v, path + (str(k),)) for k, v in node.items()}
            full = names + path
            return _unstacked(leaf(full, (n,) + tuple(node.shape)), full)

        return [one(layer, ()) for layer in layers]

    out = {}
    for key, node in params.items():
        if key == "segments":
            out[key] = [stack(layers, ("segments", str(s)))
                        for s, layers in enumerate(node)]
        elif key == "encoder":
            out[key] = stack(node, ("encoder",))
        else:
            out[key] = walk(node, (key,))
    return out


def batch_spec(mesh) -> P:
    return P(_default_dp_axes(mesh))


# model-axis dim preference per cache field (dims indexed on the STACKED
# leaf: 0=segment-layer axis, 1=batch). Chosen so the decode contraction
# stays local or reduces to a tiny partial-sum all-reduce:
#   attn k/v (L,B,S,H,D): heads first (fully local attention); else S —
#     never D first (D on model re-gathers the whole cache when heads
#     don't divide).
#   mla c_kv (L,B,S,R): latent rank first, else S.
#   mamba h (L,B,di,N): channel di (state update is elementwise in di).
#   mlstm C/n (L,B,NH,DH[,DH]): last DH.
_CACHE_MODEL_PREF = {
    "k": (3, 4, 2), "v": (3, 4, 2),          # KVCache
    "c_kv": (3, 2), "k_rope": (2,),          # MLACache
    "h": (2,), "conv": (3,),                 # MambaCache (+ sLSTM h)
    "C": (4, 3), "n": (3, 2), "m": (),       # MLSTMCache / SLSTMCache
    "c": (2,),
}


def _cache_leaf_spec(field: str, shape, mesh) -> P:
    dp_axes = _default_dp_axes(mesh)
    dsize = _axis_size(mesh, dp_axes)
    msize = _axis_size(mesh, "model")
    ndim = len(shape)
    spec: list = [None] * ndim
    taken = {0}                              # stacked layer axis
    if ndim >= 2:
        if shape[1] % dsize == 0 and shape[1] >= dsize:
            spec[1] = dp_axes
            taken.add(1)
        elif ndim > 2:
            # batch too small: put data axes on the longest dim
            _place(spec, shape, int(max(range(2, ndim),
                                        key=lambda d: shape[d])),
                   dp_axes, dsize, taken)
    pref = _CACHE_MODEL_PREF.get(field)
    order = [d for d in (pref or ()) if d < ndim] + \
        [d for d in range(ndim - 1, 1, -1) if pref is None]
    for d in order:
        if d not in taken and spec[d] is None and shape[d] % msize == 0 \
                and shape[d] >= msize:
            spec[d] = "model"
            break
    return P(*spec)


def cache_specs(caches, cfg, mesh, *, batch: int):
    """Field-name-aware cache sharding of the port's per-segment stacked
    caches (a list of NamedTuples, leaves (L_seg, B, ...)) -> the same
    list of NamedTuples of specs. Batch goes on the data axes (a batch the
    axes do not divide falls back to the longest dim); the model axis
    follows ``_CACHE_MODEL_PREF`` per field. Each spec keeps its stacked
    layer entry (None), as the caches keep their layer axis."""
    return [type(c)(*(_cache_leaf_spec(f, tuple(t.shape), mesh)
                      for f, t in zip(c._fields, c)))
            for c in caches]


# ------------------------------------------------------------ placements

def to_placements(spec, mesh) -> tuple:
    """The ``Shard``/``Replicate`` placement of each dim of ``mesh`` (a
    ``DeviceMesh`` whose dims carry the axis names) for a tensor of
    partition ``spec``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec or ()):
        if entry is None:
            continue
        for axis in ((entry,) if isinstance(entry, str) else entry):
            i = names.index(axis)
            if out[i].is_shard():
                raise ValueError(f"spec {spec} puts mesh axis {axis!r} on "
                                 f"two dims")
            out[i] = Shard(dim)
    return tuple(out)


def _tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P) \
            and not isinstance(tree, torch.Tensor):
        out = [_tree_map(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """Every tensor of ``tree`` (dicts, lists, NamedTuples) as a DTensor
    laid out by its spec in ``specs`` (the same structure), from the
    tensor each rank holds (rank 0's values are the ones kept)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        return distribute_tensor(t.detach(), mesh, to_placements(spec, mesh))

    return _tree_map(one, tree, specs)


def local_shard(global_shape, spec, mesh) -> Tuple[slice, ...]:
    """The slices of a tensor of ``global_shape`` that this rank holds
    under ``spec`` (empty slices where it holds none)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        tuple(global_shape), mesh, to_placements(spec, mesh))
    return tuple(slice(o, o + n) for o, n in zip(offset, shape))


def from_shard(local: torch.Tensor, global_shape, spec, mesh):
    """A DTensor of ``global_shape`` from this rank's ``local`` shard
    (:func:`local_shard`'s slices of it)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=torch.Size(global_shape),
                              stride=_contiguous_stride(global_shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def data_group(mesh):
    """The process group of this rank's data axes (``data``, or ``pod``
    and ``data`` flattened) and this rank's index in it."""
    import torch.distributed as dist
    dp = _default_dp_axes(mesh)
    sub = mesh[dp[0]] if len(dp) == 1 else mesh[dp]._flatten()
    group = sub.get_group()
    return group, dist.get_rank(group)
