"""Per-rank accounting of one step, from the ops it dispatches.

The port's counterpart of ``repro.roofline.hlo_analysis``, named apart
because the port has no HLO to parse: PyTorch runs a step eagerly, so the
step itself is run once under a dispatch-level counter, on real tensors or
on fake ones (nothing allocated, ``launch/dryrun.py``). The reference's
module exists because XLA's ``cost_analysis`` counts a ``while`` body once,
so a scanned layer stack is undercounted by its trip count. Here a Python
loop of layers dispatches its ops once a pass, and each is counted where
it runs (``tests/test_torch_roofline.py`` holds a loop of 8 matmuls to 8
times one).

:func:`analyze_step` gives an :class:`OpTotals`:

* ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention) and those the port's ops register
  (``kernels/ops.py``, from ``kernels/costs.py``);
* ``hbm_bytes``: 2 x the output bytes of every op that materialises a
  tensor (read once, written once: the reference's approximation of
  post-fusion traffic in eager terms); views and allocations move none;
  an in-place op counts the tensor it writes; the port's ops count their
  own bytes (:data:`repro_torch.kernels.ops.OP_BYTES`);
* ``collective_bytes`` and ``collective_counts``: the output bytes of the
  ``_c10d_functional`` collectives that DTensor and ``local_map`` issue
  (all-gather, all-reduce, reduce-scatter, all-to-all, broadcast), with
  the ranks of each one's group kept (``collective_groups``) for the link
  rule of :mod:`.analysis`;
* ``peak_bytes``: the most bytes of live storage this rank held during the
  step, its arguments included (XLA's ``memory_analysis`` in the
  reference): a storage counts from the first op output seen on it until
  the last tensor seen on it is freed.

On a device mesh the tensors are DTensors; the counter sits in the fake
mode (:class:`CountingFakeMode`) so that it sees each rank's local ops,
which DTensor runs below any dispatch mode above it: the totals are one
rank's, as the reference's per-device program's are.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")
#: ops that allocate without reading or writing
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "lift_fresh"}


@dataclass
class OpTotals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, float] = field(default_factory=dict)
    #: bytes a group's collectives moved, by the group's ranks
    collective_groups: Dict[Tuple[int, ...], float] = field(
        default_factory=dict)
    peak_bytes: float = 0.0
    argument_bytes: float = 0.0
    while_trip_counts: List[int] = field(default_factory=list)
    ops: int = 0

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["collective_groups"] = [[list(k), v] for k, v in
                                  self.collective_groups.items()]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "OpTotals":
        d = dict(d)
        d["collective_groups"] = {tuple(k): v for k, v in
                                  d.get("collective_groups", [])}
        return cls(**d)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t):
    return getattr(t, "_local_tensor", t)


def _group_ranks(name) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


class _Counter:
    def __init__(self, op_bytes):
        self.t = OpTotals()
        self.op_bytes = op_bytes
        # live storages: their tensors counted, and their bytes
        self.refs: Dict[int, int] = {}
        self.size: Dict[int, int] = {}
        self.cur = 0

    def hold(self, tensors):
        """Count ``tensors``' storages live until the last tensor seen on
        each is freed (a weak-reference finalizer a tensor)."""
        for t in tensors:
            t = _local(t)
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.refs:
                self.refs[key] = 0
                self.size[key] = st.nbytes()
                self.cur += self.size[key]
            self.refs[key] += 1
            weakref.finalize(t, self._drop, key)
        self.t.peak_bytes = max(self.t.peak_bytes, self.cur)

    def _drop(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.cur -= self.size.pop(key)

    def record(self, func, args, kwargs, out):
        t = self.t
        t.ops += 1
        outs = _tensors(out)
        packet = func._overloadpacket
        if packet in flop_registry:
            t.flops += float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        ns, name = func.namespace, packet.__name__
        if ns in _COLLECTIVE_NS and name.replace("_autograd", "") \
                in _COLLECTIVES:
            kind = _COLLECTIVES[name.replace("_autograd", "")]
            nbytes = float(sum(o.nbytes for o in outs))
            t.collective_bytes += nbytes
            t.collective_counts[kind] = t.collective_counts.get(kind, 0) + 1
            group = _group_ranks([a for a in args if isinstance(a, str)][-1])
            t.collective_groups[group] = \
                t.collective_groups.get(group, 0.0) + nbytes
        if func in self.op_bytes:
            t.hbm_bytes += float(self.op_bytes[func](*args))
        elif name not in _ALLOCATIONS:
            for ret, o in zip(func._schema.returns, outs):
                alias = ret.alias_info
                if alias is None or alias.is_write:
                    t.hbm_bytes += 2.0 * o.nbytes
        self.hold(outs)


class _CountingMode(TorchDispatchMode):
    """The counter over plain tensors (real or fake), every op it sees."""

    def __init__(self, counter: _Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter.record(func, args, kwargs, out)
        return out


class CountingFakeMode(FakeTensorMode):
    """A fake mode that counts, while :func:`analyze_step` runs, each op it
    computes (the local ops of DTensors among them). Not counted: an op it
    hands on (``NotImplemented``: a DTensor-level call), the ops of a fake
    rule or a decomposition inside another, and the global-shape ops
    DTensor runs in this mode to learn an output's shape
    (:func:`_dtensor_bookkeeping_uncounted`)."""

    def __init__(self, **kw):
        kw.setdefault("allow_non_fake_inputs", True)
        super().__init__(**kw)
        self.counter = None
        self._depth = 0

    def dispatch(self, func, types, args=(), kwargs=None):
        if self.counter is None or self._depth:
            return super().dispatch(func, types, args, kwargs)
        self._depth += 1
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is not NotImplemented:
            self.counter.record(func, args, kwargs or {}, out)
        return out


@contextmanager
def _dtensor_bookkeeping_uncounted(mode: CountingFakeMode):
    """DTensor's own bookkeeping, which no rank's step does, left out of
    the count: (1) to learn a new op's global output shape it runs the op
    on global-shape fake tensors in the active fake mode (the sharding
    propagator's tensor-meta step); (2) a strided shard's (``_StridedShard``)
    offsets come from index tensors it reads back as integers, which a fake
    tensor cannot give, so they are computed outside the fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    name = ("_propagate_tensor_meta_non_cached"
            if hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
            else "_propagate_tensor_meta")
    propagate = getattr(ShardingPropagator, name)
    offsets = _StridedShard.__dict__.get("local_shard_size_and_offset")

    def uncounted(self, *a, **kw):
        mode._depth += 1
        try:
            return propagate(self, *a, **kw)
        finally:
            mode._depth -= 1

    def real_offsets(self, *a, **kw):
        with unset_fake_temporarily():
            return offsets(self, *a, **kw)

    setattr(ShardingPropagator, name, uncounted)
    if offsets is not None:
        _StridedShard.local_shard_size_and_offset = real_offsets
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, propagate)
        if offsets is not None:
            _StridedShard.local_shard_size_and_offset = offsets


def _op_bytes():
    from repro_torch.kernels.ops import OP_BYTES
    return OP_BYTES


def analyze_step(fn, *args, fake_mode: CountingFakeMode = None,
                 trip_counts=()) -> OpTotals:
    """Run ``fn(*args)`` once and count it -> :class:`OpTotals`. With a
    ``fake_mode`` (whose fake tensors, or DTensors of them, ``args``
    hold) the counter is the fake mode's own; otherwise a dispatch mode
    over plain tensors. ``trip_counts``: the step's layer loops' counts,
    recorded as ``while_trip_counts``."""
    counter = _Counter(_op_bytes())
    counter.hold(_tensors(args))
    counter.t.argument_bytes = float(counter.cur)
    if fake_mode is not None:
        fake_mode.counter = counter
        try:
            with fake_mode, _dtensor_bookkeeping_uncounted(fake_mode):
                fn(*args)
        finally:
            fake_mode.counter = None
    else:
        with _CountingMode(counter):
            fn(*args)
    counter.t.while_trip_counts = [int(n) for n in trip_counts]
    counter.t.collective_counts = dict(counter.t.collective_counts)
    return counter.t


def group_bytes_by_link(groups: Dict[Tuple[int, ...], float],
                        node_ranks: int) -> Dict[str, float]:
    """A step's collective bytes split by the link they cross: NVLink where
    a group's ranks lie in one node of ``node_ranks`` (rank //
    node_ranks), the network between nodes otherwise."""
    out = defaultdict(float)
    for ranks, nbytes in groups.items():
        one_node = len({r // node_ranks for r in ranks}) == 1
        out["nvlink" if one_node else "network"] += nbytes
    return {"nvlink": out["nvlink"], "network": out["network"]}
