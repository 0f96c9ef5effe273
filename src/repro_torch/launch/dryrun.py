"""Dry run: every (arch x shape) step of the reference's production meshes,
on fake tensors, counted into roofline terms.

Port of ``repro.launch.dryrun``. The reference lowers and compiles each
step for a 256- or 512-chip mesh of host devices and reads the compiled
HLO. The port runs each step once on a fake process group of 256 or 512
ranks (this process is rank 0): the production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`, built before any
fake tensor exists), then, under a fake mode, the step's arguments as
DTensors of fake local shards laid out by :mod:`repro_torch.distributed`'s
specs (nothing is allocated), and one call of the mesh step of
``distributed/steps.py``: ``build_train_step`` (AdamW included),
``build_prefill_step`` or ``build_serve_step``, with ``decode_window`` as
the reference gives it. The LM kernels run as their ops' fake rules
(``kernels/ops.py``), which refuse what the card would.
:mod:`repro_torch.roofline.op_analysis` counts the rank's ops; the report
(:mod:`repro_torch.roofline.analysis`) has the reference's keys, and its
seconds are model estimates on an NVIDIA H100's peaks, not measured
times.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b \\
        --shape train_4k --device cpu [--multi-pod] [--out experiments/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --reanalyze

Each combo writes ``<arch>__<shape>__<mesh>.json`` (read by the
reference's ``benchmarks/roofline_table.py``) and its op counts,
``<arch>__<shape>__<mesh>.ops.json``, which ``--reanalyze`` turns into
reports again with no run. ``--device`` is ``cuda`` unless ``cpu`` is
given: the fake tensors then report the card as their device, and a
process with no GPU refuses it. The dtype defaults to bfloat16, as the
reference's: the config's ``dtype`` and ``param_dtype`` both (the AdamW
moments stay float32), and the report's compute term on the bf16 tensor
cores' peak; ``--dtype float32`` counts the float32 step. Importing this
module starts nothing; the group lives for one run and is destroyed when
it ends.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from contextlib import contextmanager

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ALIASES, canonical
from repro_torch.kernels._build import LAUNCHES
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.op_analysis import (CountingFakeMode, OpTotals,
                                              analyze_step)

#: meshes by --multi-pod: (tag, ranks)
MESHES = {False: ("16x16", 256), True: ("2x16x16", 512)}
ESTIMATES = ("model estimates on the peaks of one NVIDIA H100 80GB HBM3 at "
             "700.00 W (repro_torch.roofline.analysis), not measured times")


@contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the block's length. Raises if this process has a group already (a
    fake group cannot sit beside it)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("this process has a process group already; run "
                           "the dry run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, spec, mesh):
    from repro_torch.distributed import sharding as shd
    return tuple(s.stop - s.start
                 for s in shd.local_shard(tuple(shape), spec, mesh))


def _tree_map(fn, tree, specs):
    from repro_torch.distributed import sharding as shd
    return shd._tree_map(fn, tree, specs)


class _Args:
    """Fake DTensors of a step's arguments, their local shapes computed
    outside the fake mode (they read the mesh's coordinates)."""

    def __init__(self, mesh, device, dtype):
        self.mesh, self.device, self.dtype = mesh, device, dtype
        self.shapes = {}

    def plan(self, shape, spec):
        key = (tuple(shape), tuple(spec))
        if key not in self.shapes:
            self.shapes[key] = _local_shape(shape, spec, self.mesh)

    def plan_tree(self, tree, specs):
        _tree_map(lambda t, s: self.plan(t.shape, s), tree, specs)

    def make(self, shape, spec, dtype):
        from repro_torch.distributed import sharding as shd
        local = torch.empty(self.shapes[(tuple(shape), tuple(spec))],
                            dtype=dtype, device=self.device)
        return shd.from_shard(local, tuple(shape), spec, self.mesh)

    def make_tree(self, tree, specs, dtype=None):
        """Fake DTensors of ``tree``'s shapes: floating leaves in ``dtype``
        (default the run's)."""
        dtype = dtype or self.dtype
        return _tree_map(lambda t, s: self.make(
            t.shape, s, dtype if t.dtype.is_floating_point
            else t.dtype), tree, specs)


def _trip_counts(params) -> list:
    """The layer loops a step runs: each segment's layers (and the
    encoder's)."""
    counts = [len(seg) for seg in params.get("segments", [])]
    if "encoder" in params:
        counts.append(len(params["encoder"]))
    return counts


def _step_and_args(cfg, shape, mesh, window, args: _Args, mode):
    """(the call to count, the arguments it holds, its parameters tree)
    of one combo, the arguments fake DTensors made under ``mode``."""
    from repro_torch.distributed import steps as S
    from repro_torch.optim.adamw import AdamWState, leaves
    if shape.mode == "train":
        fn, in_specs, _, (st_shape, b_shapes) = S.build_train_step(
            cfg, TrainConfig(), mesh, shape)
        sspec, bspec = in_specs
        args.plan_tree(st_shape.params, sspec.params)
        for m in (st_shape.opt.mu, st_shape.opt.nu):
            args.plan_tree(list(m), list(sspec.opt.mu))
        for k, v in b_shapes.items():
            args.plan(v, bspec[k])
        with mode:
            params = args.make_tree(st_shape.params, sspec.params)
            for p in leaves(params):
                p.requires_grad_(True)
            # the moments are float32 whatever the parameters' type
            mu, nu = (args.make_tree(list(m), list(sspec.opt.mu),
                                     torch.float32)
                      for m in (st_shape.opt.mu, st_shape.opt.nu))
            batch = {k: args.make(v, bspec[k], args.dtype if k == "frames"
                                  else torch.int64)
                     for k, v in b_shapes.items()}
        state = S.TrainState(params=params, opt=AdamWState(
            mu=mu, nu=nu, count=st_shape.opt.count), step=0)
        return (lambda s, b: fn(s, b)), (state, batch), params
    if shape.mode == "prefill":
        fn, (pspec, bspec), _, (p_shape, b_shapes) = S.build_prefill_step(
            cfg, mesh, shape, window_override=window)
        args.plan_tree(p_shape, pspec)
        for k, v in b_shapes.items():
            args.plan(v, bspec[k])
        with mode:
            params = args.make_tree(p_shape, pspec)
            batch = {k: args.make(v, bspec[k], args.dtype if k == "frames"
                                  else torch.int64)
                     for k, v in b_shapes.items()}
        return fn, (params, batch), params
    fn, in_specs, _, shapes = S.build_serve_step(cfg, mesh, shape,
                                                 window_override=window)
    args.plan_tree(shapes["params"], in_specs["params"])
    args.plan_tree(shapes["caches"], in_specs["caches"])
    args.plan(shapes["token"], in_specs["token"])
    if "enc_out" in shapes:
        args.plan(shapes["enc_out"], in_specs["enc_out"])
    with mode:
        params = args.make_tree(shapes["params"], in_specs["params"])
        caches = args.make_tree(shapes["caches"], in_specs["caches"])
        token = args.make(shapes["token"], in_specs["token"], torch.int64)
        extra = ((args.make(shapes["enc_out"], in_specs["enc_out"],
                            args.dtype),) if "enc_out" in shapes else ())
    index = shape.seq_len - 1
    return ((lambda p, t, c, *e: fn(p, t, c, index, *e)),
            (params, token, caches, *extra), params)


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               dtype: str = "bfloat16", device=None, verbose: bool = True):
    """Count one combo on a fake group of 256 (512 with ``multi_pod``)
    ranks, the config at ``dtype`` (its ``dtype`` and ``param_dtype``, as
    the reference's dry run sets them) -> (report dict,
    :class:`OpTotals`)."""
    from repro_torch.distributed import steps as S
    from repro_torch.launch.mesh import make_production_mesh
    device = resolve_device(device)
    cfg = get_config(arch).replace(dtype=dtype, param_dtype=dtype)
    shape = INPUT_SHAPES[shape_name]
    mesh_name, chips = MESHES[multi_pod]
    window = S.decode_window(cfg, shape)
    t0 = time.time()
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        mode = CountingFakeMode()
        args = _Args(mesh, device, getattr(torch, dtype))
        call, call_args, params = _step_and_args(cfg, shape, mesh, window,
                                                 args, mode)
        t_build = time.time() - t0
        totals = analyze_step(call, *call_args, fake_mode=mode,
                              trip_counts=_trip_counts(params))
        t_run = time.time() - t0 - t_build
    d = report(totals, arch, shape_name, multi_pod=multi_pod, dtype=dtype,
               cfg=cfg)
    d.update({"build_s": round(t_build, 2), "run_s": round(t_run, 2),
              "window_override": window, "device": device.type,
              # the hand-written kernels this process launched: none, the
              # ops ran as their fake rules
              "kernel_launches": {k: v for k, v in LAUNCHES.items() if v}})
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK (run "
              f"{t_run:.1f}s, bottleneck={d['bottleneck']}, "
              f"peak/rank={d['per_device_hbm_bytes'] / 1e9:.2f} GB)")
        print("  per rank: flops=%.3e bytes=%.3e coll=%.3e; compute %.4g s, "
              "memory %.4g s, collective %.4g s (%s)" % (
                  d["hlo_flops"], d["hlo_bytes"], d["collective_bytes"],
                  d["compute_s"], d["memory_s"], d["collective_s"],
                  "model estimates"), flush=True)
    return d, totals


def report(totals: OpTotals, arch: str, shape_name: str, *, multi_pod: bool,
           dtype: str, cfg=None) -> dict:
    """The JSON of one combo from its op counts: the reference's keys, then
    the counts' own."""
    mesh_name, chips = MESHES[multi_pod]
    shape = INPUT_SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    rep = RA.analyze(totals, arch=arch, shape_name=shape_name,
                     mesh_name=mesh_name, chips=chips, cfg=cfg, shape=shape,
                     dtype=dtype)
    d = rep.to_dict()
    d.update({
        "lower_s": 0.0, "compile_s": 0.0, "mode": shape.mode,
        "memory_analysis": {
            "argument_size_in_bytes": int(totals.argument_bytes),
            "output_size_in_bytes": 0,
            "temp_size_in_bytes": int(totals.peak_bytes
                                      - totals.argument_bytes),
            "alias_size_in_bytes": 0, "generated_code_size_in_bytes": 0},
        "collective_bytes_by_link": rep.link_bytes, "dtype": dtype,
        "ops": totals.ops, "seconds_are": ESTIMATES})
    return d


def _paths(out, arch, shape_name, mesh_tag):
    base = os.path.join(out, f"{arch}__{shape_name}__{mesh_tag}")
    return base + ".json", base + ".ops.json"


def reanalyze(out: str, multi_pod: bool, dtype: str) -> int:
    """Every saved op record of a mesh -> its report again."""
    mesh_tag = MESHES[multi_pod][0]
    n = 0
    for arch in ARCH_IDS:
        for shape_name in INPUT_SHAPES:
            json_path, ops_path = _paths(out, arch, shape_name, mesh_tag)
            if not os.path.exists(ops_path):
                continue
            with open(ops_path) as f:
                totals = OpTotals.from_dict(json.load(f))
            d = report(totals, arch, shape_name, multi_pod=multi_pod,
                       dtype=dtype)
            if os.path.exists(json_path):
                with open(json_path) as f:
                    old = json.load(f)
                for k in ("build_s", "run_s", "window_override", "device",
                          "kernel_launches"):
                    if k in old:
                        d[k] = old[k]
            with open(json_path, "w") as f:
                json.dump(d, f, indent=2)
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count every step of the production meshes on fake "
                    "tensors (a fake group of 256 or 512 ranks).")
    ap.add_argument("--arch", nargs="+",
                    choices=sorted(list(ARCH_IDS) + list(ALIASES)),
                    help="one or more; with --shape, every pair is run")
    ap.add_argument("--shape", nargs="+", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all 40 combos on the chosen mesh")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the config's dtype and param_dtype: bfloat16 "
                         "(the default, as the reference's) or float32")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the fake tensors' device")
    ap.add_argument("--reanalyze", action="store_true",
                    help="re-derive the JSONs from the saved .ops.json "
                         "records (no run)")
    args = ap.parse_args(argv)

    if args.reanalyze:
        n = reanalyze(args.out, args.multi_pod, args.dtype)
        print(f"reanalyzed {n} combos for mesh {MESHES[args.multi_pod][0]}")
        return

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(canonical(a), s) for a in args.arch for s in args.shape]
    else:
        ap.error("--arch and --shape, or --all")
    mesh_tag = MESHES[args.multi_pod][0]
    failures = []
    for arch, shape_name in combos:
        json_path, ops_path = _paths(args.out, arch, shape_name, mesh_tag)
        try:
            d, totals = dryrun_one(arch, shape_name,
                                   multi_pod=args.multi_pod,
                                   dtype=args.dtype, device=args.device)
            with open(json_path, "w") as f:
                json.dump(d, f, indent=2)
            with open(ops_path, "w") as f:
                json.dump(totals.to_dict(), f)
        except Exception as e:
            failures.append((arch, shape_name, mesh_tag, repr(e)))
            print(f"[dryrun] FAIL {arch} x {shape_name} x {mesh_tag}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall {len(combos)} combos counted OK")


if __name__ == "__main__":
    main()
