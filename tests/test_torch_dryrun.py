"""The port's dry run (``repro_torch.launch.dryrun``) on a fake (16, 16)
group of 256 ranks, device cpu, at one SMOKE config a family (qwen3,
jamba, deepseek-v3, whisper) and the reference's four input shapes.

The group cannot share a process with another (pytest-xdist runs later
files on the same worker), so one subprocess runs every combo and writes
what the tests read: each report (at float32), the kernels' launch counts
before and after, each combo's argument bytes against the sum of its local
shards by ``distributed/sharding.py``'s specs, qwen3's train_4k at
bfloat16 (the dry run's default, as the reference's) with its argument
bytes by the specs, a counted all-gather on the model axis, and whether a
group is left. Each report's
fields are finite, its keys are the reference's ``RooflineReport``
fields, and the reference's ``benchmarks/roofline_table.py`` reads the
JSON the port writes.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from benchmarks import roofline_table  # noqa: E402
from repro.roofline.analysis import RooflineReport  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3_0_6b", "jamba_v0_1_52b", "deepseek_v3_671b", "whisper_base")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

_SCRIPT = r'''
import json, math, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import smoke_config
from repro_torch.kernels import _build
from repro_torch.launch import dryrun
dryrun.get_config = smoke_config        # the SMOKE configs, full shapes
out = sys.argv[1]
res = {"launches_before": dict(_build.LAUNCHES), "args": {}}
for arch in %(archs)r:
    for shape in %(shapes)r:
        d, totals = dryrun.dryrun_one(arch, shape, device="cpu",
                                      dtype="float32", verbose=False)
        with open(f"{out}/{arch}__{shape}__16x16.json", "w") as f:
            json.dump(d, f)
        res["args"][f"{arch}/{shape}"] = totals.argument_bytes
res["launches_after"] = dict(_build.LAUNCHES)

# each combo's arguments by the specs alone: the sum of this rank's shards
from repro_torch.configs import INPUT_SHAPES, TrainConfig
from repro_torch.distributed import sharding as shd, steps as S
from repro_torch.launch.mesh import make_production_mesh
want = {}
with dryrun.fake_group(256):
    mesh = make_production_mesh(device="cpu")
    def nbytes(shape, spec, itemsize):
        return itemsize * math.prod(s.stop - s.start for s in
                                    shd.local_shard(shape, spec, mesh))
    def tree_bytes(tree, specs, itemsize=4):
        total = []
        shd._tree_map(lambda t, s: total.append(nbytes(tuple(t.shape), s,
                      itemsize)), tree, specs)
        return sum(total)
    for arch in %(archs)r:
        cfg = smoke_config(arch)
        for shape_name in %(shapes)r:
            shape = INPUT_SHAPES[shape_name]
            window = S.decode_window(cfg, shape)
            if shape.mode == "train":
                _, (ss, bs), _, (st, bsh) = S.build_train_step(
                    cfg, TrainConfig(), mesh, shape)
                b = tree_bytes(st.params, ss.params) + 2 * tree_bytes(
                    list(st.opt.mu), list(ss.opt.mu))
                b += sum(nbytes(v, bs[k], 8 if k == "tokens" else 4)
                         for k, v in bsh.items())
            elif shape.mode == "prefill":
                _, (ps, bs), _, (psh, bsh) = S.build_prefill_step(
                    cfg, mesh, shape, window_override=window)
                b = tree_bytes(psh, ps) + sum(
                    nbytes(v, bs[k], 8 if k == "tokens" else 4)
                    for k, v in bsh.items())
            else:
                _, ins, _, shs = S.build_serve_step(cfg, mesh, shape,
                                                    window_override=window)
                b = (tree_bytes(shs["params"], ins["params"])
                     + tree_bytes(shs["caches"], ins["caches"])
                     + nbytes(shs["token"], ins["token"], 8))
                if "enc_out" in shs:
                    b += nbytes(shs["enc_out"], ins["enc_out"], 4)
            want[f"{arch}/{shape_name}"] = b

    # one all-gather over the model axis (ranks 0-15: two nodes of 8)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.roofline.op_analysis import (CountingFakeMode,
                                                  analyze_step)
    mode = CountingFakeMode()
    with mode:
        x = DTensor.from_local(torch.empty(4, 8), mesh,
                               [Replicate(), Shard(0)], run_check=False)
    t = analyze_step(lambda a: a.redistribute(
        mesh, [Replicate(), Replicate()]).to_local() * 2, x, fake_mode=mode)
    res["gather"] = {"bytes": t.collective_bytes,
                     "counts": t.collective_counts,
                     "groups": [[list(k), v] for k, v in
                                t.collective_groups.items()]}
    # qwen3's train_4k at bfloat16: parameters 2 bytes, moments 4
    cfg = smoke_config("qwen3_0_6b")
    _, (ss, bs), _, (st, bsh) = S.build_train_step(
        cfg, TrainConfig(), mesh, INPUT_SHAPES["train_4k"])
    res["bf16_want_args"] = (tree_bytes(st.params, ss.params, 2)
                             + 2 * tree_bytes(list(st.opt.mu),
                                              list(ss.opt.mu))
                             + sum(nbytes(v, bs[k], 8)
                                   for k, v in bsh.items()))
res["want_args"] = want
d, totals = dryrun.dryrun_one("qwen3_0_6b", "train_4k", device="cpu",
                              verbose=False)
res["bf16"] = {"report": d, "args": totals.argument_bytes}
res["group_left"] = dist.is_initialized()
with open(f"{out}/result.json", "w") as f:
    json.dump(res, f)
'''


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT % {"archs": ARCHS, "shapes": SHAPES},
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    with open(out / "result.json") as f:
        return out, json.load(f)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_report_is_finite_with_the_reference_s_keys(run, arch, shape):
    out, res = run
    with open(out / f"{arch}__{shape}__16x16.json") as f:
        d = json.load(f)
    fields = [f.name for f in dataclasses.fields(RooflineReport)]
    assert set(fields) <= set(d)
    for k in fields:
        v = d[k]
        if isinstance(v, float):
            assert math.isfinite(v), k
    assert d["hlo_flops"] > 0 and d["hlo_bytes"] > 0
    assert d["per_device_hbm_bytes"] >= \
        d["memory_analysis"]["argument_size_in_bytes"] > 0
    assert d["bottleneck"] in ("compute", "memory", "collective")
    assert d["chips"] == 256 and d["mesh"] == "16x16"
    assert res["args"][f"{arch}/{shape}"] == \
        res["want_args"][f"{arch}/{shape}"]


def test_the_reference_table_reads_the_port_s_json(run):
    out, _ = run
    rows = roofline_table.load(str(out), "16x16")
    assert len(rows) == len(ARCHS) * len(SHAPES)
    text = roofline_table.fmt(rows, markdown=True)
    assert text.count("\n") == len(rows) + 1


def test_no_kernel_is_launched(run):
    _, res = run
    assert res["launches_after"] == res["launches_before"]


def test_bfloat16_fails_with_the_kernels_refusal(run):
    """(The name is kept from when the port's kernels refused bfloat16.)
    The dry run's default run, qwen3's train_4k at bfloat16, counts a
    finite report with the reference's keys: its arguments the specs' at 2
    bytes a parameter and 4 a moment, less than the float32 run's; its
    compute term on the bf16 tensor cores' peak."""
    from repro_torch.roofline.analysis import PEAK_FLOPS
    _, res = run
    d = res["bf16"]["report"]
    fields = [f.name for f in dataclasses.fields(RooflineReport)]
    assert set(fields) <= set(d)
    assert all(math.isfinite(d[k]) for k in fields
               if isinstance(d[k], float))
    assert d["dtype"] == "bfloat16" and d["hlo_flops"] > 0
    assert d["compute_s"] == pytest.approx(d["hlo_flops"]
                                           / PEAK_FLOPS["bfloat16"])
    assert res["bf16"]["args"] == res["bf16_want_args"]
    assert res["bf16"]["args"] < res["args"]["qwen3_0_6b/train_4k"]
    assert d["memory_analysis"]["argument_size_in_bytes"] == \
        res["bf16"]["args"]


def test_a_model_axis_gather_is_counted_on_the_network(run):
    """4 x 8 floats a rank, gathered over the model axis (ranks 0-15)."""
    _, res = run
    g = res["gather"]
    assert g["bytes"] == 64 * 8 * 4
    assert g["counts"] == {"all-gather": 1}
    assert g["groups"] == [[list(range(16)), 64 * 8 * 4]]


def test_the_group_is_destroyed(run):
    _, res = run
    assert res["group_left"] is False
