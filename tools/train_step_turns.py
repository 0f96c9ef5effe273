#!/usr/bin/env python3
"""Time the DVQ-AE pretraining and fine-tuning steps of several checkouts in
turns, on one NVIDIA GPU.

    python3 tools/train_step_turns.py [--rounds R] LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout of this repository (``this`` = the
checkout that holds this script, the default). The two packages share a
name, so each trial is a process of its own that imports ``repro_torch``
from its DIR: it builds the state and batch of ``chip_smoke.py``'s ``train``
phase (``DVQAEConfig()``, batch 32 of 32 x 32 x 3 images, seed 0) and
times ``server_pretrain_step`` and ``client_finetune_step`` with that
phase's ``step_ms`` (median of 20 steps by CUDA events, after 3 warm-up
steps). The trials run in turns, first, second, ..., second, first, R
rounds, after one untimed process a checkout that builds its kernels.
Prints the card's name and power limit, each trial as a JSON line, then one
JSON line with every checkout's medians, their median, least and most; exits
non-zero without a GPU or when a trial fails.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(tree: Path) -> dict:
    """One trial in this process, against ``tree``'s package."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    import chip_smoke  # its step timing; it imports no torch at import
    from repro_torch.core import octopus as OC
    from repro_torch.core.dvqae import DVQAEConfig
    from repro_torch.data.synthetic import make_images
    dev = torch.device("cuda")
    cfg = DVQAEConfig()
    seed = chip_smoke.SEED
    x = make_images(torch.Generator().manual_seed(seed + 1), 32, size=32,
                    n_identities=8).x.to(dev)
    holder = {"s": OC.server_init(seed, cfg, device=dev)}

    def pretrain_step():
        holder["s"], _ = OC.server_pretrain_step(holder["s"], cfg, x)

    client = {"c": OC.client_init(holder["s"])}

    def finetune_step():
        client["c"], _, _ = OC.client_finetune_step(client["c"], cfg, x)

    return {"pretrain_step_ms_median": chip_smoke.step_ms(pretrain_step),
            "finetune_step_ms_median": chip_smoke.step_ms(finetune_step)}


def run(tree: str, *args: str) -> dict:
    res = subprocess.run([sys.executable, __file__, *args, tree],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"trial on {tree} failed:\n{res.stdout}"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        sys.path.insert(0, str(Path(argv[1]) / "src"))
        from repro_torch.kernels import _build
        print(json.dumps({"library": str(_build.build())}))
        return 0
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]).resolve())), flush=True)
        return 0
    rounds = 5
    if argv[:1] == ["--rounds"]:
        rounds, argv = int(argv[1]), argv[2:]
    import torch
    if not torch.cuda.is_available():
        print("train_step_turns: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    trees = dict(a.split("=", 1) for a in argv) or {"this": str(ROOT)}
    trees = {k: str(Path(v).resolve()) for k, v in trees.items()}
    for tree in trees.values():
        run(tree, "--build")
    order = list(trees) + list(trees)[::-1]
    got = {k: {"pretrain": [], "finetune": []} for k in trees}
    for r in range(rounds):
        for label in order:
            t = run(trees[label], "--one")
            got[label]["pretrain"].append(t["pretrain_step_ms_median"])
            got[label]["finetune"].append(t["finetune_step_ms_median"])
            print(json.dumps({"round": r, "label": label, **t}), flush=True)

    def summary(v):
        return {"median": statistics.median(v), "min": min(v), "max": max(v),
                "trials": v}
    print(json.dumps({"card": smi, "rounds": rounds, "order": order,
                      "steps": {k: {s: summary(v) for s, v in g.items()}
                                for k, g in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
