#!/usr/bin/env python3
"""Host cost of the LM kernels' entry points, two checkouts in turns on one
NVIDIA GPU: a checkout whose ``kernels/ops.py`` dispatches through
``torch.library`` ops against one that calls the wrappers directly.

    python3 tools/op_dispatch_turns.py parent=<dir> this=. [--rounds R]

Each trial is a process of its own that runs one checkout (its ``src``
first on ``sys.path``, its kernels built into its own ``build/``):

* host µs a call of ``ops.rmsnorm`` at (8, 1,024) and of
  ``ops.flash_attention`` at 16 tokens (8, 16, 16/8, 128), under
  ``torch.no_grad()`` as serving calls them: 1,000 calls after a warm-up,
  one synchronize, over the count;
* the qwen3-0.6b decode step at full width and depth (weights drawn from
  a seed on the card), batch 8: ``launch.serve.generate`` over 16 prompt
  tokens and 112 generated ones, each serve step timed on the host with a
  synchronize; the median of the steps past the first 16.

Rounds run parent, this, this, parent. Prints one JSON line a trial, then
a summary: each checkout's median, least and largest over its trials, and
this checkout's medians over the parent's. Exits non-zero without a GPU.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def trial(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.distributed import steps as S
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def host_us(fn, calls=1000):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    x = torch.randn((8, 1024), generator=gen, device=dev)
    s = torch.rand((1024,), generator=gen, device=dev)
    q = torch.randn((8, 16, 16, 128), generator=gen, device=dev)
    kv = torch.randn((8, 16, 8, 128), generator=gen, device=dev)
    with torch.no_grad():
        rms = host_us(lambda: ops.rmsnorm(x, s))
        flash = host_us(lambda: ops.flash_attention(q, kv, kv))
    cfg = get_config("qwen3_0_6b")
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 16), generator=gen,
                            device=dev)
    walls = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = S.serve_step(*args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    serve.generate(params, cfg, prompts, 112, step=timed)
    return {"checkout": str(root), "card": torch.cuda.get_device_name(0),
            "rmsnorm_8x1024_host_us": rms,
            "flash_attention_16_tokens_host_us": flash,
            "decode_step_ms_median": statistics.median(walls[16:]),
            "decode_steps": len(walls) - 16}


def main(argv) -> int:
    if argv[:1] == ["--trial"]:
        print(json.dumps(trial(Path(argv[1]).resolve())), flush=True)
        return 0
    rounds = 1
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    dirs = dict(a.split("=", 1) for a in argv)
    if set(dirs) != {"parent", "this"}:
        print("usage: op_dispatch_turns.py parent=<dir> this=<dir> "
              "[--rounds R]", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode:
        print("op_dispatch_turns: no GPU", file=sys.stderr)
        return 1
    print(smi.stdout.strip(), flush=True)
    got = {"parent": [], "this": []}
    for _ in range(rounds):
        for name in ("parent", "this", "this", "parent"):
            proc = subprocess.run(
                [sys.executable, __file__, "--trial", dirs[name]],
                capture_output=True, text=True)
            if proc.returncode:
                print(proc.stdout[-2000:], proc.stderr[-4000:],
                      file=sys.stderr)
                return 1
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            row["name"] = name
            got[name].append(row)
            print(json.dumps(row), flush=True)
    keys = ("rmsnorm_8x1024_host_us", "flash_attention_16_tokens_host_us",
            "decode_step_ms_median")
    summary = {name: {k: {"median": statistics.median(r[k] for r in rows),
                          "min": min(r[k] for r in rows),
                          "max": max(r[k] for r in rows)}
                      for k in keys} for name, rows in got.items()}
    summary["this_over_parent"] = {
        k: summary["this"][k]["median"] / summary["parent"][k]["median"]
        for k in keys}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
