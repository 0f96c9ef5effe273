"""Roofline terms of one step from its per-rank op counts.

Port of ``repro.roofline.analysis``::

    compute    = FLOPs_per_rank / PEAK_FLOPS[dtype]
    memory     = HBM_bytes_per_rank / HBM_BW
    collective = NVLink bytes / NVLINK_BW + network bytes / NETWORK_BW

The counts come from :mod:`.op_analysis`, which runs the step once under a
dispatch-level counter (the reference parses the compiled per-device HLO),
so every quantity is one rank's and divides by one card's rates. The
seconds are model estimates on these peaks, never measured times.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full power limit: "NVIDIA H100 80GB HBM3, 700.00 W" as ``nvidia-smi``
reports the cards the port has run on):

* float32 on the CUDA cores: 67 TFLOP/s (66.9 unrounded). The port runs
  float32 with TF32 off (``repro_torch.resolve_device``), so a float32
  step's matrix products run here;
* TF32 tensor cores: 495 TFLOP/s (494.7); the flash kernels take three
  TF32 passes a product (``csrc/tf32x3.cuh``), so their work bounds at a
  third of it (:func:`flash_bound_ms`); at bfloat16 inputs fewer (a
  bf16 operand's low part is 0: :func:`flash_passes`);
* bfloat16 tensor cores: 989 TFLOP/s (989.4): a bfloat16 step's
  ``compute`` term (``dtype="bfloat16"``), its matrix products running
  there;
* HBM3: 3.35 TB/s;
* NVLink: 450 GB/s each way a GPU inside an 8-GPU HGX node;
* between nodes: 50 GB/s a GPU (one 400 Gb/s NDR link).

``PERF.md`` §6's bound column uses the rounded rates (the flash row's
"FP32 pipes 0.51333 ms" is 34.39 GFLOP at 67 TFLOP/s; rmsnorm's 0.020034
ms is 67.1 MB at 3.35 TB/s), and :func:`flash_bound_ms` and
:func:`rmsnorm_bound_ms` reproduce them from shapes.

A collective's bytes go to NVLink when its group's ranks lie in one node
of :data:`NODE_RANKS` (rank // 8), to the network otherwise.
``useful_ratio`` and ``model_flops`` keep the reference's definitions
(6 or 2 x active parameters x tokens). XLA's own diagnostics
(``xla_cost_flops``, ``xla_cost_bytes``) have no counterpart and stay 0.0
so that the JSON keys match; ``while_trip_counts`` holds the count of each
Python layer loop the step ran.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

from repro_torch.kernels import costs

from .op_analysis import OpTotals, group_bytes_by_link

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s each way per card, inside a node
NETWORK_BW = 50e9            # bytes/s per card between nodes
NODE_RANKS = 8               # cards a node (HGX H100)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-rank quantities (from the counted step)
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_counts: Dict[str, float] = field(default_factory=dict)
    # XLA's diagnostics in the reference: none here
    xla_cost_flops: float = 0.0
    xla_cost_bytes: float = 0.0
    while_trip_counts: list = field(default_factory=list)
    model_flops: float = 0.0       # global analytic 6ND / 2ND
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0      # model_flops / (hlo_flops * chips)
    per_device_hbm_bytes: float = 0.0

    # not fields (the JSON keys stay the reference's): the step's type and
    # its collective bytes by link, which finalize reads
    dtype = "float32"
    link_bytes = None

    def finalize(self):
        self.compute_s = self.hlo_flops / PEAK_FLOPS[self.dtype]
        self.memory_s = self.hlo_bytes / HBM_BW
        links = self.link_bytes or {"nvlink": self.collective_bytes,
                                    "network": 0.0}
        self.collective_s = (links["nvlink"] / NVLINK_BW
                             + links["network"] / NETWORK_BW)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        if self.hlo_flops:
            self.useful_ratio = self.model_flops / (self.hlo_flops
                                                    * self.chips)
        return self

    def to_dict(self):
        return asdict(self)


def model_flops_per_step(cfg, shape) -> float:
    """Global analytic step FLOPs: 6*N_active*D train, 2*N_active*D
    inference (D = tokens processed)."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # decode: 1 token/seq


def analyze(totals: OpTotals, *, arch: str, shape_name, mesh_name: str,
            chips: int, cfg=None, shape=None,
            dtype: str = "float32") -> RooflineReport:
    """The report of one counted step (:func:`.op_analysis.analyze_step`)
    on ``chips`` ranks."""
    rep = RooflineReport(
        arch=arch, shape=str(shape_name), mesh=mesh_name, chips=chips,
        hlo_flops=totals.flops, hlo_bytes=totals.hbm_bytes,
        collective_bytes=totals.collective_bytes,
        collective_counts=dict(totals.collective_counts),
        while_trip_counts=list(totals.while_trip_counts),
        model_flops=model_flops_per_step(cfg, shape) if cfg is not None
        else 0.0,
        per_device_hbm_bytes=totals.peak_bytes)
    rep.dtype = dtype
    rep.link_bytes = group_bytes_by_link(totals.collective_groups,
                                         NODE_RANKS)
    return rep.finalize()


def bound_ms(nbytes: float, flops: float, rate: float) -> float:
    """The least time of a call: the larger of its bytes over HBM and its
    operations over ``rate``, in ms."""
    return 1e3 * max(nbytes / HBM_BW, flops / rate)


def flash_passes(size: int = 4, backward: bool = False) -> float:
    """TF32 passes a product of the flash kernels, on the average over
    their products, at inputs of ``size`` bytes: three at float32; at
    bfloat16 the passes with a bf16-origin low part go (two in the
    forward's products; in the backward's five, one for S and dP, whose
    operands are all bf16, two for dV, dK and dQ: 8 / 5)."""
    if size == 4:
        return 3.0
    return 8 / 5 if backward else 2.0


def flash_bound_ms(B, Tq, Tk, Hq, Hkv, D, causal, window=0, *, Dv=None,
                   backward=False):
    """(visible pairs, bound on TF32 tensor cores in three passes, bound on
    the FP32 pipes) of a flash call, ms (``PERF.md`` §6's columns); the
    forward at q/k width D and v width Dv (default D)."""
    Dv = D if Dv is None else Dv
    q, k, v = (B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, Dv)
    pairs = costs.flash_pairs(q, k, causal, window)
    if backward:
        flops = costs.flash_bwd_flops(q, k, causal, window)
        nbytes = costs.flash_bwd_bytes(q, k)
    else:
        flops = costs.flash_flops(q, k, v, causal, window)
        nbytes = costs.flash_bytes(q, k, v)
    return (pairs, bound_ms(nbytes, 3 * flops, PEAK_FLOPS["tf32"]),
            bound_ms(nbytes, flops, PEAK_FLOPS["float32"]))


def rmsnorm_bound_ms(rows: int, d: int, *, backward=False) -> float:
    shape = (rows, d)
    if backward:
        return bound_ms(costs.rmsnorm_bwd_bytes(shape),
                        costs.rmsnorm_bwd_flops(shape),
                        PEAK_FLOPS["float32"])
    return bound_ms(costs.rmsnorm_bytes(shape), costs.rmsnorm_flops(shape),
                    PEAK_FLOPS["float32"])


def format_table(reports) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':10s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} "
           f"{'bottleneck':>10s} {'useful':>7s} {'HBM/dev(GB)':>12s}")
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:10s} "
            f"{r.compute_s:10.4g} {r.memory_s:10.4g} {r.collective_s:10.4g} "
            f"{r.bottleneck:>10s} {r.useful_ratio:7.3f} "
            f"{r.per_device_hbm_bytes/1e9:12.2f}")
    return "\n".join(lines)
