"""Render a flight-recorder trace into per-round summaries.

    PYTHONPATH=src python -m repro_torch.obs.report trace.jsonl
    PYTHONPATH=src python -m repro_torch.obs.report trace.jsonl --check \\
        --json OBS_report.json

Port of ``repro.obs.report``, line for line: the JSONL schema is the
reference's, so this report reads the reference's traces and the
reference's report reads the port's.

Reads the JSONL event stream a :class:`repro_torch.obs.FlightRecorder` wrote
and reconstructs the numbers the ROADMAP asks for MEASURED, not
computed: per-round uplinks/sec, bytes/round, per-codebook-version
decode latency, merge cadence, and the queue-depth profile. ``--json``
writes the summary as a BENCH-style section (``{"section": "obs",
"rows": [{name, value, extra}]}``) so trend tooling can diff traces the
same way it diffs ``BENCH_<section>.json`` artifacts.

``--check`` enforces the §2.8 accounting invariant INSIDE the trace:
for every round event, the sum of that round's ``uplink`` events'
measured ``nbytes`` must equal the round's ``bytes_sent`` ledger (which
the traffic loops compute from ``CodePayload.nbytes`` as payloads hit
the queue) — byte-exact, or the exit code is non-zero. A trace with no
uplink events also fails the check: an empty recorder is not evidence.

Continuous-ingest traces (``admission`` events present, every round
event carrying ``bytes_in_flight``) additionally get the conservation
check: Σ uplink bytes == Σ ingested bytes + Σ admission-REJECTED bytes
+ Σ admission-DUPLICATE bytes + the final tick's bytes still in flight
— i.e. every refused, retransmitted-and-deduplicated, or deferred
payload stays on the ledger, backpressure, faults and migration
included. Chaos-plane traces (``fault`` / ``retry`` / ``recovery``
events) get their injected-fault histogram, retry count and recovery
drill summarized alongside.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence


def load_events(path: str) -> List[Dict[str, Any]]:
    """Parse one JSONL trace; blank lines are skipped."""
    events = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not a JSON event: "
                                 f"{e}") from e
    return events


def summarize(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate an event stream into the per-round / per-version views.

    Uplink/ingest totals come from the events' measured ``nbytes``;
    per-round throughput divides the round's uplink count by the round
    event's ``dur_ms``; decode latency groups ``decode`` events by the
    codebook version they dispatched against.
    """
    kinds: Dict[str, int] = defaultdict(int)
    up = {"n": 0, "bytes": 0, "dropped": 0, "dropped_bytes": 0}
    ingest = {"n": 0, "bytes": 0}
    per_round_up: Dict[int, Dict[str, int]] = defaultdict(
        lambda: {"n": 0, "bytes": 0})
    rounds: List[Dict[str, Any]] = []
    decode: Dict[Any, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "total_ms": 0.0, "n_samples": 0})
    merges: List[Any] = []
    admission = {"n": 0, "bytes": 0,
                 "verdicts": defaultdict(int),
                 "verdict_bytes": defaultdict(int),
                 "reasons": defaultdict(int)}
    migrations: List[Dict[str, Any]] = []
    faults: Dict[str, int] = defaultdict(int)
    retries = 0
    recoveries: List[Dict[str, Any]] = []
    for ev in events:
        kind = ev.get("kind", "?")
        kinds[kind] += 1
        if kind == "uplink":
            up["n"] += 1
            up["bytes"] += int(ev.get("nbytes", 0))
            if ev.get("dropped"):
                up["dropped"] += 1
                up["dropped_bytes"] += int(ev.get("nbytes", 0))
            if "round" in ev:
                r = per_round_up[int(ev["round"])]
                r["n"] += 1
                r["bytes"] += int(ev.get("nbytes", 0))
        elif kind == "ingest":
            ingest["n"] += 1
            ingest["bytes"] += int(ev.get("nbytes", 0))
        elif kind == "round":
            rounds.append(dict(ev))
        elif kind == "decode":
            d = decode[ev.get("version")]
            d["count"] += 1
            d["total_ms"] += float(ev.get("dur_ms", 0.0))
            d["n_samples"] += int(ev.get("n_samples", 0))
        elif kind == "merge":
            merges.append(ev.get("version"))
        elif kind == "admission":
            admission["n"] += 1
            nb = int(ev.get("nbytes", 0))
            admission["bytes"] += nb
            v = str(ev.get("verdict", "?"))
            admission["verdicts"][v] += 1
            admission["verdict_bytes"][v] += nb
            if ev.get("reason"):
                admission["reasons"][str(ev["reason"])] += 1
        elif kind == "migration":
            migrations.append({k: ev.get(k) for k in
                               ("phase", "src", "dst", "policy",
                                "src_records", "src_bytes", "n_reencoded")
                               if k in ev})
        elif kind == "fault":
            faults[str(ev.get("fault", "?"))] += 1
        elif kind == "retry":
            retries += 1
        elif kind == "recovery":
            recoveries.append({k: ev.get(k) for k in
                               ("tick", "snapshot_tick", "n_replayed",
                                "dur_ms", "queue_depth", "store_records")
                               if k in ev})

    # one row per round INDEX: a crash-recovered service re-emits ticks
    # of the indices the crashed instance already traced (recovery is a
    # point on the same timeline, not a fork), so counter fields SUM
    # across the event group while gauges (queue depth, in-flight) come
    # from the group's last event — the per-round §2.8 identity then
    # holds across the kill
    by_rid: Dict[Any, Dict[str, Any]] = {}
    order: List[Any] = []
    for ev in sorted(rounds, key=lambda e: e.get("round", -1)):
        rid = ev.get("round")
        u = per_round_up.get(int(rid), {"n": 0, "bytes": 0}) \
            if rid is not None else {"n": 0, "bytes": 0}
        dur_ms = float(ev.get("dur_ms", 0.0))
        row = by_rid.get(rid)
        if row is None:
            order.append(rid)
            by_rid[rid] = {
                "round": rid,
                "n_participants": ev.get("n_participants"),
                "n_cohorts": ev.get("n_cohorts"),
                "n_uplinks": u["n"],
                "uplink_bytes": u["bytes"],
                "bytes_sent": ev.get("bytes_sent"),
                "bytes_delivered": ev.get("bytes_delivered"),
                "queue_depth": ev.get("queue_depth"),
                "bytes_in_flight": ev.get("bytes_in_flight"),
                "merged_version": ev.get("merged_version"),
                "dur_ms": dur_ms,
            }
            continue
        for f in ("n_participants", "n_cohorts", "bytes_sent",
                  "bytes_delivered"):
            if ev.get(f) is not None:
                row[f] = (row[f] or 0) + ev[f]
        for f in ("queue_depth", "bytes_in_flight"):
            if ev.get(f) is not None:
                row[f] = ev[f]
        if ev.get("merged_version") is not None:
            row["merged_version"] = ev["merged_version"]
        row["dur_ms"] += dur_ms
    round_rows = []
    for rid in order:
        row = by_rid[rid]
        dur_ms = row["dur_ms"]
        row["uplinks_per_sec"] = (row["n_uplinks"] / (dur_ms / 1e3)) \
            if dur_ms else None
        round_rows.append(row)
    for d in decode.values():
        d["mean_ms"] = d["total_ms"] / d["count"] if d["count"] else 0.0
    return {"n_events": len(events), "kinds": dict(kinds), "uplinks": up,
            "ingest": ingest, "rounds": round_rows,
            "decode": {str(k): v for k, v in sorted(
                decode.items(), key=lambda kv: str(kv[0]))},
            "merges": merges,
            "admission": {"n": admission["n"], "bytes": admission["bytes"],
                          "verdicts": dict(admission["verdicts"]),
                          "verdict_bytes": dict(admission["verdict_bytes"]),
                          "reasons": dict(admission["reasons"])},
            "migrations": migrations, "faults": dict(faults),
            "retries": retries, "recoveries": recoveries}


def check_bytes(summary: Dict[str, Any]) -> List[str]:
    """§2.8 invariant: per round, Σ uplink-event ``nbytes`` (measured
    from each CodePayload) == the round ledger's ``bytes_sent``.
    Returns human-readable mismatch strings (empty == pass)."""
    problems = []
    if summary["uplinks"]["n"] == 0:
        problems.append("trace holds no uplink events — nothing recorded")
    for row in summary["rounds"]:
        sent = row.get("bytes_sent")
        if sent is None:
            continue
        if int(sent) != int(row["uplink_bytes"]):
            problems.append(
                f"round {row['round']}: uplink events sum to "
                f"{row['uplink_bytes']} B but the round ledger sent "
                f"{sent} B")
    # continuous-ingest conservation: every byte that hit the wire is
    # either in the store, refused-and-witnessed, a deduplicated
    # retransmit, or still in flight
    adm = summary.get("admission", {"n": 0})
    rows = summary["rounds"]
    if adm["n"] and rows and all(r.get("bytes_in_flight") is not None
                                 for r in rows):
        rejected = adm["verdict_bytes"].get("rejected", 0)
        duplicate = adm["verdict_bytes"].get("duplicate", 0)
        in_flight = int(rows[-1]["bytes_in_flight"])
        lhs = int(summary["uplinks"]["bytes"])
        rhs = int(summary["ingest"]["bytes"]) + int(rejected) \
            + int(duplicate) + in_flight
        if lhs != rhs:
            problems.append(
                f"conservation: {lhs} B uplinked != {summary['ingest']['bytes']} B "
                f"ingested + {rejected} B rejected + {duplicate} B "
                f"duplicate + {in_flight} B in flight (= {rhs} B)")
    return problems


def bench_rows(summary: Dict[str, Any]) -> List[Dict[str, Any]]:
    """BENCH-style rows (real JSON numbers; ``extra`` is the only
    string field) mirroring the benchmarks/run.py artifact schema."""
    rows = [
        {"name": "n_events", "value": summary["n_events"],
         "extra": "+".join(f"{k}:{v}"
                           for k, v in sorted(summary["kinds"].items()))},
        {"name": "uplinks", "value": summary["uplinks"]["n"],
         "extra": f"dropped={summary['uplinks']['dropped']}"},
        {"name": "uplink_bytes", "value": summary["uplinks"]["bytes"],
         "extra": "measured_sum_of_CodePayload_nbytes"},
        {"name": "ingested", "value": summary["ingest"]["n"], "extra": ""},
        {"name": "ingested_bytes", "value": summary["ingest"]["bytes"],
         "extra": ""},
        {"name": "rounds", "value": len(summary["rounds"]), "extra": ""},
        {"name": "merges", "value": len(summary["merges"]),
         "extra": "+".join(f"v{m}" for m in summary["merges"])},
    ]
    timed = [r for r in summary["rounds"] if r["dur_ms"]]
    if timed:
        n = len(timed)
        rows.append({"name": "round_ms_mean",
                     "value": sum(r["dur_ms"] for r in timed) / n,
                     "extra": f"{n}rounds"})
        ups = [r["uplinks_per_sec"] for r in timed
               if r["uplinks_per_sec"] is not None]
        if ups:
            rows.append({"name": "uplinks_per_sec_mean",
                         "value": sum(ups) / len(ups),
                         "extra": f"peak={max(ups):.1f}"})
        rows.append({"name": "bytes_per_round_mean",
                     "value": sum(r["uplink_bytes"] for r in timed) / n,
                     "extra": ""})
    for v, d in summary["decode"].items():
        rows.append({"name": f"decode_v{v}_ms_mean", "value": d["mean_ms"],
                     "extra": f"{d['count']}dispatches_"
                              f"{d['n_samples']}samples"})
    adm = summary.get("admission", {"n": 0})
    if adm["n"]:
        for v in sorted(adm["verdicts"]):
            rows.append({"name": f"admission_{v}",
                         "value": adm["verdicts"][v], "extra": ""})
            rows.append({"name": f"admission_{v}_bytes",
                         "value": adm["verdict_bytes"].get(v, 0),
                         "extra": "stays on the §2.8 ledger"})
        for k in sorted(adm["reasons"]):
            rows.append({"name": f"admission_reason_{k}",
                         "value": adm["reasons"][k], "extra": ""})
    if summary.get("migrations"):
        rows.append({"name": "migrations",
                     "value": len(summary["migrations"]),
                     "extra": "+".join(
                         f"{m.get('phase')}:{m.get('src')}->{m.get('dst')}"
                         for m in summary["migrations"])})
    if summary.get("faults"):
        rows.append({"name": "faults_injected",
                     "value": sum(summary["faults"].values()),
                     "extra": "+".join(f"{k}:{v}" for k, v in
                                       sorted(summary["faults"].items()))})
        for k in sorted(summary["faults"]):
            rows.append({"name": f"fault_{k}",
                         "value": summary["faults"][k], "extra": ""})
    if summary.get("retries"):
        rows.append({"name": "retries", "value": summary["retries"],
                     "extra": "transient-refused envelopes retransmitted"})
    for r in summary.get("recoveries", []):
        rows.append({"name": "recovery_ms",
                     "value": float(r.get("dur_ms", 0.0)),
                     "extra": f"snap_tick={r.get('snapshot_tick')}_"
                              f"replayed={r.get('n_replayed')}"})
    return rows


def render(summary: Dict[str, Any]) -> str:
    """Plain-text view of one trace."""
    out = [f"events: {summary['n_events']}  "
           + "  ".join(f"{k}={v}" for k, v in sorted(
               summary["kinds"].items()))]
    u = summary["uplinks"]
    out.append(f"uplinks: {u['n']} payloads, {u['bytes']} B measured "
               f"({u['dropped']} dropped, {u['dropped_bytes']} B burned)")
    i = summary["ingest"]
    out.append(f"ingested: {i['n']} payloads, {i['bytes']} B into the store")
    if summary["rounds"]:
        out.append(f"{'round':>5} {'parts':>6} {'uplinks':>7} "
                   f"{'bytes':>10} {'queue':>5} {'ms':>8} {'up/s':>8}")
        for r in summary["rounds"]:
            ups = (f"{r['uplinks_per_sec']:8.1f}"
                   if r["uplinks_per_sec"] is not None else "       -")
            out.append(
                f"{r['round']!s:>5} {r['n_participants']!s:>6} "
                f"{r['n_uplinks']:>7} {r['uplink_bytes']:>10} "
                f"{r['queue_depth']!s:>5} {r['dur_ms']:8.1f} {ups}"
                + (f"  merged->v{r['merged_version']}"
                   if r.get("merged_version") is not None else ""))
    for v, d in summary["decode"].items():
        out.append(f"decode v{v}: {d['count']} dispatches, "
                   f"{d['mean_ms']:.2f} ms mean, {d['n_samples']} samples")
    if summary["merges"]:
        out.append("merges: " + ", ".join(f"v{m}" for m in
                                          summary["merges"]))
    adm = summary.get("admission", {"n": 0})
    if adm["n"]:
        out.append("admission: " + "  ".join(
            f"{v}={adm['verdicts'][v]} ({adm['verdict_bytes'].get(v, 0)} B)"
            for v in sorted(adm["verdicts"])))
        if adm["reasons"]:
            out.append("  reasons: " + "  ".join(
                f"{k}={n}" for k, n in sorted(adm["reasons"].items())))
    for m in summary.get("migrations", []):
        line = (f"migration {m.get('phase')}: v{m.get('src')} -> "
                f"v{m.get('dst')} ({m.get('policy')})")
        if m.get("phase") == "complete":
            line += (f", {m.get('src_records')} src records "
                     f"{m.get('src_bytes')} B left, "
                     f"{m.get('n_reencoded')} re-encoded")
        out.append(line)
    if summary.get("faults"):
        out.append("faults injected: " + "  ".join(
            f"{k}={v}" for k, v in sorted(summary["faults"].items())))
    if summary.get("retries"):
        out.append(f"retries: {summary['retries']} envelopes retransmitted")
    for r in summary.get("recoveries", []):
        out.append(f"recovery: snapshot t={r.get('snapshot_tick')}, "
                   f"{r.get('n_replayed')} journal entries replayed in "
                   f"{r.get('dur_ms', 0.0):.1f} ms -> tick {r.get('tick')}, "
                   f"{r.get('store_records')} records")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="summarize a FlightRecorder JSONL trace")
    ap.add_argument("trace", help="path to the .jsonl trace")
    ap.add_argument("--json", dest="json_out", default="",
                    help="also write a BENCH-style JSON section here")
    ap.add_argument("--check", action="store_true",
                    help="fail unless per-round trace Σ-bytes equal the "
                         "round ledgers' measured bytes_sent (§2.8)")
    args = ap.parse_args(argv)

    summary = summarize(load_events(args.trace))
    print(render(summary))
    problems = check_bytes(summary)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"section": "obs", "trace": args.trace,
                       "bytes_check_ok": not problems,
                       "rows": bench_rows(summary)}, fh, indent=1)
        print(f"wrote {args.json_out}")
    if args.check:
        if problems:
            for p in problems:
                print(f"BYTES CHECK FAILED: {p}", file=sys.stderr)
            return 1
        print(f"bytes check OK: trace Σ-bytes == round ledgers across "
              f"{len(summary['rounds'])} rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
