"""Merge per-process Chrome-trace exports into one Perfetto document (the
port's own copy of ``deeplearning4j_tpu/obs/collect.py``).

Each fleet process (router, every replica) owns a private
:class:`~deeplearning4j_tpu_torch.obs.trace.Tracer` and exports a
single-process Chrome-trace JSON with ``pid: 1`` and timestamps
relative to its own ``perf_counter`` origin. Those origins are not
comparable across processes, so the raw files cannot simply be
concatenated. The exporter therefore records ``origin_wall_time_s`` —
the ``time.time()`` reading taken at the same instant as the
``perf_counter`` origin — and this module rebases every process onto
the earliest such anchor:

- one distinct ``pid`` per input file, with ``process_name`` /
  ``process_sort_index`` metadata so Perfetto shows one process track
  group per router/replica,
- all event timestamps shifted by the process's wall-clock offset
  from the earliest anchor (so the merged view is one timeline),
- Chrome flow events (``ph: "s"`` / ``ph: "f"``) synthesized from the
  ``trace_id``/``span_id``/``parent_span_id`` span args wherever a
  span's parent lives in a *different* process — the arrows from a
  router dispatch span to the replica admission span it caused.

Wall-clock skew between processes on one host is sub-millisecond;
across hosts the arrows remain correct (they bind to span identities,
not timestamps) even if tracks visually shear.
"""

from __future__ import annotations

import json
from pathlib import Path


def _span_key(ev: dict) -> str | None:
    args = ev.get("args")
    if ev.get("ph") == "X" and isinstance(args, dict):
        sid = args.get("span_id")
        if sid:
            return str(sid)
    return None


def merge_traces(docs: list[dict]) -> dict:
    """Merge Chrome-trace dicts (as produced by ``Tracer.chrome_trace``
    or loaded from its exports) into a single trace document.

    Files missing ``origin_wall_time_s`` (pre-fleet exports) are
    treated as anchored at the earliest known anchor — their spans
    stay internally consistent but are not aligned to other processes.
    """
    if not docs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    anchors = [
        float(d["origin_wall_time_s"]) for d in docs
        if d.get("origin_wall_time_s") is not None
    ]
    base = min(anchors) if anchors else 0.0

    out: list[dict] = []
    # span_id -> (pid, tid, ts) of the exporting span, for flow arrows
    span_at: dict[str, tuple[int, int, float]] = {}
    children: list[tuple[str, dict]] = []  # (parent_span_id, merged ev)

    for i, doc in enumerate(docs):
        pid = i + 1
        name = str(doc.get("process_name") or f"process-{pid}")
        anchor = doc.get("origin_wall_time_s")
        shift_us = (
            (float(anchor) - base) * 1e6 if anchor is not None else 0.0
        )
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": name}})
        out.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"sort_index": i}})
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") in (
                "process_name", "process_sort_index",
            ):
                continue  # replaced by the per-file metadata above
            mev = dict(ev)
            mev["pid"] = pid
            if "ts" in mev:
                mev["ts"] = round(float(mev["ts"]) + shift_us, 3)
            out.append(mev)
            sid = _span_key(mev)
            if sid is not None:
                span_at[sid] = (pid, int(mev.get("tid", 0)),
                                float(mev["ts"]))
                parent = mev["args"].get("parent_span_id")
                if parent:
                    children.append((str(parent), mev))

    flow_id = 0
    for parent_sid, child in children:
        src = span_at.get(parent_sid)
        if src is None or src[0] == child["pid"]:
            continue  # unresolved, or an in-process link (nesting shows it)
        flow_id += 1
        spid, stid, sts = src
        out.append({"name": "trace", "cat": "flow", "ph": "s",
                    "id": flow_id, "pid": spid, "tid": stid, "ts": sts})
        out.append({"name": "trace", "cat": "flow", "ph": "f", "bp": "e",
                    "id": flow_id, "pid": child["pid"],
                    "tid": int(child.get("tid", 0)),
                    "ts": float(child["ts"])})

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "origin_wall_time_s": base,
    }


def merge_trace_files(paths: list[str | Path],
                      out_path: str | Path | None = None) -> dict:
    """Load per-process Chrome-trace JSON files, merge, optionally
    write the merged document. Returns the merged dict."""
    docs = []
    for p in paths:
        with open(p, encoding="utf-8") as f:
            docs.append(json.load(f))
    merged = merge_traces(docs)
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(merged, f)
    return merged
