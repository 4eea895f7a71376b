"""The serve ``/metrics`` exposition (counterpart of the serving part of
``mx_rcnn_tpu/telemetry/obs.py``: ``PROM_CONTENT_TYPE``,
``ENGINE_COUNTER_NAMES``, ``prometheus_text``, ``engine_summary``,
``serve_prometheus``, ``pool_summary``, ``pool_prometheus``).

:func:`prometheus_text` renders per-rank :meth:`Telemetry.summary` dicts
as Prometheus text; :func:`engine_summary` builds that dict for a
``ServeEngine`` from the active sink's aggregates with the engine's own
counters, queue depth, latency histograms and SLO state folded over them
(the engine is authoritative for ``serve/*``, telemetry on or off), and a
stream manager's counters as ``stream/*``; :func:`pool_prometheus` renders
a model pool, one rank per model id and its paging, scheduling and cascade
state under ``rank="pool"``.  The live observability plane
(``ObsServer``, ``SnapshotWriter``, ``ObsPlane``) is not ported yet.
Stdlib only.
"""

from __future__ import annotations

import re
from typing import Optional

from mx_rcnn_tpu_torch import telemetry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# ServeEngine.counters key → telemetry counter name (the engine mirrors
# these into the sink when one is active; when none is, the frontend's
# Prometheus path rebuilds them from the engine so both configurations
# expose the same families)
ENGINE_COUNTER_NAMES = {
    "requests": "serve/requests",
    "served": "serve/images",
    "batches": "serve/batches",
    "rejected": "serve/rejected",
    "shed": "serve/shed",
    "deadline_exceeded": "serve/deadline_exceeded",
    "recompiles": "serve/recompile",
    "warmup_programs": "serve/warmup_programs",
}


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


_HELP_OVERRIDES = {
    "mxr_up": "1 for every rank folded into this exposition.",
    "mxr_snapshot_age_seconds":
        "Seconds since a peer rank's snapshot file was written.",
}


def _help(fam: str, kind: str) -> str:
    """One ``# HELP`` text per family — real scrapers warn on HELP-less
    families, so every ``mxr_*`` family carries one (generic but
    truthful: the name already says what is measured)."""
    if fam in _HELP_OVERRIDES:
        return _HELP_OVERRIDES[fam]
    if kind == "counter":
        if fam.endswith("_seconds_total"):
            return "Total seconds spent, summed over calls."
        if fam.endswith("_calls_total"):
            return "Total completed calls."
        return "Monotone event count since process start."
    if kind == "histogram":
        return "Distribution in seconds (log-spaced buckets)."
    if fam.endswith("_seconds_max"):
        return "Longest single call observed, in seconds."
    return "Gauge sampled per rank (stat=last/min/max/mean)."


def prometheus_text(per_rank: dict, ages: Optional[dict] = None) -> str:
    """Render ``{rank: summary_dict}`` (the :meth:`Telemetry.summary`
    shape) as Prometheus text exposition.  Families:

    * counter ``name`` → ``mxr_<name>_total{rank="N"}``
    * span ``name`` → ``mxr_<name>_seconds_total`` +
      ``mxr_<name>_calls_total`` (counters) and
      ``mxr_<name>_seconds_max`` (gauge)
    * gauge ``name`` → ``mxr_<name>{rank="N",stat="last|min|max|mean"}``
      — the queue-depth extremes, not just the final sample
    * hist ``name`` → a native ``mxr_<name>_seconds`` histogram family:
      cumulative ``_bucket{le="..."}`` lines ending ``le="+Inf"``, plus
      ``_sum`` and ``_count`` — the shape ``histogram_quantile()`` eats
    * ``mxr_up{rank="N"} 1`` for every rank present, plus
      ``mxr_snapshot_age_seconds`` for ranks folded from snapshot files
      (``ages``: rank → seconds since the snapshot was written).
    """
    counters: dict = {}  # family -> [(rank, value)]
    gauges: dict = {}    # family -> [(rank, labels, value)]
    hists: dict = {}     # family -> [(rank, hist_dict)]
    for rank in sorted(per_rank):
        s = per_rank[rank] or {}
        gauges.setdefault("mxr_up", []).append((rank, "", 1))
        for name, h in (s.get("hists") or {}).items():
            fam = f"mxr_{_prom_name(name)}_seconds"
            hists.setdefault(fam, []).append((rank, h))
        for name, total in (s.get("counters") or {}).items():
            fam = f"mxr_{_prom_name(name)}_total"
            counters.setdefault(fam, []).append((rank, total))
        for name, sp in (s.get("spans") or {}).items():
            base = f"mxr_{_prom_name(name)}"
            counters.setdefault(f"{base}_seconds_total", []).append(
                (rank, sp.get("total_s", 0.0)))
            counters.setdefault(f"{base}_calls_total", []).append(
                (rank, sp.get("count", 0)))
            gauges.setdefault(f"{base}_seconds_max", []).append(
                (rank, "", sp.get("max_s", 0.0)))
        for name, g in (s.get("gauges") or {}).items():
            fam = f"mxr_{_prom_name(name)}"
            for stat in ("last", "min", "max", "mean"):
                gauges.setdefault(fam, []).append(
                    (rank, f',stat="{stat}"', g.get(stat, 0.0)))
    for rank, age in sorted((ages or {}).items()):
        gauges.setdefault("mxr_snapshot_age_seconds", []).append(
            (rank, "", age))

    def fmt(v):
        return repr(round(float(v), 9)) if isinstance(v, float) else str(v)

    lines = []
    for fam in sorted(counters):
        lines.append(f"# HELP {fam} {_help(fam, 'counter')}")
        lines.append(f"# TYPE {fam} counter")
        for rank, v in counters[fam]:
            lines.append(f'{fam}{{rank="{rank}"}} {fmt(v)}')
    for fam in sorted(gauges):
        lines.append(f"# HELP {fam} {_help(fam, 'gauge')}")
        lines.append(f"# TYPE {fam} gauge")
        for rank, labels, v in gauges[fam]:
            lines.append(f'{fam}{{rank="{rank}"{labels}}} {fmt(v)}')
    for fam in sorted(hists):
        lines.append(f"# HELP {fam} {_help(fam, 'histogram')}")
        lines.append(f"# TYPE {fam} histogram")
        for rank, h in hists[fam]:
            cum = 0
            for le, c in zip(h.get("le", []), h.get("buckets", [])):
                cum += int(c)
                lines.append(
                    f'{fam}_bucket{{rank="{rank}",le="{fmt(float(le))}"}}'
                    f' {cum}')
            lines.append(f'{fam}_bucket{{rank="{rank}",le="+Inf"}}'
                         f' {int(h.get("count", 0))}')
            lines.append(f'{fam}_sum{{rank="{rank}"}}'
                         f' {fmt(float(h.get("sum", 0.0)))}')
            lines.append(f'{fam}_count{{rank="{rank}"}}'
                         f' {int(h.get("count", 0))}')
    return "\n".join(lines) + "\n"


def engine_summary(engine) -> dict:
    """A summary-shaped dict for a :class:`ServeEngine`: the active
    sink's aggregates (when one is on) with the engine's own counters and
    live queue depth folded over them — the engine is authoritative for
    ``serve/*`` (its counters exist even with telemetry off)."""
    tel = telemetry.get()
    base = tel.summary() if tel.enabled else {}
    m = engine.metrics()
    counters = dict(base.get("counters") or {})
    for key, name in ENGINE_COUNTER_NAMES.items():
        if key in m.get("counters", {}):
            counters[name] = m["counters"][key]
    gauges = dict(base.get("gauges") or {})
    # a stream manager's state (in the engine's metrics only when one is
    # attached): its counters as stream/*, table size, occupancy and skip
    # fraction as gauges
    st = m.get("stream") or {}
    for key, v in (st.get("counters") or {}).items():
        counters[f"stream/{key}"] = v
    for key in ("active_streams", "batch_occupancy", "skip_fraction"):
        v = st.get(key)
        if isinstance(v, (int, float)):
            gauges[f"stream/{key}"] = {
                "count": 1, "mean": v, "min": v, "max": v, "last": v}
    gen = m.get("generation", 0)
    gauges.setdefault("serve/generation", {
        "count": 1, "mean": gen, "min": gen, "max": gen, "last": gen})
    depth = m.get("queue_depth", 0)
    live = gauges.get("serve/queue_depth", {})
    gauges["serve/queue_depth"] = {
        "count": live.get("count", 0) + 1,
        "mean": live.get("mean", depth),
        "min": min(live.get("min", depth), depth),
        "max": max(live.get("max", depth), depth),
        "last": depth,
    }
    # the engine is authoritative for its latency distributions too — its
    # Hists observe every request even with telemetry off
    hists = dict(base.get("hists") or {})
    for name, h in getattr(engine, "latency_hists", lambda: {})().items():
        hists[name] = h.to_dict() if hasattr(h, "to_dict") else dict(h)
    # live SLO-controller state (per-bucket flush batch / max delay and
    # the admission limit) as point-in-time gauges
    for name, v in (m.get("controller") or {}).get("gauges", {}).items():
        gauges[name] = {"count": 1, "mean": v, "min": v, "max": v,
                        "last": v}
    for key, pol in (m.get("policy") or {}).items():
        for stat, v in (("max_batch", pol.get("max_batch")),
                        ("max_delay_ms", pol.get("max_delay_ms"))):
            if v is None:
                continue
            name = f"slo/bucket_{key}/{stat}"
            gauges[name] = {"count": 1, "mean": v, "min": v, "max": v,
                            "last": v}
    return {"spans": base.get("spans") or {}, "counters": counters,
            "gauges": gauges, "hists": hists}


def serve_prometheus(engine) -> str:
    """The frontend's ``/metrics?format=prom`` body: the engine's summary
    rendered by :func:`prometheus_text` under the active sink's rank."""
    return prometheus_text({telemetry.get().rank: engine_summary(engine)})


def pool_summary(pool) -> dict:
    """A summary-shaped dict of a ``ModelPool``'s own state: the paging
    and scheduling counters, residency gauges and, with a cascade
    attached, its decision counters, escalation rate and gate quantiles
    (``cascade/*``)."""
    res = pool.residency()
    counters = {"serve/weight_page_in": pool.counters["weight_page_in"],
                "serve/weight_page_out": pool.counters["weight_page_out"],
                "serve/sched_batches": pool.counters["sched_batches"],
                "serve/sched_switches": pool.counters["sched_switches"]}

    def point(v):
        return {"count": 1, "mean": v, "min": v, "max": v, "last": v}

    gauges = {"serve/weight_budget_bytes": point(res["budget_bytes"]),
              "serve/resident_bytes": point(res["device_bytes"]),
              "serve/resident_models": point(res["resident_models"])}
    for mid, doc in res["models"].items():
        gauges[f"serve/resident/{mid}"] = point(doc["resident"])
        gauges[f"serve/weight_bytes/{mid}"] = point(doc["bytes"])
        counters[f"serve/weight_page_in/{mid}"] = doc["page_ins"]
        counters[f"serve/weight_page_out/{mid}"] = doc["page_outs"]
    cas = pool.cascade.metrics() if pool.cascade is not None else None
    if cas:
        for key, v in (cas.get("counters") or {}).items():
            counters[f"cascade/{key}"] = v
        gauges["cascade/escalation_rate"] = point(cas["escalation_rate"])
        gauges["cascade/thresh"] = point(cas["thresh"])
        for key, v in (cas.get("latency") or {}).items():
            gauges[f"cascade/{key}"] = point(v)
    return {"spans": {}, "counters": counters, "gauges": gauges,
            "hists": {}}


def pool_prometheus(pool) -> str:
    """A pool's ``/metrics?format=prom``: each model's engine summary under
    ``rank="<model id>"`` and :func:`pool_summary` under
    ``rank="pool"``."""
    per_rank = {mid: engine_summary(pool.engine_for(mid))
                for mid in pool.model_ids()}
    per_rank["pool"] = pool_summary(pool)
    return prometheus_text(per_rank)
