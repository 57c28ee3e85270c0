"""Query-routing reports: why a grep was fast or slow, from the telemetry
already on disk (the reference's runtime/explain.py).

``assemble()`` folds one job's event log (``events.jsonl``) and the job
record's planning tallies into one JSON document: the engine modes with
their bytes, seconds and matches, the host or device route, the index's
prunes, fused attempts, the engine- and corpus-cache verdicts, the
result cache's reuse, the standing query's wakes, the stages' walls and
the task accounting.  The daemon serves it as ``GET /jobs/<id>/explain``;
``explain`` and ``submit --explain`` print it.

The port's host-only modes: ``re`` and ``native`` as in the reference,
and ``all_lines``, the port's mode for a pattern every line matches (no
launch, ops/engine.py).  So such a job's route is ``"host"``.  The port
never scans a query on the host in place of its kernel (ROADMAP.md D2,
D6): no ``scan:*`` record carries ``device_fallback``, so its route is
never ``"degraded"``.  On the same events, the rest of the document is
the reference's.

No scan-stack import: the daemon's control plane assembles reports.
"""

from __future__ import annotations

from typing import Any

# Engine modes that run on the host by construction; every other mode is
# a kernel family (shift_and, nfa, fdr, pairset, approx, ...).
_HOST_MODES = ("re", "native", "all_lines")

# The instants folded into the routing verdicts.
_CACHE_INSTANTS = {
    "cache:hit": ("model_cache", "hits"),
    "cache:miss": ("model_cache", "misses"),
    "cache:off": ("model_cache", "bypassed"),
    "corpus:hit": ("corpus_cache", "hits"),
    "corpus:miss": ("corpus_cache", "misses"),
}


def _query_view(app_options: dict) -> dict:
    """The query half of the app options: what was asked, not how."""
    out: dict = {}
    if app_options.get("pattern") is not None:
        out["pattern"] = app_options["pattern"]
    pats = app_options.get("patterns")
    if pats:
        out["patterns"] = len(pats)
    for k in ("ignore_case", "invert", "word_regexp", "line_regexp",
              "max_errors", "count_only", "presence_only", "backend"):
        v = app_options.get(k)
        if v:
            out[k] = v
    return out


def summarize_events(events: list[dict]) -> dict:
    """One job's span and instant records aggregated into the routing and
    stage views.  A record of an unknown shape is skipped."""
    modes: dict[str, dict] = {}
    stages: dict[str, dict] = {}
    routing: dict[str, dict] = {}
    fusion = {"fused_plans": 0, "fused_attempts": 0, "max_queries": 0}
    index = {"prunes": 0, "bytes_skipped": 0, "maybes": 0}
    result = {"hits": 0, "partial_hits": 0, "misses": 0,
              "splits_reused": 0, "bytes_unscanned": 0, "revalidations": 0}
    shuffle = {"peer_fetches": 0, "peer_bytes": 0, "relay_fetches": 0,
               "relay_fallbacks": 0, "lost_outputs": 0}
    tasks = {"map_assigns": 0, "reduce_assigns": 0, "timeouts": 0,
             "map_commits": 0, "reduce_commits": 0}
    follow = {"solo_wakes": 0, "fused_wakes": 0, "records": 0}
    device_fallbacks = 0
    degrades = 0
    for r in events:
        name = r.get("name", "")
        t = r.get("t")
        args = r.get("args") or {}
        if t == "span":
            if name.startswith("scan:"):
                row = modes.setdefault(
                    name[len("scan:"):],
                    {"scans": 0, "bytes": 0, "seconds": 0.0, "matches": 0})
                row["scans"] += 1
                row["bytes"] += int(args.get("bytes", 0))
                row["seconds"] += float(r.get("dur", 0.0))
                row["matches"] += int(args.get("matches", 0))
                if args.get("device_fallback"):
                    device_fallbacks += 1
            else:
                row = stages.setdefault(name, {"count": 0, "seconds": 0.0})
                row["count"] += 1
                row["seconds"] += float(r.get("dur", 0.0))
        elif t == "instant":
            hit = _CACHE_INSTANTS.get(name)
            if hit is not None:
                group, key = hit
                routing.setdefault(group, {})[key] = (
                    routing.get(group, {}).get(key, 0) + 1)
            elif name == "index:prune":
                index["prunes"] += 1
                index["bytes_skipped"] += int(args.get("bytes", 0))
            elif name == "index:maybe":
                index["maybes"] += 1
            elif name in ("result:hit", "result:partial"):
                key = "hits" if name == "result:hit" else "partial_hits"
                result[key] += 1
                result["splits_reused"] += int(args.get("splits_reused", 0))
                result["bytes_unscanned"] += int(
                    args.get("bytes_unscanned", 0))
            elif name == "result:miss":
                result["misses"] += 1
            elif name == "result:revalidate":
                result["revalidations"] += 1
            elif name == "fuse:plan":
                fusion["fused_plans"] += 1
                fusion["max_queries"] = max(fusion["max_queries"],
                                            int(args.get("queries", 0)))
            elif name == "fuse:split":
                fusion["fused_attempts"] += 1
            elif name in ("follow:wake", "fuse:wake"):
                # which wake loop served the standing query: its own solo
                # runner, or a fused group's shared scan
                key = "solo_wakes" if name == "follow:wake" else "fused_wakes"
                follow[key] += 1
                follow["records"] += int(args.get("records", 0))
            elif name == "shuffle:peer":
                shuffle["peer_fetches"] += 1
                shuffle["peer_bytes"] += int(args.get("bytes", 0))
            elif name == "shuffle:relay":
                if args.get("fallback"):
                    shuffle["relay_fallbacks"] += 1
                else:
                    shuffle["relay_fetches"] += 1
            elif name == "map_lost_output":
                shuffle["lost_outputs"] += 1
            # never emitted by this package (no host fallback to demote
            # to); counted as the reference's assemble counts them
            elif name in ("device_demoted", "device_recovered"):  # analyze-ok: event-registry  # D6
                degrades += 1
            elif name == "assign_map":
                tasks["map_assigns"] += 1
            elif name == "assign_reduce":
                tasks["reduce_assigns"] += 1
            elif name == "task_timeout":
                tasks["timeouts"] += 1
            elif name == "map_committed":
                tasks["map_commits"] += 1
            elif name == "reduce_committed":
                tasks["reduce_commits"] += 1
    for row in modes.values():
        row["seconds"] = round(row["seconds"], 6)
    for row in stages.values():
        row["seconds"] = round(row["seconds"], 6)
    out: dict = {"modes": modes, "stages": stages, "tasks": tasks}
    out.update(routing)  # model_cache / corpus_cache, when seen
    if any(fusion.values()):
        out["fusion"] = fusion
    if any(index.values()):
        out["index"] = index
    if any(result.values()):
        out["result_cache"] = result
    if follow["solo_wakes"] or follow["fused_wakes"]:
        # fused: every wake came from a group's shared scan; mixed: a
        # catch-up or a demotion to solo happened mid-run
        follow["route"] = (
            "fused" if follow["fused_wakes"] and not follow["solo_wakes"]
            else "solo" if follow["solo_wakes"] and not follow["fused_wakes"]
            else "mixed")
        out["follow"] = follow
    if any(shuffle.values()):
        peer_n = shuffle["peer_fetches"]
        relay_n = shuffle["relay_fetches"] + shuffle["relay_fallbacks"]
        shuffle["route"] = (
            "peer" if peer_n and not relay_n
            else "relay" if relay_n and not peer_n
            else "mixed")
        out["shuffle"] = shuffle
    if device_fallbacks:
        out["device_fallbacks"] = device_fallbacks
    if degrades:
        out["device_transitions"] = degrades
    return out


def disruptions_view(daemon_events: list[dict], job_id: str,
                     submitted_at: float | None = None,
                     finished_at: float | None = None) -> dict:
    """The daemon-scope disruptions that overlapped one job's lifetime,
    from the fleet timeline (runtime/daemon_log.py): quarantine episodes,
    this job's lost-output re-runs, daemon restarts and failovers while
    the job was live.  Only the nonzero ones."""
    if not daemon_events:
        return {}
    lo = submitted_at or 0.0
    hi = finished_at if finished_at else float("inf")
    out = {"quarantines": 0, "lost_outputs": 0, "daemon_restarts": 0,
           "failovers": 0}
    max_failover = 0.0
    for r in daemon_events:
        kind = r.get("kind")
        payload = r.get("payload") or {}
        ts = float(r.get("ts", 0.0))
        if kind == "map_lost_output":
            if payload.get("job") == job_id:
                out["lost_outputs"] += 1
        elif kind == "quarantine":
            if lo <= ts <= hi:
                out["quarantines"] += 1
        elif kind in ("start", "resume"):
            # strictly after the submit: the boot that admitted the job is
            # not a disruption, a restart mid-job is
            if lo < ts <= hi:
                out["daemon_restarts"] += 1
        elif kind == "promoted":
            if lo < ts <= hi:
                out["failovers"] += 1
                max_failover = max(max_failover,
                                   float(payload.get("failover_s", 0.0)))
    view = {k: v for k, v in out.items() if v}
    if max_failover:
        view["max_failover_s"] = round(max_failover, 6)
    return view


def _route_verdict(modes: dict[str, dict], device_fallbacks: int) -> str:
    """host / device / mixed / degraded / unknown.  ``scan:batch`` rows are
    left out: a packed window records one batch span and the inner
    engine's own ``scan:<mode>`` span, so the batch row is an envelope,
    not a route."""
    scored = {name: m for name, m in modes.items()
              if not name.startswith("batch")}
    if not scored:
        return "unknown"
    host = sum(m["scans"] for name, m in scored.items()
               if name in _HOST_MODES)
    device = sum(m["scans"] for name, m in scored.items()
                 if name not in _HOST_MODES)
    if device_fallbacks:
        return "degraded"
    if host and device:
        return "mixed"
    return "device" if device else "host"


def assemble(
    job_id: str,
    config: Any,
    state: str,
    submitted_at: float | None,
    started_at: float | None,
    finished_at: float | None,
    metrics_counters: dict,
    events: list[dict],
    index_shards_pruned: int = 0,
    index_bytes_skipped: int = 0,
    result_splits_reused: int = 0,
    result_bytes_unscanned: int = 0,
    result_revalidations: int = 0,
    daemon_events: list[dict] | None = None,
) -> dict:
    """One job's routing report.  ``config`` is the JobConfig (its
    application and app options are read); ``metrics_counters`` the job's
    counters; the planner's index and result-cache tallies come from the
    job's record (they happen at submit, before any worker span);
    ``daemon_events`` (the fleet timeline, when the daemon log is on)
    feeds the ``disruptions`` section."""
    agg = summarize_events(events)
    modes = agg.pop("modes")
    stages = agg.pop("stages")
    tasks = agg.pop("tasks")
    timing: dict = {}
    if submitted_at and started_at:
        timing["queue_wait_s"] = round(started_at - submitted_at, 6)
    if started_at and finished_at:
        timing["run_s"] = round(finished_at - started_at, 6)
    if submitted_at and finished_at:
        timing["e2e_s"] = round(finished_at - submitted_at, 6)

    routing: dict = {
        "route": _route_verdict(modes, agg.get("device_fallbacks", 0)),
        "engine_modes": modes,
        **agg,
    }
    if index_shards_pruned:
        idx = routing.setdefault("index", {})
        idx["planner_shards_pruned"] = index_shards_pruned
        idx["planner_bytes_skipped"] = index_bytes_skipped
    if result_splits_reused or result_revalidations:
        res = routing.setdefault("result_cache", {})
        if result_splits_reused:
            res["planner_splits_reused"] = result_splits_reused
            res["planner_bytes_unscanned"] = result_bytes_unscanned
        if result_revalidations:
            res["planner_revalidations"] = result_revalidations

    counters = {k: v for k, v in sorted((metrics_counters or {}).items())
                if v}
    disruptions = disruptions_view(daemon_events or [], job_id,
                                   submitted_at=submitted_at,
                                   finished_at=finished_at)
    return {
        "job_id": job_id,
        "state": state,
        "application": getattr(config, "application", ""),
        "query": _query_view(getattr(config, "app_options", {}) or {}),
        "timing": timing,
        "routing": routing,
        "stages": stages,
        "tasks": tasks,
        "metrics": counters,
        **({"disruptions": disruptions} if disruptions else {}),
        # spans off: a skeleton report, and it says so
        "spans": bool(events),
    }
