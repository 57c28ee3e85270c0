"""Registry of every exported telemetry event name (the data of the
reference's analysis/events.py): span, instant and daemon-event
vocabulary, declared once.

utils/event_audit.py checks emitted names against it at run time, and
the ``event-registry`` rule (analysis/rules.py) holds every emit site and
name-matching consumer to it at check time: a declared name no emitter
produces is stale.  A family key holds one ``*`` and enumerates the
``members`` that may replace it (``scan:*`` covers ``scan:shift_and``,
``scan:fdr``, ...).  The table is the reference's, less
``device_demoted``/``device_recovered``: the port has no host fallback
to demote to (ROADMAP D6).  ``owners`` name the reference's modules
(``apps/grep_tpu.py`` is this package's ``apps/grep_cuda.py``).  One
member is this package's own: ``scan:all_lines``, the engine mode of a
pattern every line matches.

The registry doubles as generated operator docs: ``python -m
distributed_grep_tpu_torch analyze --events`` renders it as a markdown
table (``event_docs``).
"""

from __future__ import annotations

from dataclasses import dataclass


# Event kinds: "span" (timed, has dur), "instant" (point event), "daemon"
# (DaemonLog lifecycle record — keyed "kind" in daemon.jsonl, no cat).
@dataclass(frozen=True)
class Event:
    kinds: tuple  # subset of ("span", "instant", "daemon")
    cat: str  # expected cat at emit sites; "" = computed / not checked
    owners: tuple  # emitting module(s), package-relative
    consumers: tuple  # known name-matching consumer module(s)
    doc: str  # one line: what the event records
    members: tuple = ()  # for family keys (one "*"): allowed substitutions


EVENTS: dict[str, Event] = {
    # ---------------------------------------------------------- engine spans
    "scan:*": Event(
        ("span",), "engine", ("utils/spans.py", "ops/engine.py"),
        ("runtime/explain.py",),
        "Per-scan engine span promoted from engine.stats; the member is the "
        "kernel family that ran (scan:batch = one packed cross-file flush).",
        members=("re", "native", "dfa", "nfa", "shift_and", "fdr",
                 "pairset", "approx", "batch", "all_lines"),
    ),
    # ---------------------------------------------------------- worker spans
    "map:task": Event(
        ("span",), "map", ("runtime/worker.py",), (),
        "Whole map-task attempt wall on the worker.",
    ),
    "map:read": Event(
        ("span",), "map", ("runtime/worker.py",), (),
        "Map input read (file / members / data-plane fetch).",
    ),
    "map:compute": Event(
        ("span",), "map", ("runtime/worker.py",), (),
        "Map app compute (the engine scan for grep apps).",
    ),
    "map:emit": Event(
        ("span",), "map", ("apps/grep_tpu.py",), (),
        "Grep-app record build (confirm/-v/batch construction) — separates "
        "scan time from record-build time in trace export.",
    ),
    "map:shuffle": Event(
        ("span",), "map", ("runtime/worker.py",), (),
        "Bucketize + mr-out partition writes for one map attempt.",
    ),
    "reduce:task": Event(
        ("span",), "reduce", ("runtime/worker.py",), (),
        "Whole reduce-task attempt wall on the worker.",
    ),
    "reduce:shuffle": Event(
        ("span",), "reduce", ("runtime/worker.py",), (),
        "Shuffle-file fetch wall for one reduce attempt.",
    ),
    "reduce:compute": Event(
        ("span",), "reduce", ("runtime/worker.py",), (),
        "Reduce app compute + output spool for one attempt.",
    ),
    "*:commit": Event(
        ("span",), "", ("runtime/worker.py",), (),
        "Task commit (store rename + commit record); cat equals the task "
        "kind, so the family star is the kind.",
        members=("map", "reduce"),
    ),
    # -------------------------------------------------------- cache instants
    "cache:*": Event(
        ("instant",), "engine", ("apps/grep_tpu.py",),
        ("runtime/explain.py",),
        "Cross-job compiled-model cache verdict at grep_tpu.configure "
        "(off = engine construction bypassed the cache).",
        members=("hit", "miss", "off"),
    ),
    "corpus:*": Event(
        ("instant",), "engine", ("ops/device_scan.py",),
        ("runtime/explain.py",),
        "Device-resident corpus cache verdict per scanned input.",
        members=("hit", "miss"),
    ),
    "index:prune": Event(
        ("instant",), "engine", ("ops/engine.py",), ("runtime/explain.py",),
        "Shard-index bloom answered cannot-match: scan skipped.",
    ),
    "index:maybe": Event(
        ("instant",), "engine", ("ops/engine.py",), ("runtime/explain.py",),
        "Shard-index bloom could not rule the input out: scan proceeds.",
    ),
    "result:hit": Event(
        ("instant",), "service", ("runtime/service.py",),
        ("runtime/explain.py",),
        "Query-result cache answered the whole job (no scheduler, no scan).",
    ),
    "result:partial": Event(
        ("instant",), "service", ("runtime/service.py",),
        ("runtime/explain.py",),
        "Query-result cache answered some map splits; the rest scan.",
    ),
    "result:miss": Event(
        ("instant",), "service", ("runtime/service.py",),
        ("runtime/explain.py",),
        "Query-result cache had no reusable split for the job.",
    ),
    "result:revalidate": Event(
        ("instant",), "service", ("runtime/service.py",),
        ("runtime/explain.py",),
        "Stored result declined at publish: split re-stat drifted during "
        "the scan (e.g. live append).",
    ),
    # ------------------------------------------------------ shuffle instants
    "shuffle:peer": Event(
        ("instant",), "reduce", ("runtime/worker.py",),
        ("runtime/explain.py",),
        "Reducer fetched a shuffle file from the producer's peer plane.",
    ),
    "shuffle:relay": Event(
        ("instant",), "reduce", ("runtime/worker.py",),
        ("runtime/explain.py",),
        "Reducer fetched a shuffle file through the coordinator relay "
        "(emitted per fetch in peer deployments: pre-peer or fallback leg).",
    ),
    # ------------------------------------------------------- fusion instants
    "fuse:plan": Event(
        ("instant",), "fuse", ("runtime/service.py",),
        ("runtime/explain.py",),
        "Service planned a fused map assignment; written into each "
        "participant's events.jsonl.",
    ),
    "fuse:split": Event(
        ("instant",), "fuse", ("runtime/worker.py",),
        ("runtime/explain.py",),
        "Worker ran one fused split scan for K participant queries.",
    ),
    "fuse:wake": Event(
        ("instant",), "follow", ("runtime/follow.py",),
        ("runtime/explain.py",),
        "Fused follow-group wake served this member's standing query.",
    ),
    "follow:wake": Event(
        ("instant",), "follow", ("runtime/follow.py",),
        ("runtime/explain.py",),
        "Solo follow wake (including a joiner's catch-up poll).",
    ),
    # ---------------------------------------------------- scheduler instants
    "assign_map": Event(
        ("instant",), "sched", ("runtime/scheduler.py",),
        ("runtime/explain.py",),
        "Map task assigned to a worker (attempt number in args).",
    ),
    "assign_reduce": Event(
        ("instant",), "sched", ("runtime/scheduler.py",),
        ("runtime/explain.py",),
        "Reduce task assigned to a worker.",
    ),
    "map_committed": Event(
        ("instant",), "sched", ("runtime/scheduler.py",),
        ("runtime/explain.py",),
        "Map task commit accepted (attempt resolution done).",
    ),
    "reduce_committed": Event(
        ("instant",), "sched", ("runtime/scheduler.py",),
        ("runtime/explain.py",),
        "Reduce task commit accepted.",
    ),
    "grace_declared": Event(
        ("instant",), "sched", ("runtime/scheduler.py",), (),
        "Compile-grace window declared for a fresh device-compile shape.",
    ),
    "task_timeout": Event(
        ("instant",), "sched", ("runtime/scheduler.py",),
        ("runtime/explain.py",),
        "Task attempt timed out and was re-enqueued.",
    ),
    "map_lost_output": Event(
        ("instant", "daemon"), "sched",
        ("runtime/scheduler.py",),
        ("runtime/explain.py",),
        "Peer-held map output reported lost: producing task re-enqueued "
        "(also a job-tagged daemon lifecycle record).",
    ),
    "quarantine": Event(
        ("instant", "daemon"), "sched",
        ("runtime/scheduler.py",),
        ("runtime/explain.py",),
        "Worker parked after consecutive attributed failures (also a "
        "daemon lifecycle record via WorkerHealth.on_event).",
    ),
    # ------------------------------------------------------ service instants
    "resume": Event(
        ("instant", "daemon"), "service", ("runtime/service.py",),
        ("runtime/explain.py",),
        "Job resumed across a daemon restart (journal replayed); also the "
        "daemon-scope restart record.",
    ),
    "spans_dropped": Event(
        ("instant",), "pipeline", ("utils/spans.py",), (),
        "SpanBuffer shed oldest records under its cap (count in args).",
    ),
    # ------------------------------------------------- daemon lifecycle kinds
    "start": Event(
        ("daemon",), "", ("runtime/service.py",), ("runtime/explain.py",),
        "Daemon incarnation started serving.",
    ),
    "stop": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "Graceful daemon stop.",
    ),
    "job_terminal": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "A job reached a terminal state (state in payload).",
    ),
    "lease_lost": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "Write fence tripped: this daemon's lease token no longer matches.",
    ),
    "admission_reject": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "Submit rejected (queue full, deposed, or validation).",
    ),
    "worker_attach": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "New worker id allocated and registered.",
    ),
    "worker_expire": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "Worker row expired after an hour of silence.",
    ),
    "stream_shed": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "A follow job's StreamRing shed records under its cap.",
    ),
    "scale_advice": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "Elastic-pool advice changed (grow/shrink/hold, change-gated).",
    ),
    "scale_action": Event(
        ("daemon",), "", ("runtime/service.py",), (),
        "Scaler thread acted on advice (workers count in payload).",
    ),
    "quarantine_expire": Event(
        ("daemon",), "", ("runtime/scheduler.py",), (),
        "A quarantine window expired: worker re-probationed.",
    ),
    "quarantine_clear": Event(
        ("daemon",), "", ("runtime/scheduler.py",), (),
        "A committed task cleared a worker's failure streak.",
    ),
    "standby_park": Event(
        ("daemon",), "", ("__main__.py",), (),
        "Standby parked behind a live lease for parked_s seconds.",
    ),
    "lease_acquire": Event(
        ("daemon",), "", ("__main__.py",), ("utils/spans.py",),
        "Work-root lease acquired fresh (epoch 1 or uncontended).",
    ),
    "lease_steal": Event(
        ("daemon",), "", ("__main__.py",), ("utils/spans.py",),
        "Stale lease stolen (prev_epoch in payload — the durable failover "
        "record).",
    ),
    "promoted": Event(
        ("daemon",), "", ("__main__.py",),
        ("utils/spans.py", "runtime/explain.py"),
        "Standby finished resume and is serving (failover_s in payload).",
    ),
}


def is_family(key: str) -> bool:
    return "*" in key


def family_concrete(key: str, ev: Event) -> tuple:
    """All concrete names a family key's declared members expand to."""
    return tuple(key.replace("*", m) for m in ev.members)


def lookup(name: str):
    """Declaration for a concrete emitted/consumed name (exact wins),
    or for a family pattern like ``scan:*`` synthesized from an f-string.
    Returns (registry key, Event) or None."""
    ev = EVENTS.get(name)
    if ev is not None:
        return name, ev
    for key, fam in EVENTS.items():
        if is_family(key) and name in family_concrete(key, fam):
            return key, fam
    return None


def event_docs() -> str:
    """Markdown table of the whole vocabulary (``analyze --events``)."""
    lines = [
        "# Telemetry event vocabulary",
        "",
        "| name | kind | cat | owner | consumers | doc |",
        "|------|------|-----|-------|-----------|-----|",
    ]
    for key in sorted(EVENTS):
        ev = EVENTS[key]
        name = key
        if is_family(key):
            name = f"{key} ({'|'.join(ev.members)})"
        lines.append(
            "| `{}` | {} | {} | {} | {} | {} |".format(
                name, "/".join(ev.kinds), ev.cat or "-",
                ", ".join(ev.owners), ", ".join(ev.consumers) or "-",
                ev.doc,
            )
        )
    lines.append("")
    return "\n".join(lines)
