"""Registry of every ``DGREP_*`` environment knob the package reads:
name -> (owner module, default, one-line doc).

This is the single source of truth the ``env-knobs`` rule enforces: each
knob may be READ (``os.environ.get`` / ``os.getenv`` / ``os.environ[...]``,
or a helper whose parameter is the key, ``ops/layout._env_int``) in
exactly one module — its owner — so two call sites can never parse the
same override differently (the failure mode ``ops/layout.env_batch_bytes``
guards against: a planner that accepts a malformed value its worker
engines then crash on).  Other modules that need a knob's value import
the owner's accessor.

``NOT_PORTED`` lists the reference's knobs (distributed_grep_tpu's
analysis/knobs.py) that this package does not read, each with its reason
and the ROADMAP entry that records the difference; ``env-knobs`` flags a
read of one.  One knob has another owner than the reference's:
``DGREP_SWAR`` is read by ``ops/swar_scan.py`` (the reference's
``ops/pallas_scan.py``).

The registry doubles as generated operator docs: ``python -m
distributed_grep_tpu_torch analyze --knobs`` renders it as a markdown
table, and the not-ported knobs under their own heading.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    owner: str  # package-relative module path, e.g. "ops/engine.py"
    default: str  # human-readable default
    doc: str  # one line: what the knob controls


KNOBS: dict[str, Knob] = {
    "DGREP_DEVICE_MIN_BYTES": Knob(
        "ops/layout.py", "1048576",
        "Inputs below this host-scan when the default backend is a real "
        "accelerator; also the map-split planner's 'small file' bound "
        "(one parse, ops/layout.env_device_min_bytes).",
    ),
    "DGREP_BATCH_BYTES": Knob(
        "ops/layout.py", "33554432",
        "Cross-file packing window for sub-threshold inputs (0 "
        "disables); one parse (ops/layout.env_batch_bytes) shared by "
        "the planner and the engine packing cap.",
    ),
    "DGREP_CONFIRM_THREADS": Knob(
        "models/fdr.py", "min(8, cpu_count)",
        "Declared confirm-thread fan of the deployment; prices the FDR "
        "filter/confirm trade.",
    ),
    "DGREP_SWAR": Knob(
        "ops/swar_scan.py", "unset",
        "1 routes eligible short equality-class patterns through the "
        "SWAR packed shift-and kernel, csrc/shift_and_swar.cu (default "
        "off until ROADMAP queue B item 1's A/B says otherwise).",
    ),
    "DGREP_SPOOL_DIR": Knob(
        "runtime/http_transport.py", "system temp dir",
        "Directory HTTP workers spool oversized task payloads to.",
    ),
    "DGREP_SPANS": Knob(
        "utils/spans.py", "unset",
        "Force the span/event observability pipeline on (operator "
        "override of JobConfig.spans).",
    ),
    "DGREP_TRACE_DIR": Knob(
        "utils/trace.py", "unset",
        "Directory for the torch.profiler trace of each job, coordinator "
        "and worker process (trace-<pid>-<n>.json); also enables "
        "annotate() regions.",
    ),
    "DGREP_LOG": Knob(
        "utils/logging.py", "unset (no log)",
        "Log level for the structured control-plane logger; the run, "
        "coordinator, worker and serve subcommands log on stderr only "
        "when it names a level (the grep CLI never logs).",
    ),
    "DGREP_SERVICE_MAX_JOBS": Knob(
        "runtime/service.py", "4",
        "Concurrent running-job cap of the grep-as-a-service daemon "
        "(accessor: runtime/service.env_service_max_jobs).",
    ),
    "DGREP_SERVICE_QUEUE": Knob(
        "runtime/service.py", "64",
        "Queued-submission cap (admission control) of the service "
        "daemon; submits beyond it answer 429 (accessor: "
        "env_service_queue).",
    ),
    "DGREP_SERVICE_RESUME": Knob(
        "runtime/service.py", "1",
        "Crash-recovery resume of the service daemon: a restart replays "
        "the work root's jobs.jsonl registry (re-admit queued, resume "
        "running jobs from their journals); 0/false disables (accessor: "
        "env_service_resume).",
    ),
    "DGREP_WORKER_QUARANTINE_S": Knob(
        "runtime/scheduler.py", "30",
        "Base quarantine window for flaky workers: after 3 consecutive "
        "attributed task timeouts a worker receives no assignments for "
        "base * 2^(episode-1) seconds (capped at 8x; accessor: "
        "runtime/scheduler.env_worker_quarantine_s).",
    ),
    "DGREP_RPC_RETRIES": Knob(
        "runtime/http_transport.py", "6",
        "Transient-error retries per client HTTP call (worker RPCs, "
        "data plane, CLI client_call); 0 disables (accessor: "
        "env_rpc_retries).",
    ),
    "DGREP_RPC_BACKOFF_S": Knob(
        "runtime/http_transport.py", "0.5",
        "Base backoff between transient-error retries: exponential, "
        "capped at 5 s per sleep, +/-50% jitter so a daemon restart's "
        "synchronized failures do not retry in lockstep (accessor: "
        "env_rpc_backoff_s).",
    ),
    "DGREP_CORPUS_BYTES": Knob(
        "ops/layout.py", "backend-sized (0 on CPU, 1 GiB on accelerators)",
        "Device-resident corpus cache byte budget "
        "(ops/layout.CorpusCache; 0 disables): packed/padded card "
        "segments stay resident per content key so a repeat query over "
        "unchanged inputs skips the read/pack/upload path (accessor: "
        "ops/layout.env_corpus_bytes).",
    ),
    "DGREP_MODEL_CACHE": Knob(
        "ops/engine.py", "32",
        "Entry cap of the cross-job compiled-model cache (0 disables; "
        "accessor: ops/engine.env_model_cache_entries) — a cache hit "
        "returns the same engine, skipping model compile and the "
        "per-shape compile-grace path.",
    ),
    "DGREP_EVENT_AUDIT": Knob(
        "utils/event_audit.py", "unset",
        "1 switches the runtime event-vocabulary recorder on: every "
        "span/instant/daemon-event name emitted through SpanBuffer, "
        "EventLog, or DaemonLog is validated against the "
        "analysis/events.py registry and undeclared names log warnings "
        "(accessor: utils/event_audit.env_event_audit).  The "
        "service/obs/follow/fuse/result/chaos test fixture activates it "
        "per test — the dynamic half of analyze rule event-registry.",
    ),
    "DGREP_LOCKDEP": Knob(
        "utils/lockdep.py", "unset",
        "1 switches the runtime lock-discipline harness on: locks built "
        "via lockdep.make_lock are instrumented (per-thread acquisition "
        "stacks, lock-order inversion + blocking-syscall-while-held "
        "detection; accessor: utils/lockdep.env_lockdep).  The "
        "service/chaos/soak_mini test fixture activates it per test.",
    ),
    "DGREP_SERVICE_FUSE": Knob(
        "runtime/fusion.py", "1",
        "Cross-tenant scan fusion of the service daemon: "
        "co-running print-mode grep jobs over content-identical splits "
        "share ONE worker scan per split; 0/false disables planning "
        "entirely — wire payloads, journals, and outputs then match the "
        "pre-fusion daemon byte for byte (accessor: "
        "runtime/fusion.env_service_fuse).",
    ),
    "DGREP_FUSE_MAX_QUERIES": Knob(
        "runtime/fusion.py", "8",
        "Queries per fused attempt cap: bounds the union automaton's "
        "size and the blast radius of one lost worker (each re-enqueued "
        "participant re-runs solo; accessor: "
        "runtime/fusion.env_fuse_max_queries).",
    ),
    "DGREP_INDEX": Knob(
        "index/summary.py", "on",
        "Shard-index tier (trigram summaries route queries past shards "
        "that cannot match): 0/false disables every lookup, build, and "
        "prune — planning, wire payloads, and outputs revert to the "
        "pre-index behavior exactly (accessor: "
        "index/summary.env_index_enabled).",
    ),
    "DGREP_METRICS_WINDOW_S": Knob(
        "utils/metrics.py", "300",
        "Rolling-window width for the /metrics cache-hit rate gauges "
        "(dgrep_window_* / *_hit_ratio): piggybacked counter deltas "
        "older than this many seconds age out of the windowed totals "
        "(accessor: utils/metrics.env_metrics_window_s).",
    ),
    "DGREP_PEER_SHUFFLE": Knob(
        "runtime/peer.py", "1",
        "Peer-to-peer shuffle: service-attached workers keep "
        "map output on their local spool and reducers fetch it directly "
        "from the producer — the daemon moves shuffle METADATA only; "
        "0/false reverts to the relay data plane exactly (no server, no "
        "spool, byte-identical wire payloads; accessor: "
        "runtime/peer.env_peer_shuffle).",
    ),
    "DGREP_PEER_PORT": Knob(
        "runtime/peer.py", "0",
        "Worker shuffle data-server listen port (0 = ephemeral, the "
        "default — N worker processes per host each bind their own; "
        "accessor: runtime/peer.env_peer_port).",
    ),
    "DGREP_PEER_HOST": Knob(
        "runtime/peer.py", "bind host",
        "Advertised shuffle-endpoint host override for workers behind "
        "NAT/wildcard binds — peers must dial a routable name "
        "(accessor: runtime/peer.env_peer_host).",
    ),
    "DGREP_PEER_BIND": Knob(
        "runtime/peer.py", "127.0.0.1; 0.0.0.0 when DGREP_PEER_HOST set",
        "Shuffle data-server BIND address.  Loopback by default; a set "
        "DGREP_PEER_HOST implies the wildcard (an advertised routable "
        "name a loopback-bound server can never honor); set both for a "
        "specific-interface bind (accessor: "
        "runtime/peer.env_peer_bind).",
    ),
    "DGREP_FOLLOW_POLL_S": Knob(
        "runtime/follow.py", "0.5",
        "Standing-query wake cadence: how often a follow "
        "job's runner stats its inputs and suffix-scans growth; wins "
        "over JobConfig.follow_poll_s as the operator override "
        "(accessor: runtime/follow.env_follow_poll_s).",
    ),
    "DGREP_STREAM_BUFFER": Knob(
        "runtime/follow.py", "4194304",
        "Per-subscriber stream buffer byte cap for GET "
        "/jobs/<id>/stream: past it the oldest records shed (counted in "
        "stream_dropped_records, surfaced as an explicit `dropped` "
        "count to the lagging consumer) — the scan loop never blocks "
        "(accessor: runtime/follow.env_stream_buffer).",
    ),
    "DGREP_FOLLOW_FUSE": Knob(
        "runtime/follow.py", "1",
        "Fused follow tier: follow jobs sharing a "
        "fusion-eligible (watched-input identity x non-query options) "
        "key ride ONE group wake loop — one stat + one union suffix "
        "scan per (file, wake) serves every member; 0/false disables "
        "the group registry entirely — solo runners, /status, and wire "
        "payloads then match the pre-fusion daemon byte for byte "
        "(accessor: runtime/follow.env_follow_fuse).",
    ),
    "DGREP_LEASE_TTL_S": Knob(
        "runtime/lease.py", "10",
        "Work-root lease staleness wall (active/standby "
        "failover): a standby steals the lease — and promotes via the "
        "resume path — once the active's renewal stamp is older than "
        "this many seconds.  Setting it is also the env-side HA switch "
        "(like `dgrep serve --standby`); unset single-daemon "
        "deployments never create a lease file (accessor: "
        "runtime/lease.env_lease_ttl_s).",
    ),
    "DGREP_LEASE_RENEW_S": Knob(
        "runtime/lease.py", "ttl/3",
        "Active daemon's lease renewal cadence (and the standby's "
        "lease-poll interval).  Default ttl/3 — three missed renewals "
        "before the lease goes stale (accessor: "
        "runtime/lease.env_lease_renew_s).",
    ),
    "DGREP_DAEMON_LOG": Knob(
        "runtime/daemon_log.py", "1",
        "Daemon lifecycle event log: serving daemons append "
        "lease/quarantine/scale/admission/terminal events to "
        "<work_root>/daemon.jsonl for trace-export --fleet and dgrep "
        "explain disruptions; 0 is a true no-op — no file, no staged "
        "list, /status byte-identical (accessor: "
        "runtime/daemon_log.env_daemon_log).",
    ),
    "DGREP_TOP_INTERVAL_S": Knob(
        "__main__.py", "2",
        "Refresh cadence of the `dgrep top` live console between "
        "/status + /metrics polls (accessor: "
        "__main__.env_top_interval_s).",
    ),
    "DGREP_INDEX_SUMMARY_BYTES": Knob(
        "index/summary.py", "16384",
        "Per-shard trigram bloom size, rounded down to a power of two "
        "in [1 KB, 1 MB]; larger summaries lower the bloom "
        "false-positive rate on trigram-dense shards (accessor: "
        "index/summary.env_summary_bytes).",
    ),
    "DGREP_RESULT_CACHE": Knob(
        "runtime/result_cache.py", "on",
        "Query-result cache: the daemon persists each "
        "eligible job's results per map split under "
        "<work_root>/results/ and answers repeated queries over "
        "unchanged inputs from the store (full hit: no scheduler, no "
        "scan; partial hit: only drifted splits rescan).  0/false is a "
        "true no-op — no results/ dir, no /status key, byte-identical "
        "behavior.  One-shot CLI jobs never consult the tier (accessor: "
        "runtime/result_cache.env_result_cache).",
    ),
    "DGREP_RESULT_BYTES": Knob(
        "runtime/result_cache.py", "268435456",
        "On-disk byte budget for the result store (whole-entry LRU by "
        "mtime; loads touch).  0 disables the tier like "
        "DGREP_RESULT_CACHE=0; an entry larger than the whole budget is "
        "declined outright (accessor: "
        "runtime/result_cache.env_result_bytes).",
    ),
}

# The reference's knobs this package does not read: name -> (the
# reference's owner module, why not, the ROADMAP entry).
NOT_PORTED: dict[str, tuple[str, str, str]] = {
    "DGREP_COMPILE_GRACE_S": (
        "ops/engine.py",
        "a heartbeat grace per fresh XLA/Mosaic compile shape, part of "
        "the reference's device fallback; the port's kernels build once "
        "a source, a map task's build is covered by "
        "ops/device_scan.BUILD_GRACE_S, and nothing falls back",
        "D2, D5, D6",
    ),
    "DGREP_DEVICE_PROBE_S": (
        "ops/engine.py",
        "the reference's time-boxed first touch of the device before it "
        "falls back to the host engines; the port has no fallback (a "
        "missing card raises)",
        "D2, D5, D6",
    ),
    "DGREP_DEVICE_STALL_S": (
        "ops/engine.py",
        "the mid-scan stall wall before a scan degrades to the host "
        "engines; the port never degrades a scan",
        "D2, D5, D6",
    ),
    "DGREP_DEVICE_RETRY_S": (
        "ops/engine.py",
        "how often a degraded engine re-probes the device; the port has "
        "no degraded state to leave",
        "D2, D5, D6",
    ),
    "DGREP_NO_CALIBRATE": (
        "ops/device_scan.py",
        "switches off the FDR tuner's calibration and retune; the port "
        "has no tuner (its plans are the default-pricing plans)",
        "D2",
    ),
    "DGREP_NATIVE_LIB": (
        "utils/native.py",
        "loads another build of native/libdgrep.so (sanitizer builds); "
        "the port always builds and loads its own csrc/dgrep.cpp",
        "D16",
    ),
    "DGREP_NATIVE_RECORDS": (
        "utils/native.py",
        "the kill switch of the native record pipeline; the port's "
        "library takes every batch it accepts and a declined batch "
        "takes the plain leg, with the same bytes",
        "D16",
    ),
}


def knob_docs() -> str:
    """The registry as a markdown table — the generated operator docs —
    then the reference's knobs this package does not read."""
    rows = ["| knob | owner | default | controls |",
            "| --- | --- | --- | --- |"]
    for name in sorted(KNOBS):
        k = KNOBS[name]
        rows.append(f"| `{name}` | `{k.owner}` | {k.default} | {k.doc} |")
    rows += ["", "## Not ported (the reference reads them, this package "
                 "does not)", "",
             "| knob | reference owner | why | ROADMAP |",
             "| --- | --- | --- | --- |"]
    for name in sorted(NOT_PORTED):
        owner, why, entry = NOT_PORTED[name]
        rows.append(f"| `{name}` | `{owner}` | {why} | {entry} |")
    return "\n".join(rows) + "\n"
