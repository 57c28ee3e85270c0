"""The shard index (the reference's index/): trigram summaries let a
query skip shards that cannot match.

* ``index.summary``: the format (a case-folded trigram bloom a shard,
  built by the host library), the in-memory ``SummaryCache``, the
  counters and the DGREP_INDEX / DGREP_INDEX_SUMMARY_BYTES knobs;
* ``index.store``: one ``.tgs`` file a shard under a root, keyed by the
  content identity (realpath, size, mtime_ns, inode), replaced
  atomically, stale records rejected at load;
* ``index.plan``: a query's required-literal alternatives and the
  ``SplitPruner`` that ``runtime/job.plan_map_splits`` consults.

A summary only ever answers "cannot match"; a maybe, or a missing or
stale summary, scans.
"""

from distributed_grep_tpu_torch.index.summary import (  # noqa: F401
    DEFAULT_SUMMARY_BYTES,
    build_summary,
    env_index_enabled,
    env_summary_bytes,
    index_counters,
    index_counters_clear,
    summary_cache,
)
