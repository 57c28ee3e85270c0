#!/usr/bin/env python3
"""Smoke run of distributed_grep_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--file-mb 128] [--n-files 8]
        [--workers 2] [--kernels-only | --warm-only | --control-only |
        --telemetry-only | --tiers-only | --service-only | --multi-only]

Phase 0  the package's invariant checker (analysis/: ``run_analysis()``,
         every rule, no baseline) before any build: its ``cuda-abi`` rule
         holds each ctypes binding to its csrc/ ``extern "C"`` signature,
         the build's source lists and the shared-memory budget on the
         machine that builds the kernels.  Prints the violation count and
         the seconds on a line of their own; any violation fails the run
         before the first launch, in every mode.
Phase 1  environment: the card's name and power limit, torch/CUDA versions,
         the build of every CUDA source of the package (one nvcc per
         source, all started together, timed), ptxas's registers and
         spills per kernel instance, SASS counts (the narrow probe's per
         lane and byte at each width); the one-hot product must hold
         warpgroup MMAs (IGMMA), no IMMA, and no ptxas warning that its
         wgmma were serialized.  Beside the build, on an emptied
         ``_build/``, one CLI run (``-c 'volcano$' --metrics``) builds the
         NFA kernel inside its map task: its count must equal GNU grep's,
         its task must declare the build's grace and none may be
         re-issued (``map_retries`` 0).  Then the host library
         (csrc/dgrep.cpp, built by g++ -march=native for this CPU): each
         of its 16 entry points against its plain numpy or Python leg on
         the same inputs, bit for bit, at 16 MiB of word lines with NUL,
         0xFF, CR and broken UTF-8 planted (``phase_native``); printed as
         a ``{"native": ...}`` line (g++'s version, the -march target,
         each check and its two times) before the kernels line.
Phase 2  every kernel against its plain PyTorch version on the same inputs
         (bit-identical words: tolerance 0), at the main path's shapes and
         at small ones: the Shift-And kernel (both scan modes, five
         models), the Glushkov NFA kernel (six models of 1 to 4 state
         words, a '^' model and a model with 51 specials), the FDR filter
         kernel (the banks of BASELINE configs 2, 3 and 5 and a two-family
         bank with 1024-entry tables, each with and without case folding)
         and the pairset kernel (both orientations, a -i set), and both
         ORing into an existing word plane (out=); the Wu-Manber approx
         kernel (k = 1, 2, 3 and -i) and the SWAR packed Shift-And kernel
         ('volcano', its filter, '-i Volcano', 'being it'); the narrow-width
         probe kernel at i32, i16 and i8 (text with every byte value,
         'volcano' ending 0..6 bytes into every word at every lane
         position of a thread's group, 'volcann' beside an 'o' in one
         register, 544 lanes), and the one-hot wgmma product (1, 2 and 16
         lane blocks, the probe's member and a full-range int8 one, one
         block per SM, one block, more blocks than rows and ranges that
         straddle lane blocks), and the table-DFA kernel K1 (csrc/dfa.cu,
         with its exit states) and the stride kernel K2 (its stride walker
         at k = 2 and 4 on every table without '$' accepts whose composed
         table fits choose_stride's caps, against its plain version and
         K1's words; both table branches) at the 64 MB segment shape for
         'nee(dle|t)',
         three '$' patterns, '^$' and two Aho-Corasick banks too large for
         shared memory, then over 3 seeded random regex tables ('$'
         accepts, '^', nullable bodies) and small Aho-Corasick banks at
         small shapes and, every 8th table, the segment shape; every
         third stripe's last byte is not '\\n' (the stripe-tail rule) and
         half the draws read pitched stripes; then one draw at each forced
         sub-stripe count and draws whose fix-ups never meet ('^a*b' over
         stripes with no '\\n', every K1 branch, K2 on 'a*b' too)
         (``phase_dfa_kernels``).
         The Shift-And, approx, pairset and SWAR kernels read the (lanes,
         chunk) stripes as the document lies; the others the (chunk,
         lanes) columns.  Then a differential sweep of the two table-driven
         kernels: 6 seeded random regexes of 1-4 state words with 0-128
         specials on the NFA kernel, and 32 random FDR banks (m = 1-6,
         1-16 checks, both hash families, with and without folding, half
         ORed into a nonzero plane) with members ending at rows 0..m of
         the stripe heads, at chunk 32 and 64 over 32 lanes and at the 64
         MB segment (7 of the banks, two of the regexes); and of the two
         sub-stripe kernels: seeded random Shift-And models of the lengths
         1, 9, 17, 25 and 32 (letters, classes, '.', -i, their rare-class
         filters; both modes) and approx models (k = 1-3, m up to 32, so
         up to two warm-up words), with samples planted to end 0..W + 2
         bytes after every word boundary c0 (where these kernels may
         start a sub-stripe) and '\\n' at c0 - W - 1, c0 - W and c0 - 1,
         at chunks 32, 64, 96, 288 and 1024 over 32-96 lanes (every word
         a sub-stripe start), at 1024 x 8192 (a few), on contiguous and
         pitched windows, and at the 64 MB segment; and of the two
         stripe kernels of literal sets and packed Shift-And: 14 seeded
         random 1-2-byte sets (both orientations, -i; half the draws ORed
         into a nonzero plane) with members ending 0..2 bytes after every
         word boundary, and SWAR models of every length 1-8 (two each,
         and their filters), at the same shapes.  Each draw is held to
         its plain version bit for bit; the count of draws is logged.
Phase 3  the main path at real size, each query through runtime.job.run_job
         on "cuda" and checked line for line against ``LC_ALL=C grep -na``
         with the query's -F, -E, -i or -f.  Corpora made from --seed: 8
         files of 128 MB of English-word lines with injected needles (and
         config 3's members, some across stripe starts, and '#'), 4 files
         of 128 MB of NASA-HTTP-style access-log lines, 4 files of 128 MB
         of PCAP-like binary records with config 5's members injected, and
         one 128 MB file of lines that defeat a relaxed regex filter; the
         word queries (and phases 3c and 3d) run over the first 4 word
         files, phases 3b and 3e over all 8.  Queries:
         'volcano' (sparse, rare-class filter), '-i Volcano', 'the'
         (dense: the on-device dense confirm, 9M columnar records),
         'being it' (its rare-class
         filter is defeated: dense confirm, then the defeat guard drops
         it); BASELINE config 2's 8-word alternation (literal
         decomposition onto the FDR kernel) and config 4's
         '-i get /[a-z0-9/.-]{4,24}\\.gif' on the logs (relaxed 1-word
         filter, dense confirm on the exact 2-word model in every
         segment); '^the (old|new) ' (stripe-head false lines the stitch
         removes); 'volcano$' (the DFA-confirmed '$' filter);
         '\\bvolcano\\b' (the re-confirmed filter); 'x[ab]{2,40}y' (the
         NFA defeat guard swaps in the exact model); config 3's 1,000
         literals (FDR, sparse, the stitch), config 5's 10,000 literals on
         the PCAP records (FDR, dense candidates, the host confirm), a
         2-byte set on the PCAP records (the pairset kernel) and config
         3's set plus '#' (the FDR kernel with the pairset sidecar);
         '--max-errors 1 volcano', '--max-errors 2 -i volcano' and a k = 3
         class sequence on the approx kernel, over errorful needles (some
         across stripe starts: the window stitch), each checked against
         Sellers' edit-distance DP on the lines ``grep`` finds for any of
         the pattern's k+1 pieces; the selection and count options: '-w
         volcano', '-w -F -f' config 3 (the host confirm of -w over the
         kernels' candidate lines), '-c the' (a count per file, against
         ``grep -c``), '-v volcano' on one file (the complement), a '-x -E'
         whole log line on the logs (the NFA kernel, about 1 line in 183)
         and '-c --max-errors 2 -i volcano' (against the DP's count);
         'volcano', '-i Volcano' and 'being it' again with DGREP_SWAR=1 on
         the SWAR kernel.  Each query logs its records, batches, reduce
         spills and the streaming reader's wait; its files' oracles run
         side by side.  Then the CLI: on one file, and with -l, -L, -q, -c
         and -m 5 over two word files and the defeat file against GNU
         grep's output and exit codes; then the display options, the
         walk and standard input, each a CLI run with --metrics against
         ``LC_ALL=C grep -a`` with the matching flags, parsed into tuples,
         its route's kernel launched in its process: -o -i volcano, -C 2
         volcano ('--' separators included) and -b -w volcano over two
         word files; ``cat FILE | grep -c volcano -`` and ``... volcano
         -`` over a word file (the stdin stream), the same count on the
         file, and -q over a live pipe that must return with the pipe
         open (the stdin runs, and phase 1's cold build over 0.6 MB, with
         DGREP_DEVICE_MIN_BYTES=0: below the 1 MiB bound an input scans
         on the host, and these runs exist to launch a kernel); and the
         match-dense receipt (benchmarks/dense_receipt.py --check, 64 MiB,
         in its own process: its CLI wall, and in the CLI its job's and
         its print's seconds).  Then the host routes: nine CLI queries in
         this process with --metrics on one file of 32 MB (HOST_FILE_MB) of word
         lines with empty and space-only lines and no final '\\n'
         (``host_block``), each against ``LC_ALL=C grep -a`` with the same
         flags (rows or count, and exit status), its route in --metrics
         held ("native": '^$', -c '^ *$', -c '(ab)*$', '^(ab)*$', -F -e ' '
         -e xy, -v -c '^$'; "re": -E '(the) \\1' and -w of it; and one
         --backend cpu query), no kernel launched, each logged with its
         host_scan_seconds and wall (``host_query_runs``).  The launch
         counts of all kernels are
         zeroed just before the queries and read just after; each query
         also logs its on-card layout transposes (ops/device_scan.py
         ``transposes``): 0 on the Shift-And, approx, pairset and SWAR
         routes, which read the uploaded stripes, one per segment on the
         NFA and FDR routes (config 3 + '#' too).  Then
         the kernels, their plain versions, the transpose, the sparse
         fetch and the confirm set are timed at the main path's segment
         shape (pairset, SWAR and the table DFA also on the card's clock,
         in CUDA graphs; the table DFA on 'nee(dle|t)', config 3's bank
         and config 5's 57 MB bank, with the bytes or table-read bound
         that binds each).
Phase 3b the warm tiers, the launch counts zeroed just before and read
         just after: -r --include '*.txt' -F -f config 3 over a tree of
         2,000 files of 4-64 KiB cut from a word file (one in ten .log),
         batched by the CLI (a map task a split, packed windows of 32 MiB)
         against GNU grep, with its wall, map tasks, batch_dispatches,
         batch_fill_ratio and FDR/pairset launches; a 600 KB file through
         the CLI with the default small-input bound (the host route,
         stamped, no launch) and with the bound at 0 (the kernel), the
         same bytes; two run_jobs in this process over the word files cut
         in thirds (24 files of about 43 MiB), the second served by the
         corpus cache (hits, no file read, no upload, the same mr-out
         bytes), both walls and the resident bytes against the card's
         memory; ``grep --follow --follow-idle-s 2 volcano`` in this
         process over a 16 MiB file grown by eight appends of 1-2 MiB from
         a thread (the bound at 0, so the suffix scans launch the kernel),
         equal to a one-shot run over the final file and to GNU grep, with
         the latency from each append to its print; and
         benchmarks/many_small_files.py --check --files 500 (its JSON
         line; 500 files of 32 KiB, a 16 MiB packed window).
Phase 3c the control plane, every job's kernels launched in worker
         processes that ship their launch counts to the coordinator:
         (a) 'volcano' and config 3's set over the word files through
         ``coordinator --config`` and two ``worker --addr`` processes (one
         of two slots) on the card, n_reduce 10, each job's mr-out bytes
         (sha256 a file) equal to phase 3's in-process job of the same
         options, Shift-And and FDR launches shipped; (b) 'volcano' with
         its one worker SIGKILLed while /status shows it holding a map
         task, a second worker then started: the same bytes, at least one
         re-issue; beside it, (c) 'volcano' with the coordinator SIGKILLed
         after two map commits (two workers of one slot), restarted with
         --resume, the workers' retries reaching it: the same bytes, and
         no more maps assigned after the resume than the journal lacked;
         (d) ``run
         --config`` of the word count over 32 MiB of word lines, in a
         process of its own beside (a)-(c), its counts equal to a
         collections.Counter.  Any worker that exits nonzero, but the one
         killed, fails the run.  One line: each job's wall (and the
         seconds to its first map, its last map commit, done, and its
         workers' exits), data-plane bytes and seconds, RPCs, re-issues,
         quarantines and shipped launches.
Phase 3d the telemetry (utils/spans.py, utils/trace.py, utils/metrics.py):
         (a) 'volcano' over the word files in this process with the span
         pipeline on and DGREP_TRACE_DIR set, the launch counts zeroed
         just before: its mr-out bytes equal phase 3's untraced job's,
         events.jsonl holds a map:task span a map and a reduce:task span
         a reduce, the scan:* records' bytes add up to the input's, none
         fell back, and the torch.profiler trace (CPU and CUDA activity)
         holds as many Shift-And kernels (matched by the substring
         ``shift_and_kernel``) as the launch counter counted and the
         worker threads' map_read/map_compute regions; a trace with no
         kernel fails the phase.  It logs the card's busy share over the
         traced window (the union of the kernels' intervals over the
         trace's first-to-last event).  (b) config 3's set through
         ``coordinator --config`` with ``"spans": true`` and two worker
         processes (one of two slots): ``status --addr`` read while a map
         runs, GET /metrics read once the job is done (one map and one
         reduce phase, an assign poll per answered AssignTask at most, the
         re-issues), ``trace-export`` of its work dir (a coordinator row
         and a row per worker), the same mr-out bytes as phase 3's; it
         logs each worker's first assign_map after the coordinator's
         start, beside the seconds its processes were started at.
Phase 3e the shared tiers, the launch counts zeroed just before and read
         just after, the corpus cache off (DGREP_CORPUS_BYTES=0): (a) the
         shard index over a tree of 2,000 files of 4-64 KiB cut from a
         word file ('volcano' planted in each that lacks it) and the word
         files cut in thirds (24 files of about 43 MiB), a seeded rare
         token planted in 20 small and 2 large files: run_jobs on the card
         with ``index_dir`` (a split of small files a map task): a cold
         'volcano' job that publishes every summary, then warm jobs for
         the token, for 'volcano' and for -v the token (250 small files),
         each job's mr-out bytes equal to the host engine's job with
         DGREP_INDEX=0, the token job's also to its DGREP_INDEX=0 twin on
         the card; the token job prunes what the
         summaries rule out (at least 1,900 small and 20 large files), no
         file holding the token among them, and uploads only the unpruned
         large files' segments and the card's windows; the 'volcano' and
         -v jobs prune nothing.  Per job: the wall, index_shards_pruned,
         index_maybe_scans, index_bytes_skipped, uploads, reads, launches.
         (b) ops/fuse.FusedScanner.scan_batch over 4 of the large files in
         splits of at most MAX_FUSED_SPLIT_BYTES (one packed window a
         split) in two mixes of K = 4: config 3's 1,000 literals in four
         quarters (one FDR launch a segment and no other, where the solo
         scans take four) and 'volcano', -i 'Volcano', '^the (old|new) '
         and config 2's alternation (a case-folded union, one NFA launch a
         segment and no other); each
         query's lines equal its solo scan on the card; the fused wall
         beside the K solo walls, fused_dispatches and fusion_bytes_saved;
         then map_fused_fn over one split for three participants (-w, -x,
         -i) against each one's solo map_batch_fn records.  (c) a seeded
         sweep of 24 draws of K = 2..8 specs (literals, -F sets, the NFA
         sweep's regexes, about a third -i) over 4 MiB of word lines with
         CR, NUL and 0xFF, DGREP_DEVICE_MIN_BYTES=0: every union scan
         launches, and each query's lines equal its solo scan on the card
         and the re oracle; draws that raise FuseError are counted.
Phase 3f the service daemon (runtime/service.py) in this process over the
         first 4 word files, spans on, the shard index off
         (DGREP_INDEX=0), the launch counts zeroed just before each part
         and read just after: (a) four tenants submitted to a daemon with
         no worker ('volcano', -i 'Volcano', config 3's set and '^the
         (old|new) '), then two local workers (the second once the first
         fused assignment is out): the three pattern tenants fuse (one
         NFA union launch a segment for the three, fused_dispatches one a
         split; a task whose claim lost a race to another worker scans
         alone, on its own route), the set runs solo (one FDR launch a
         segment), no other kernel launches, and each tenant's mr-out
         equals phase 3's
         in-process job of the same query; the wall beside the sum of
         phase 3's four solo walls; the daemon's result cache is on, so
         they publish.  (d) 'volcano' resubmitted: a full result-cache
         hit, every split reused, no worker assignment, no launch, its
         records (sorted) equal (a)'s; later, 1 MiB of word lines holding
         'volcano' appended to one file: a partial hit scans that split
         alone, its launches its segments', its records equal a cold
         job's with DGREP_RESULT_CACHE=0 (the file is cut back after).
         (e) explain: a fused tenant of (a) routed "device" with the
         union's mode, (d)'s hit reporting its reused splits, and 'a*'
         (mode all_lines) routed "host" with no launch.  (b) 'volcano'
         on a second daemon of this process with the result cache off:
         its log holds cache:hit and no cache:miss, compile_cache_misses
         does not move (no build), the mr-out is phase 3's.  (f) standing
         queries over one 16 MiB word file, DGREP_DEVICE_MIN_BYTES=0:
         'volcano', -i 'Volcano' and '^the (old|new) ' in one fused
         group, -c 'volcano' solo (its count option keeps it out), while
         a thread appends eight slices of 1-2 MiB: each stream read over
         GET /jobs/<id>/stream equals the one-shot host scan of the final
         file and GNU grep (the count stream's deltas its count); the
         union's route and Shift-And launch on the wakes; the latency
         from an append to its record.  (c) a third daemon with no local
         worker and one ``worker --addr`` process, two jobs ('volcano',
         -i 'Volcano') through its one attach over /data/<job>/: the
         mr-out is phase 3's, the launches the process ships are nonzero,
         the line gives its first assign_map after the daemon's start,
         and the worker exits at the daemon's stop (C9).  (g) a daemon
         with 1 local worker and the pool's ceiling at 3 (``serve
         --max-workers``'s pool thread), 4 jobs of 50 small files: the
         advice says grow and the pool grows; idle, it drains back to 1;
         ``top --once`` prints the daemon's view and ``trace-export
         --fleet`` its daemon.jsonl with the scale events.
Phase 3g failover and the peer data plane, over the same 4 word files,
         the index and the result cache off, every job's mr-out held to
         phase 3's job of its query: (a) a daemon in this process and two
         ``worker --addr`` processes on the peer shuffle (runtime/
         peer.py), 'volcano' and config 3's set: the daemon's relay bytes
         are 0, the reducers' peer_fetches above 0, each worker row names
         its data endpoint, and the launches the processes ship hold
         Shift-And and FDR, one a segment at least.  (b) 'volcano' again;
         the worker that produced the first committed map is SIGKILLed
         before the map phase ends (no reducer has fetched its output):
         maps_lost_output is at least 1 and the Shift-And launches
         shipped exceed a clean run's by that map's.  (c) a ``serve``
         and a ``serve --standby`` process on one work root
         (DGREP_LEASE_TTL_S=2), two ``worker --addr A,B`` processes and a
         ``submit --addr A,B volcano``; the active SIGKILLed after the
         job's first map commit: the standby promotes (/status role
         active, daemon.jsonl lease_steal at epoch 2), the submit prints
         one line with one job id, done; the seconds from the kill to
         the promotion and to the job's end.
Phase 3h multi-GPU on one host (parallel/, the engine's devices and mesh)
         over the first word file: a mesh over every card when the host
         has two or more, else four entries of cuda:0; 'volcano', '^the
         (old|new) ', config 2, config 3's set, a 2-byte set and
         '--max-errors 1 volcano' on a mesh engine give the single-device
         engine's lines, the entries times its launches and a one-entry
         mesh's psum_candidates; each sharded kernel's words on a 64 MB
         segment equal one device's bit for bit; '^$' on a mesh engine
         routes dfa (K1 launched) with GNU grep's lines; run_job of
         'volcano' with a two-entry devices list and with mesh_shape [4]
         give the one-card job's mr-out; sharded_grep_step on needle
         matches K1's plain words and exit states.  Every line prints
         ``cards`` beside ``mesh_entries``: no run spans two cards unless
         the host has them.  Then, with the launch counts zeroed just
         before and read just after, the pattern axis and several
         processes: (a) config 3's set, with -i and with '#' (a pairset
         sidecar) on a (2, 2) mesh over ("data", "seq") with
         pattern_axis "seq" give the one-card engine's lines; (b)
         sharded_fdr_pattern_step on a 64 MiB segment with config 3's set
         in four quarters (four same-plan banks) equals one device's OR
         of the four banks bit for bit, and a mixed-plan set (40,000
         config-5-recipe members, two plans) logs the reference's line
         and shards lanes alone, with the one-card lines; (c)
         sharded_pattern_set_step with config 3's quarters as four
         Aho-Corasick banks on K1 equals the banks' K1 words OR'd on one
         device and K1's plain version; (d) two ranks (this script with
         --mesh-rank, a gloo group on 127.0.0.1, two entries of cuda:0
         each: NCCL refuses two ranks on one card) give the one-card
         lines of 'volcano' and of config 3's set over the pattern axis,
         and sharded_grep_step's one-process words, total and exit
         states, in both ranks; (e) dryrun_multichip over four entries of
         cuda:0 prints its OK line.  Each line prints its ranks and
         cards.
Phase 4  the measuring path, in this process with the launch counts zeroed
         just before it and read just after: the port's headline bench
         (its JSON line parsed, its count band held), kernel_compare's
         pallas, nfa, nfa_alt8, pairset, mxu_dot, dfa, stride2, stride4,
         aho256 and native_mt engines at 64 MiB,
         probe_narrow's i32 / i16 slope, and the BASELINE config suite
         (configs 1-5 at 64 MB) end to end with --check (any MISMATCH
         fails) and with slope timing.  Then the two probe kernels
         (eagerly and on the card's clock, in CUDA graphs; the narrow
         probe's widths in turns), their plain versions and torch._int_mm
         (the one-hot product as a cuBLAS int8 GEMM, over a 1 MiB window,
         scaled to 64 MiB) are timed.

The last three lines of standard output are one JSON object with the host
library's checks, one with every kernel's numbers (ten kernels; the
table DFA's and K2's launches are the measuring path's, 0 on the main
path; K1 runs on phase 3h's mesh route too) and one with the device.  Any failure raises
(exit status 1); without CUDA, or without the package beside this file,
the script prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke"  # git-ignored: corpus and job state, removed at exit

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# 32-bit operation issue rate: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz
# boost (the 67 TFLOP/s fp32 figure, an FMA counted as two).  An SM has 64
# INT32 lanes, but the compiler moves integer multiply-adds, moves and
# shifts (IMAD.*) onto the FP32 pipe, so integer code can retire up to 128
# operations per clock: the approx kernel ran faster than 64 allow.
H100_ALU_OPS_PER_S = 132 * 128 * 1.98e9
SHIFT_AND_OPS_PER_BYTE = 5  # load, table lookup, shift-or, and, accumulate
# csrc/nfa.cu per input byte, counting a three-input logic operation as
# one: 3 (byte load, newline test, output bit) plus 5 per state word (B
# lookup, chain and-shift, the three-way or of init, anchor and chain, the
# AND with B, the final test), plus 2 + n_words per special of a word whose
# special sources are live at that step (the select, then one and-or per
# target word).
NFA_OPS_PER_BYTE = 3
NFA_OPS_PER_WORD = 5

# csrc/fdr.cu per input byte: 3 (byte load, fold, output bit), 3 per hash
# family (two multiplies and the xor), 3 per check (domain mask, table
# lookup, the AND into its slot) and 1 per slot (the pipeline AND).
FDR_OPS_PER_BYTE = 3
FDR_OPS_PER_FAMILY = 3
FDR_OPS_PER_CHECK = 3
FDR_OPS_PER_SLOT = 1
# The pairset yardstick per input byte since PR 3 (the column kernel: load,
# fold, two lookups, shift, and, output bit, carry).  The stripe kernel
# does about 5 (no fold: the tables are folded; one 8-byte load of both
# tables' entries); either way the bytes bound it.
PAIRSET_OPS_PER_BYTE = 8
# Shared-memory lookups at random addresses: 32 four-byte banks per SM, one
# access each per clock, 132 SMs at 1.98 GHz.
H100_SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9
# csrc/approx.cu per input byte: 10 (byte load, table lookup and its
# address, newline test, the two operations of R_0, the select of R_0, the
# output bit's test, shift and or) plus 9 per further row (its shift and
# and-or, the shifts of R_{j-1} and of the new R'_{j-1}, the or of the four
# terms and the seed, the select of the newline reset).
APPROX_OPS_PER_BYTE = 10
APPROX_OPS_PER_ROW = 9
# The SWAR yardstick per input byte since PR 4: per packed uint32 (four
# input bytes) three byte extracts, four table lookups, three ors, the
# shift, the or-and of the step and the accumulate -- 14, so 3.5; one lookup
# per byte.  The stripe kernel does about 4.5 (a fourth byte extract and
# three permutes in place of the ors); either way the bytes bound it.
SWAR_OPS_PER_BYTE = 3.5
# csrc/probe_narrow.cu per input byte: the load, six compares and six
# selects of the class chain, the shift-or, the and and the accumulate.
NARROW_OPS_PER_BYTE = 16
# csrc/mxu_dot.cu: 128 columns x 256 byte values of multiply-adds per input
# byte, each two operations, at the H100 SXM's 1,979 TOP/s of dense int8
# (NVIDIA's data sheet, 700 W): 132 SMs x 4096 int8 MACs a clock x 2 at a
# 1.83 GHz clock.  The timing block also reads the SM clock under load and
# gives the bound at that clock.
MXU_MACS_PER_BYTE = 128 * 256
H100_INT8_OPS_PER_S = 1979e12
H100_INT8_MACS_PER_SM_CLOCK = 4096
# csrc/dfa.cu per input byte: two table reads at random addresses (the
# byte's class in shared memory, then the (state, class) entry), each at
# best a lookup at H100_SMEM_LOOKUPS_PER_S: in shared memory, or for a
# table past the shared-memory budget a hit in the L1, which is the same
# memory.  The bytes count the table once.  Beside that bound the timing
# block logs what the reads would cost if each went to the L2 (one
# 32-byte sector each at an assumed 5.5 TB/s, not a data-sheet figure):
# not a bound, since the L1 serves a table's hot rows (run 13A: config
# 3's 0.8 MB bank ran 0.1007 ms against that 0.3905).
DFA_LOOKUPS_PER_BYTE = 2
H100_L2_SECTORS_PER_S = 5.5e12 / 32
# The eager times of the table-DFA kernels' first design (one thread a
# stripe) on the timing block's tables, as PERF.md section 6 rows 9-10
# give them (an H100 80GB HBM3 at 700 W), printed beside this run's
FIRST_DFA_MS = {("dfa", "nee(dle|t)"): 0.0683,
                ("dfa", "config 3 bank"): 0.0954,
                ("dfa", "config 5 bank 0"): 0.4536,
                ("dfa_stride", "nee(dle|t)", 2): 0.0467,
                ("dfa_stride", "nee(dle|t)", 4): 0.0563,
                ("dfa_stride", "config 3 bank", 2): 0.0714}
# The host-route queries' file (MB): the smoke's 900 s aim.  At 128 MB
# (run 13A) the nine queries took 58.6 s, 9.9 of them the record merge
# of the -F query's 267 MB output, past the CLI's vectorized display cap.
HOST_FILE_MB = 32

CONFIG2_WORDS = ["volcano", "anarchism", "philosophy", "needle", "wikipedia",
                 "quantum", "zeppelin", "obsidian"]
CONFIG2 = "(" + "|".join(CONFIG2_WORDS) + ")"
PAIR_SET = [b"zq", b"9!", b"Q#", b"~~"]
# (chunk, lanes) of the set kernels' phase-2 checks: the main path's 64 MB
# segment and a small multi-word layout
SET_SHAPES = [(1024, 65536), (160, 64)]
CONFIG4 = r"get /[a-z0-9/.-]{4,24}\.gif"
# a whole log line (-x): one path of six, a 40x status, about 1 line in 183
LOG_LINE_X = (r'host[0-9]+\.example\.com - - \[[0-9A-Za-z/: -]+\] '
              r'"GET /icons/menu\.gif HTTP/1\.0" 40[0-9] [0-9]+')
WIDE_WORDS = ["volcano", "anarchism", "philosophy", "wikipedia", "quantum",
              "zeppelin", "obsidian", "telescope", "metabolic", "hurricane",
              "labyrinth", "xylophone"]
# The approx queries: (pattern, k, -i, the k+1 pieces of the oracle's
# prefilter).  A match within k edits leaves one of any k+1 disjoint pieces
# of the pattern intact (pigeonhole), so the lines that hold a piece are a
# superset of the matching lines; each split below avoids pieces common in
# the words corpus where it can ('ano' is in 'another').
K3 = "[Ss]chwarzen[ae]"  # a name search with typos: 10 symbols, 2 classes
APPROX_QUERIES = [
    ("volcano", 1, False, ["vol", "cano"]),
    ("volcano", 2, True, ["vo", "lc", "ano"]),
    (K3, 3, False, ["[Ss]c", "hw", "arz", "en[ae]"]),
]
# the bases of the errorful needles (1..3 random edits each)
APPROX_BASES = [b"volcano", b"Volcano", b"VOLCANO", b"Schwarzene",
                b"schwarzena"]

_WORDS = (
    "the of and to in a is that for it as was with be by on not he his but "
    "at are this have from or had they you which one were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through years where much your way "
    "well down should because each just those people how too little state "
    "good very make world still own see men work long get here between both "
    "life being under never day same another know while last might us great "
    "old year off come since against go came right used take three"
).split()


_T0 = time.perf_counter()
_LAST_HEADER = [_T0]  # when the last phase header was printed


def log(msg: str) -> None:
    """Print a line; a phase's header ("== ...") with the seconds since
    the script started and the seconds the phase before it took."""
    if msg.startswith("== "):
        now = time.perf_counter()
        msg += (f" [{now - _T0:.1f} s in; the phase before "
                f"{now - _LAST_HEADER[0]:.1f} s]")
        _LAST_HEADER[0] = now
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sm_clock_under(torch, fn, reps: int = 20, replays: int = 50):
    """(SM clock, its maximum, both MHz; whether the card was still busy
    when nvidia-smi returned), read while the card replays a CUDA graph of
    `reps` calls of fn `replays` times."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    for _ in range(replays):
        graph.replay()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    sm, top = (int(v) for v in out.stdout.splitlines()[0].split(","))
    return sm, top, busy


def ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel function, its ptxas -v lines joined) for every entry
    function of one nvcc run's output, in its order."""
    out: list[tuple[str, list[str]]] = []
    for line in log.splitlines():
        text = line.strip()
        if "Function properties for " in text:
            out.append((text.split("Function properties for ", 1)[1], []))
        elif out and ("registers" in text or "spill" in text):
            out[-1][1].append(text.replace("ptxas info    : ", ""))
    return [(f, "; ".join(lines)) for f, lines in out]


def template_label(func: str) -> str:
    """The integer and bool template arguments of a mangled kernel name:
    'nfa_kernel<2, 1>' for _Z..10nfa_kernelILi2ELb1EEv..., and
    'scan_kernel<StrideWalker<2, 1>>' for csrc/dfa.cu's walkers."""
    w = re.search(r"\d([A-Z][A-Za-z]*Walker)I((?:L[ib]\d+E)+)E", func)
    if w:
        args = re.findall(r"L[ib](\d+)E", w.group(2))
        return f"scan_kernel<{w.group(1)}<{', '.join(args)}>>"
    m = re.search(r"([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)E", func)
    if not m:  # not a template: its name alone
        plain = re.search(r"\d([a-z][a-z_]*_kernel)E", func)
        return plain.group(1) if plain else func
    args = re.findall(r"L[ib](\d+)E", m.group(2))
    return f"{m.group(1)}<{', '.join(args)}>"


# ------------------------------------------------------------- corpus
def words_block(rng, n_bytes: int):
    """English-word lines (3..23 words each, words drawn uniformly from
    _WORDS, as the reference benchmark's corpus recipe), vectorized:
    exactly n_bytes bytes."""
    import numpy as np

    vocab = [w.encode() for w in _WORDS] + [b" ", b"\n"]
    n_lines = n_bytes // 40 + 16
    per_line = rng.integers(3, 24, size=n_lines)
    idx = rng.integers(0, len(_WORDS), size=int(per_line.sum()))
    sep = np.full(idx.size, len(_WORDS), dtype=np.int64)  # " "
    sep[np.cumsum(per_line) - 1] = len(_WORDS) + 1  # "\n" ends a line
    out = gather_tokens(vocab, np.stack([idx, sep], axis=1).reshape(-1))
    if out.size < n_bytes:  # lines average ~60 bytes: never at these sizes
        raise RuntimeError("corpus block estimate too small")
    return out[:n_bytes]


def log_block(rng, n_bytes: int):
    """NASA-HTTP-style access-log lines (the recipe of BASELINE config 4,
    benchmarks/baseline_configs.py _log_text: 100 hosts, 6 paths of which
    2 end in .gif, status 200..504, size 0..99999), vectorized: whole
    lines, at least n_bytes bytes."""
    import numpy as np

    hosts = [f"host{i}.example.com".encode() for i in range(100)]
    paths = [b"/images/logo", b"/shuttle/missions", b"/cgi-bin/query",
             b"/images/KSC-small.gif", b"/history/apollo", b"/icons/menu.gif"]
    secs = [b"%02d" % i for i in range(60)]
    codes = [b"%d" % i for i in range(200, 505)]
    sizes = [b"%d" % i for i in range(100000)]
    fixed = [b" - - [01/Jul/1995:00:00:", b' -0400] "GET ', b' HTTP/1.0" ',
             b" ", b"\n"]
    vocab = hosts + paths + secs + codes + sizes + fixed
    base = np.cumsum([0, len(hosts), len(paths), len(secs), len(codes),
                      len(sizes)])
    f0 = int(base[-1])
    n_lines = n_bytes // 80 + 16
    ids = np.empty((n_lines, 10), dtype=np.int64)
    ids[:, 0] = rng.integers(0, len(hosts), n_lines)
    ids[:, 1] = f0
    ids[:, 2] = base[2] + rng.integers(0, 60, n_lines)
    ids[:, 3] = f0 + 1
    ids[:, 4] = base[1] + rng.integers(0, len(paths), n_lines)
    ids[:, 5] = f0 + 2
    ids[:, 6] = base[3] + rng.integers(0, len(codes), n_lines)
    ids[:, 7] = f0 + 3
    ids[:, 8] = base[4] + rng.integers(0, 100000, n_lines)
    ids[:, 9] = f0 + 4
    return gather_tokens(vocab, ids.reshape(-1))


def gather_tokens(vocab: list[bytes], idx):
    """The concatenation of vocab[i] for i in idx, vectorized."""
    import numpy as np

    wlen = np.array([len(w) for w in vocab], dtype=np.int64)
    table = np.zeros((len(vocab), int(wlen.max())), dtype=np.uint8)
    for i, w in enumerate(vocab):
        table[i, : len(w)] = np.frombuffer(w, np.uint8)
    tok_len = wlen[idx]
    pos = np.concatenate(([0], np.cumsum(tok_len)[:-1]))
    out = np.empty(int(tok_len.sum()), dtype=np.uint8)
    for k in range(table.shape[1]):
        sel = tok_len > k
        out[pos[sel] + k] = table[idx[sel], k]
    return out


def bc_block(rng, n_bytes: int) -> bytes:
    """Lines 'a' + 30..100 bytes of [bc] + 'd': every byte keeps some
    bounded-repeat position of a[bc]{40,90}d live.  Exactly n_bytes."""
    import numpy as np

    lens = rng.integers(30, 101, size=n_bytes // 32 + 1)
    ends = np.cumsum(lens + 3)  # 'a' + run + 'd' + '\n'
    out = rng.choice(np.frombuffer(b"bc", np.uint8), size=int(ends[-1]))
    out[ends - lens - 3] = ord("a")
    out[ends - 2] = ord("d")
    out[ends - 1] = ord("\n")
    return out[:n_bytes].tobytes()


def make_log_corpus(seed: int, n_files: int, file_bytes: int) -> list[Path]:
    """Access-log files: one block made from ``seed``, each file that block
    rotated to start at another of its lines."""
    import numpy as np

    rng = np.random.default_rng(seed + 4)
    block = log_block(rng, min(file_bytes, 64 << 20))
    starts = np.concatenate(([0], np.flatnonzero(block == 10)[:-1] + 1))
    corpus = WORK / "logs"
    corpus.mkdir(parents=True, exist_ok=True)
    paths = []
    reps = -(-file_bytes // block.size) + 1
    for i in range(n_files):
        at = int(starts[rng.integers(0, starts.size)])
        data = np.tile(np.roll(block, -at), reps)[:file_bytes]
        path = corpus / f"access-{i:02d}.log"
        data.tofile(path)
        paths.append(path)
    return paths


def make_defeat_file(seed: int, file_bytes: int) -> Path:
    """Lines 'x' + 60 x 'a' + 'y': every one a candidate of the relaxed
    filter x[ab]{2,}y and none a match of x[ab]{2,40}y, with a few true
    matches planted."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    line = np.frombuffer(b"x" + b"a" * 60 + b"y\n", np.uint8)
    n_lines = file_bytes // line.size
    data = np.tile(line, n_lines)
    hit = np.frombuffer(b"x" + b"ab" * 5 + b"y real " + b"z" * 43, np.uint8)
    for k in rng.choice(n_lines, size=12, replace=False).tolist():
        data[k * line.size : k * line.size + hit.size] = hit
    path = WORK / "defeat" / "lines.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    data.tofile(path)
    return path


def rand_literals(n: int, lo: int, hi: int, seed: int, alphabet=None) -> list[str]:
    """n distinct members of lo..hi characters, lowercase unless
    ``alphabet``: the recipe of benchmarks/baseline_configs.py
    _rand_literals."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < n:
        k = int(rng.integers(lo, hi + 1))
        if alphabet is None:
            chars = rng.integers(97, 123, size=k)  # a-z
        else:
            chars = rng.choice(alphabet, size=k)
        pats.add("".join(chr(c) for c in chars))
    return sorted(pats)


def config3_set() -> list[bytes]:
    """BASELINE config 3: 1,000 lowercase literals of 6-12 bytes."""
    return [p.encode() for p in rand_literals(1000, 6, 12, seed=3)]


def config5_set() -> list[bytes]:
    """BASELINE config 5: 10,000 literals of 5-9 bytes over 0x01-0xFF
    without '\\n' (a Snort-style ruleset)."""
    import numpy as np

    alphabet = np.arange(1, 256)
    alphabet = alphabet[alphabet != 0x0A]
    return [p.encode("latin-1")
            for p in rand_literals(10_000, 5, 9, seed=5, alphabet=alphabet)]


def errorful(rng, base: bytes) -> bytes:
    """``base`` after 1..3 random edits: each substitutes, inserts or
    deletes a lowercase letter at a random place."""
    b = bytearray(base)
    for _ in range(int(rng.integers(1, 4))):
        op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(b)))
        ch = int(rng.integers(97, 123))
        if op == 0:
            b[p] = ch
        elif op == 1:
            b.insert(p, ch)
        elif len(b) > 1:
            del b[p]
    return bytes(b)


def put(data, where, members) -> None:
    """Overwrite data at each offset of ``where`` with the next member."""
    import numpy as np

    for k, p in enumerate(where.tolist()):
        nd = members[k % len(members)]
        data[p : p + len(nd)] = np.frombuffer(nd, np.uint8)


def make_corpus(seed: int, n_files: int, file_bytes: int) -> list[Path]:
    import numpy as np

    rng = np.random.default_rng(seed)
    erng = np.random.default_rng(seed + 11)
    block = words_block(rng, 64 << 20)
    needles = [b"volcano", b"Volcano", b"VOLCANO", b"volCANo"]
    members = config3_set()
    corpus = WORK / "corpus"
    corpus.mkdir(parents=True, exist_ok=True)
    paths = []
    reps = -(-file_bytes // block.size)
    for i in range(n_files):
        data = np.tile(block, reps)[:file_bytes].copy()
        n_inj = 1000 * file_bytes // (64 << 20)
        where = np.sort(rng.choice(file_bytes - 16, size=n_inj, replace=False))
        kinds = rng.integers(0, len(needles), size=n_inj)
        put(data, where, [needles[k] for k in kinds.tolist()])
        # config 3's first 50 members once per 64 KiB (the recipe of
        # benchmarks/baseline_configs.py config_3), and '#' for the mixed set
        n_set = file_bytes // 65536
        put(data, rng.integers(0, file_bytes - 64, size=n_set),
            [members[k] for k in rng.integers(0, 50, size=n_set).tolist()])
        put(data, rng.integers(0, file_bytes - 64, size=200), [b"#"])
        # at stripe starts (multiples of 1024 bytes, the main path's stripe
        # length): 'the new ', which '^the (old|new) ' takes for a line
        # start, and config 3 members from 3 bytes before it, which the
        # FDR kernel misses (the stitch adds them)
        heads = (rng.choice(file_bytes // 1024 - 1, size=200, replace=False)
                 + 1) * 1024
        put(data, heads[:100], [b"the new "])
        put(data, heads[100:] - 3,
            [members[k] for k in rng.integers(0, 1000, size=100).tolist()])
        # the approx queries' errorful needles, from a generator of their
        # own (the draws above stay as they were): 500 per 64 MB, and 100
        # from 3 bytes before stripe starts the lines above left alone,
        # where the approx kernel misses them and the window stitch adds
        # them
        n_err = 500 * file_bytes // (64 << 20)
        variants = [errorful(erng, APPROX_BASES[k]) for k in erng.integers(
            0, len(APPROX_BASES), size=n_err + 100).tolist()]
        put(data, np.sort(erng.choice(file_bytes - 16, size=n_err,
                                      replace=False)), variants[:n_err])
        free = np.setdiff1d(np.arange(1, file_bytes // 1024) * 1024, heads)
        put(data, erng.choice(free, size=100, replace=False) - 3,
            variants[n_err:])
        path = corpus / f"part-{i:02d}.txt"
        data.tofile(path)
        paths.append(path)
    return paths


def make_pcap_corpus(seed: int, n_files: int, file_bytes: int) -> list[Path]:
    """PCAP-payload-like records (benchmarks/baseline_configs.py
    _binary_payload): random bytes, '\\n' re-placed about every 120 bytes,
    config 5's first 100 members injected once per 64 KiB, and the 2-byte
    set's members across 100 stripe starts per file."""
    import numpy as np

    rng = np.random.default_rng(seed + 5)
    members = config5_set()[:100]
    corpus = WORK / "pcap"
    corpus.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n_files):
        data = rng.integers(0, 256, size=file_bytes, dtype=np.uint8)
        data[data == 0x0A] = 0x0B
        data[rng.integers(0, file_bytes, size=file_bytes // 120)] = 0x0A
        n_set = file_bytes // 65536
        put(data, rng.integers(0, file_bytes - 64, size=n_set),
            [members[k] for k in rng.integers(0, 100, size=n_set).tolist()])
        heads = (rng.choice(file_bytes // 1024 - 1, size=100, replace=False)
                 + 1) * 1024
        put(data, heads - 1, PAIR_SET)
        path = corpus / f"records-{i:02d}.bin"
        data.tofile(path)
        paths.append(path)
    return paths


def grep_oracle_lines(path: Path, grep_args: list[str]) -> list[tuple[int, str]]:
    """The oracle: ``LC_ALL=C grep -na ARGS FILE`` (byte semantics; GNU
    grep's -E, -F, -i and \\b agree with the port's on these queries), read
    back as (line number, line) pairs, the line decoded as the grep app
    decodes it."""
    if shutil.which("grep") is None:
        raise RuntimeError("grep not found: it is the oracle of every query")
    out = subprocess.run(["grep", "-na", *grep_args, str(path)],
                         capture_output=True, timeout=900,
                         env={**os.environ, "LC_ALL": "C"})
    if out.returncode > 1:
        raise RuntimeError(f"grep oracle failed: {out.stderr[:300]!r}")
    lines = out.stdout.split(b"\n")
    if lines and not lines[-1]:
        lines.pop()
    pairs = []
    for ln in lines:
        num, _, text = ln.partition(b":")
        pairs.append((int(num), text.decode("utf-8", "replace")))
    return pairs


def grep_oracle_count(path: Path, grep_args: list[str]) -> int:
    """``LC_ALL=C grep -c -a ARGS FILE``: the selected line count."""
    out = subprocess.run(["grep", "-c", "-a", *grep_args, str(path)],
                         capture_output=True, timeout=900,
                         env={**os.environ, "LC_ALL": "C"})
    if out.returncode > 1:
        raise RuntimeError(f"grep oracle failed: {out.stderr[:300]!r}")
    return int(out.stdout)


def cli_runs(files: list[Path], work: Path) -> list[str]:
    """The port CLI's -l, -L, -q, -c and -m 5 over ``files`` against GNU
    grep's (``LC_ALL=C``) file sets, counts, (file, line) sets and exit
    codes; raises on a difference.  Returns a log line a run.  The five
    run side by side (so that phase 3c fits the smoke's time),
    each in a work dir of its own, so a wall holds its neighbours'
    contention."""

    def one(i: int, flags: list[str]) -> str:
        t0 = time.perf_counter()
        port = subprocess.run(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "grep",
             *flags, "volcano", *map(str, files), "--work-dir",
             str(work / f"cli-{i}")],
            cwd=ROOT, capture_output=True, timeout=900)
        wall = time.perf_counter() - t0
        gnu = subprocess.run(
            ["grep", "-a", *flags, *(["-n"] if "-m" in flags else []),
             "-F", "-e", "volcano", *map(str, files)],
            capture_output=True, timeout=900,
            env={**os.environ, "LC_ALL": "C"})
        want = gnu.stdout
        if "-m" in flags:  # (path, line number) of each selected line
            got = {(ln.split(b" (line number #")[0],
                    int(ln.split(b" (line number #")[1].split(b")")[0]))
                   for ln in port.stdout.splitlines()}
            want = {(ln.split(b":")[0], int(ln.split(b":")[1]))
                    for ln in gnu.stdout.splitlines()}
        else:
            got = port.stdout
        if got != want or port.returncode != gnu.returncode:
            raise AssertionError(
                f"CLI {' '.join(flags)}: exit {port.returncode} vs GNU grep "
                f"{gnu.returncode}; stdout {port.stdout[:300]!r} vs "
                f"{gnu.stdout[:300]!r}; stderr {port.stderr[-300:]!r}")
        return (f"CLI grep {' '.join(flags)} volcano over {len(files)} "
                f"files: exit {port.returncode}, "
                f"{len(port.stdout.splitlines())} output lines, equal to "
                f"GNU grep's ({wall:.1f} s, five side by side)")

    runs = (["-l"], ["-L"], ["-q"], ["-c"], ["-m", "5"])
    with ThreadPoolExecutor(len(runs)) as pool:
        return list(pool.map(one, range(len(runs)), runs))


# ------------------------------------------------- the CLI's display runs
def cli_metrics(label: str, rc: int, stderr: bytes) -> dict:
    """The JSON object a CLI run with --metrics wrote to stderr; raises
    when the run failed (exit status above 1) or wrote none."""
    err = stderr.decode(errors="replace")
    if rc > 1 or "{" not in err:
        raise AssertionError(f"CLI {label}: exit {rc}, stderr {err[-600:]!r}")
    return json.JSONDecoder().raw_decode(err[err.index("{"):])[0]


# The environment of a CLI run that must launch its route's kernel on an
# input below the small-input bound (1 MiB), which would take the host.
KERNELS_AT_EVERY_SIZE = {"DGREP_DEVICE_MIN_BYTES": "0"}


def port_cli(args: list, stdin=None, timeout: int = 900, env=None):
    """One port CLI run with --metrics: (completed process, wall seconds,
    its metrics: the job's, or the stdin stream's); ``env`` adds to the
    environment."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "grep",
         *map(str, args), "--metrics"],
        cwd=ROOT, capture_output=True, stdin=stdin, timeout=timeout,
        env={**os.environ, **(env or {})})
    wall = time.perf_counter() - t0
    return r, wall, cli_metrics(" ".join(map(str, args)), r.returncode,
                                r.stderr)


def gnu(args: list, stdin=None) -> subprocess.CompletedProcess:
    """``LC_ALL=C grep -a ARGS``, the oracle of every CLI run."""
    r = subprocess.run(["grep", "-a", *map(str, args)], capture_output=True,
                       stdin=stdin, timeout=900,
                       env={**os.environ, "LC_ALL": "C"})
    if r.returncode > 1:
        raise RuntimeError(f"grep oracle failed: {r.stderr[:300]!r}")
    return r


PORT_LINE = re.compile(rb"^(.*) \(line number #(\d+)\)(-?)"
                       rb"(?: \(byte #(\d+)\)-?)? (.*)$")


def port_tuples(out: bytes) -> list:
    """(path, line, context?, byte offset or None, text) of each display
    line of the port CLI; '--' separators as themselves."""
    rows = []
    for ln in out.splitlines():
        if ln == b"--":
            rows.append(b"--")
            continue
        m = PORT_LINE.match(ln)
        if m is None:
            raise AssertionError(f"unparseable CLI line {ln[:200]!r}")
        rows.append((m.group(1), int(m.group(2)), m.group(3) == b"-",
                     None if m.group(4) is None else int(m.group(4)),
                     m.group(5)))
    return rows


def gnu_tuples(out: bytes, paths: list, boff: bool = False,
               label: bytes | None = None) -> list:
    """GNU grep's -n [-b] lines, ``path:N:[K:]text`` (``-`` in place of
    ``:`` on context lines), as ``port_tuples`` gives them; a single
    input without a path prefix is shown as ``label``."""
    heads = [str(p).encode() for p in paths]
    rows = []
    for ln in out.splitlines():
        if ln == b"--":
            rows.append(b"--")
            continue
        path = label
        if label is None:
            path = next(h for h in heads if ln.startswith(h))
            ln = ln[len(path) + 1:]
        m = re.match(rb"^(\d+)([:-])(?:(\d+)[:-])?(.*)$" if boff
                     else rb"^(\d+)([:-])()(.*)$", ln, re.S)
        rows.append((path, int(m.group(1)), m.group(2) == b"-",
                     int(m.group(3)) if boff else None, m.group(4)))
    return rows


def make_small_tree(source: Path, root: Path, n_files: int = 2000,
                    seed: int = 0) -> int:
    """``n_files`` files of 4-64 KiB cut at newlines from ``source``, in
    20 directories of 2 levels; one in ten is ``.log`` (left out by
    --include '*.txt').  Returns the bytes written."""
    import numpy as np

    rng = np.random.default_rng(seed)
    data = source.read_bytes()[: 160 << 20]
    pos = total = 0
    for i in range(n_files):
        size = int(rng.integers(4 << 10, 64 << 10))
        end = data.find(b"\n", pos + size) + 1
        if end <= 0 or end > len(data):
            pos, end = 0, data.find(b"\n", size) + 1
        d = root / f"d{i % 20:02d}" / f"s{i % 3}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"f{i:04d}.{'log' if i % 10 == 9 else 'txt'}").write_bytes(
            data[pos:end])
        total += end - pos
        pos = end
    return total


def cold_build_cli(path: Path):
    """Start a CLI run over ``path`` on the card whose route (the NFA
    kernel) has no build yet: the task builds it with its grace declared.
    ``path`` is under the small-input bound, so the run pins it to 0: the
    kernel must run.  Returns the process."""
    return subprocess.Popen(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "grep", "-c",
         "volcano$", str(path), "--metrics"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, **KERNELS_AT_EVERY_SIZE})


def check_cold_build(proc, path: Path) -> str:
    """The cold-build run's result: its count equals GNU grep's and no
    map task was re-issued while nvcc ran."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    metrics = cli_metrics("on an empty _build/", proc.returncode, err)
    counters = metrics["counters"]
    want = gnu(["-c", "-E", "volcano$", path]).stdout
    if (out != want or counters.get("map_retries", 0) != 0
            or counters.get("grace_declared", 0) < 1
            or metrics["launches"]["nfa"] < 1):
        raise AssertionError(f"cold-build CLI: stdout {out!r} vs {want!r}, "
                             f"counters {counters}, launches "
                             f"{metrics['launches']}")
    return (f"CLI on an empty _build/ (-c 'volcano$', the NFA kernel built "
            f"inside the map task): map_retries 0, grace_declared "
            f"{counters['grace_declared']}, map_fn "
            f"{metrics['seconds']['map_fn']:.2f} s, count equal to GNU "
            f"grep's")


def cli_display_runs(words: list[Path], stdin_file: Path) -> list[str]:
    """The CLI's display options and standard input on the card, each
    against LC_ALL=C grep -a with the matching flags, parsed into tuples;
    each run's kernel launches (from its --metrics, a process of its own:
    the counts start at 0) must include its route's kernel.  The stdin
    runs pin the small-input bound to 0: a block of the stream, or the
    live pipe's one line, may be smaller.  The seven run side by side
    (for the smoke's time), so a wall holds its neighbours' contention.  Returns a log line a run."""
    mib = [p.stat().st_size >> 20 for p in words[:2]]
    both = f"{mib[0]} + {mib[1]} MiB"

    def checked(label, r, wall, metrics, kernel, got, want, gnu_rc) -> str:
        if got != want or r.returncode != gnu_rc:
            raise AssertionError(
                f"CLI {label}: exit {r.returncode} vs GNU {gnu_rc}; "
                f"{len(got)} vs {len(want)} rows; first difference "
                f"{next((g, w) for g, w in zip(got + [None], want + [None]) if g != w)!r}")
        if metrics["launches"][kernel] < 1:
            raise AssertionError(f"CLI {label}: no {kernel} launch "
                                 f"({metrics['launches']})")
        c = metrics["counters"]
        secs = metrics.get("seconds", {})
        return (
            f"CLI {label}: exit {r.returncode}, {len(got)} rows equal to "
            f"GNU grep's, wall {wall:.3f} s"
            + (f" (job {secs['cli_job']:.3f} s, print "
               f"{secs['cli_print']:.3f} s)" if "cli_job" in secs else "")
            + f", launches {kernel} {metrics['launches'][kernel]}, "
            + ", ".join(f"{k} {v}" for k, v in sorted(c.items())
                        if k in ("map_completed", "map_retries", "scans",
                                 "bytes", "selected_lines"))
            + (f", segments {metrics['engine']['segments']}"
               if "engine" in metrics else ""))

    two = words[:2]

    def only_o() -> str:
        r, wall, m = port_cli(["-o", "-i", "volcano", *two])
        g = gnu(["-o", "-n", "-i", "volcano", *two])
        return checked(
            f"-o -i volcano ({both})", r, wall, m, "shift_and",
            [(p, n, t) for p, n, _c, _b, t in port_tuples(r.stdout)],
            [(p, n, t) for p, n, _c, _b, t in gnu_tuples(g.stdout, two)],
            g.returncode)

    def context() -> str:
        r, wall, m = port_cli(["-C", "2", "volcano", *two])
        g = gnu(["-n", "-C", "2", "volcano", *two])
        return checked(f"-C 2 volcano ({both}, '--' separators)", r, wall,
                       m, "shift_and", port_tuples(r.stdout),
                       gnu_tuples(g.stdout, two), g.returncode)

    def byte_offsets() -> str:
        r, wall, m = port_cli(["-b", "-w", "volcano", *two])
        g = gnu(["-b", "-n", "-w", "volcano", *two])
        return checked(f"-b -w volcano ({both})", r, wall, m, "shift_and",
                       port_tuples(r.stdout),
                       gnu_tuples(g.stdout, two, boff=True), g.returncode)

    def stream(args, label) -> str:
        # standard input: the stream, through a pipe from cat
        cat = subprocess.Popen(["cat", str(stdin_file)],
                               stdout=subprocess.PIPE)
        try:
            r, wall, m = port_cli(args, stdin=cat.stdout,
                                  env=KERNELS_AT_EVERY_SIZE)
        finally:
            cat.stdout.close()
            cat.wait()
        with open(stdin_file, "rb") as f:
            g = gnu(["-n", *args], stdin=f)
        if "-c" in args:
            got, want = [r.stdout], [g.stdout]
        else:
            got = port_tuples(r.stdout)
            want = gnu_tuples(g.stdout, [], label=b"(standard input)")
        return checked(f"{label} ({stdin_file.stat().st_size >> 20} MiB, "
                       f"the stream)", r, wall, m, "shift_and", got, want,
                       g.returncode)

    def count_file() -> str:
        # the same count on the file, for its wall beside the stream's
        r, wall, m = port_cli(["-c", "volcano", stdin_file])
        g = gnu(["-c", "volcano", stdin_file])
        return checked("-c volcano FILE (the same file as a file)", r, wall,
                       m, "shift_and", [r.stdout], [g.stdout], g.returncode)

    def live_pipe() -> str:
        # -q over a live pipe: exits at the first selected line, the pipe
        # left open
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "grep",
             "-q", "volcano", "--metrics"], cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env={**os.environ, **KERNELS_AT_EVERY_SIZE})
        try:
            t0 = time.perf_counter()
            proc.stdin.write(b"ash\nthe volcano erupts\n")
            proc.stdin.flush()
            rc = proc.wait(timeout=120)
            wall = time.perf_counter() - t0
            out, err = proc.stdout.read(), proc.stderr.read()
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdin.close()
            proc.wait()
            proc.stdout.close()
            proc.stderr.close()
        return checked("-q volcano on a live pipe, left open (from the "
                       "write, interpreter start included)",
                       subprocess.CompletedProcess(proc.args, rc, out, err),
                       wall, cli_metrics("-q on a live pipe", rc, err),
                       "shift_and", [out], [b""], 0)

    runs = [only_o, context, byte_offsets,
            lambda: stream(["-c", "volcano", "-"], "cat FILE | -c volcano -"),
            lambda: stream(["volcano", "-"], "cat FILE | volcano -"),
            count_file, live_pipe]
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = [pool.submit(fn) for fn in runs]
        return [f.result() for f in futures]


# ------------------------------------------------------- the warm tiers
def recursive_batched_run(tree: Path, pats3: Path) -> str:
    """-r --include '*.txt' -F -f config 3 over the small-file tree, the
    CLI batching it (the small files share map tasks and packed windows):
    the same (file, line) rows and exit status as GNU grep; the run must
    have scanned packed windows, at least one of them on the card (past
    the small-input bound), with an FDR launch.  Returns its log line."""
    n_files = sum(1 for p in tree.rglob("*") if p.is_file())
    r, wall, m = port_cli(["-r", "--include", "*.txt", "-F", "-f", pats3,
                           tree])
    g = gnu(["-r", "-n", "--include", "*.txt", "-F", "-f", pats3, tree])
    got = sorted((p, n) for p, n, *_ in port_tuples(r.stdout))
    want = sorted((p, n) for p, n, *_ in gnu_tuples(
        g.stdout, sorted({ln.split(b":")[0].decode()
                          for ln in g.stdout.splitlines()})))
    eng, c, launches = m["engine"], m["counters"], m["launches"]
    on_card = (eng.get("batch_dispatches", 0) + eng.get("solo_dispatches", 0)
               - eng.get("small_host_scan", 0))
    if got != want or r.returncode != g.returncode:
        raise AssertionError(f"-r batched: exit {r.returncode} vs GNU "
                             f"{g.returncode}, {len(got)} vs {len(want)} "
                             f"rows")
    if not eng.get("batch_dispatches") or launches["fdr"] < 1 or on_card < 1:
        raise AssertionError(f"-r batched: no packed window on the card: "
                             f"engine {eng}, launches {launches}")
    secs = m["seconds"]
    return (f"CLI -r --include '*.txt' -F -f config3 ({n_files} files, "
            f"batched): exit {r.returncode}, {len(got)} rows equal to GNU "
            f"grep's; wall {wall:.3f} s (job {secs['cli_job']:.3f} s, print "
            f"{secs['cli_print']:.3f} s); map tasks {c['map_completed']}, "
            f"batch_dispatches {eng['batch_dispatches']}, solo_dispatches "
            f"{eng.get('solo_dispatches', 0)}, batched_files "
            f"{eng['batched_files']}, batch_fill_ratio "
            f"{eng['batch_fill_ratio']:.6f}, small_host_scan "
            f"{eng.get('small_host_scan', 0)}, segments "
            f"{eng.get('segments', 0)}; launches fdr {launches['fdr']}, "
            f"pairset {launches['pairset']}")


def small_input_runs(source: Path, work: Path) -> list[str]:
    """A file of about 600 KB (below the small-input bound, 1 MiB) through
    the CLI twice: with the default bound it scans on the host (stamped
    ``small_host_scan``, no launch), with the bound at 0 on the Shift-And
    kernel; both print the same bytes, GNU grep's rows."""
    data = source.read_bytes()[: 600 << 10]
    small = work / "small" / "small.txt"
    small.parent.mkdir(parents=True, exist_ok=True)
    small.write_bytes(data[: data.rfind(b"\n") + 1])
    g = gnu(["-n", "-i", "volcano", small])
    want = [(n, t) for _p, n, _c, _b, t in gnu_tuples(
        g.stdout, [], label=str(small).encode())]
    lines, outs = [], []
    for label, env in (("default bound", None),
                       ("bound 0", KERNELS_AT_EVERY_SIZE)):
        r, wall, m = port_cli(["-i", "volcano", small], env=env)
        got = [(n, t) for _p, n, _c, _b, t in port_tuples(r.stdout)]
        eng, launches = m["engine"], m["launches"]
        host = eng.get("small_host_scan", 0)
        route_ok = ((host >= 1 and not any(launches.values())) if env is None
                    else (not host and launches["shift_and"] >= 1))
        if got != want or r.returncode != g.returncode or not want \
                or not route_ok:
            raise AssertionError(f"small input, {label}: {len(got)} vs "
                                 f"{len(want)} rows, small_host_scan {host}, "
                                 f"launches {launches}")
        outs.append(r.stdout)
        lines.append(f"CLI -i volcano on {small.stat().st_size} bytes, "
                     f"{label}: {len(got)} rows equal to GNU grep's, "
                     f"small_host_scan {host}, launches shift_and "
                     f"{launches['shift_and']}, wall {wall:.3f} s (job "
                     f"{m['seconds']['cli_job']:.3f} s)")
    if outs[0] != outs[1]:
        raise AssertionError("small input: the host route and the kernel "
                             "printed different bytes")
    return lines


# many_small_files.py's file count in phase 3b.
MANY_SMALL_FILES = 500

# The corpus phase's budget: the word files cut in thirds (about 43 MiB,
# each padded to 44 MiB of stripes) take 1.03 GiB, past the card's
# default of 1 GiB.
CORPUS_PHASE_BYTES = 2 << 30


def cut_in_thirds(words: list[Path], split: Path) -> list[Path]:
    """The word files each cut in three at newlines, into ``split``: files
    of at most 64 MiB (one scan_file chunk each)."""
    pieces = []
    split.mkdir(parents=True, exist_ok=True)
    for w in words:
        data = w.read_bytes()
        cuts = [0, *(data.rfind(b"\n", 0, len(data) * k // 3) + 1
                     for k in (1, 2)), len(data)]
        for a, b in zip(cuts, cuts[1:]):
            if b - a > 64 << 20:
                raise AssertionError(f"corpus piece of {b - a} bytes")
            pieces.append(split / f"{w.stem}-{len(pieces):02d}.txt")
            pieces[-1].write_bytes(data[a:b])
        del data
    return pieces


def corpus_cache_runs(words: list[Path], work: Path, workers: int,
                      torch) -> list[str]:
    """Two run_jobs in this process over the word files each cut in three
    at newlines (files of at most 64 MiB: one scan_file chunk each, so
    each is cached) under a budget of CORPUS_PHASE_BYTES: the second must
    find every file's bytes and segments resident (hits, no file read, no
    upload) and write the same mr-out bytes; its count of lines equals
    GNU grep's."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module
    from distributed_grep_tpu_torch.ops import layout as layout_mod
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    split = work / "split"
    pieces = cut_in_thirds(words, split)
    with ThreadPoolExecutor(len(pieces)) as pool:
        want = sum(pool.map(lambda q: grep_oracle_count(q, ["-F", "volcano"]),
                            pieces))
    layout_mod.corpus_cache_clear()
    from distributed_grep_tpu_torch.ops import engine as engine_mod

    # a fresh engine, kept for both jobs
    grep_cuda._configured_with = None
    engine_mod.model_cache_clear()
    saved = os.environ.get("DGREP_CORPUS_BYTES")
    os.environ["DGREP_CORPUS_BYTES"] = str(CORPUS_PHASE_BYTES)
    runs = []
    for name in ("cold", "warm"):
        before = layout_mod.corpus_cache_counters()
        t0 = time.perf_counter()
        res = run_job(JobConfig(
            input_files=[str(q) for q in pieces],
            app_options={"pattern": "volcano"}, n_reduce=10,
            task_timeout_s=60.0, work_dir=str(work / f"corpus-{name}"),
            journal=False, durable=False),
            n_workers=workers, device="cuda", app=from_module(grep_cuda))
        wall = time.perf_counter() - t0
        totals = dict(grep_cuda._engine.totals)
        after = layout_mod.corpus_cache_counters()
        runs.append((res, wall, totals, grep_cuda._engine,
                     {k: after.get(k, 0) - before.get(k, 0) for k in after}))
    if saved is None:
        os.environ.pop("DGREP_CORPUS_BYTES", None)
    else:
        os.environ["DGREP_CORPUS_BYTES"] = saved
    (cold, cold_wall, ct, ceng, cc), (warm, warm_wall, wt, weng, wc) = runs
    outs = [{Path(p).name: Path(p).read_bytes() for p in r.output_files}
            for r in (cold, warm)]
    n_out = sum(v.count(b"\n") for v in outs[0].values())

    def delta(k):
        return wt.get(k, 0) - ct.get(k, 0)

    n = len(pieces)
    resident = layout_mod.corpus_cache_counters()[
        "corpus_cache_bytes_resident"]
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    if (ceng is not weng or outs[0] != outs[1] or n_out != want
            or ct.get("file_reads") != n or ct.get("uploads", 0) < n
            or cc.get("corpus_cache_misses") != n
            or delta("file_reads") or delta("uploads")
            or delta("resident_segments") != ct["uploads"]
            or wc.get("corpus_cache_hits") != n
            or wc.get("corpus_cache_host_hits") != n):
        raise AssertionError(
            f"corpus cache: outputs equal {outs[0] == outs[1]}, {n_out} vs "
            f"GNU grep's {want} lines; cold totals {ct}; warm totals {wt}; "
            f"cache cold {cc}, warm {wc}")
    layout_mod.corpus_cache_clear()
    shutil.rmtree(split, ignore_errors=True)
    return [
        f"corpus cache, 'volcano' over {n} files of at most 64 MiB: cold job "
        f"{cold_wall:.3f} s ({ct['file_reads']} file reads, "
        f"{ct['uploads']} segment uploads, {cc['corpus_cache_misses']} "
        f"misses), warm job {warm_wall:.3f} s ({delta('file_reads')} file "
        f"reads, {delta('uploads')} uploads, {delta('resident_segments')} "
        f"resident segments, {wc['corpus_cache_hits']} hits, "
        f"{wc['corpus_cache_host_hits']} host hits), warm/cold "
        f"{warm_wall / cold_wall:.3f}; mr-out bytes equal, {n_out} lines = "
        f"GNU grep's count; resident {resident} bytes of the card's "
        f"{card_bytes} ({resident / card_bytes:.4f}; budget "
        f"{CORPUS_PHASE_BYTES})"]


class TimedBytes:
    """A binary stdout that stamps each write with the clock (the
    follow's print times)."""

    def __init__(self):
        import io

        self.buf = io.BytesIO()
        self.writes: list[tuple[float, bytes]] = []

    def write(self, b) -> int:
        self.writes.append((time.perf_counter(), bytes(b)))
        return self.buf.write(b)

    def __getattr__(self, name):
        return getattr(self.buf, name)


def follow_run(words: list[Path], work: Path, counters: dict) -> str:
    """``grep --follow --follow-idle-s 2 volcano`` in this process over a
    16 MiB word file while a thread appends eight slices of 1-2 MiB of
    another word file (each ending in a marker line, the last without its
    '\n'), the small-input bound at 0 so every suffix scan runs the
    kernel: the printed bytes equal a one-shot CLI run over the final
    file, its rows GNU grep's; logs each marker's latency from its
    append to its print."""
    import numpy as np

    base = words[0].read_bytes()[: 16 << 20]
    path = work / "follow" / "grow.log"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(base[: base.rfind(b"\n") + 1])
    src = words[1].read_bytes()[: 24 << 20]
    rng = np.random.default_rng(7)
    appends, pos = [], 0
    for k in range(8):
        end = src.find(b"\n", pos + int(rng.integers(1 << 20, 2 << 20))) + 1
        marker = b"volcano follow marker %d" % k
        appends.append((marker, src[pos:end] + marker
                        + (b"" if k == 7 else b"\n")))
        pos = end
    stamps: dict[bytes, float] = {}

    def appender():
        time.sleep(1.0)
        for marker, chunk in appends:
            with open(path, "ab") as f:
                f.write(chunk)
            stamps[marker] = time.perf_counter()
            time.sleep(0.3)

    before = {k: m.launches for k, m in counters.items()}
    saved = os.environ.get("DGREP_DEVICE_MIN_BYTES")
    os.environ.update(KERNELS_AT_EVERY_SIZE)
    out = TimedBytes()
    t = threading.Thread(target=appender)
    t.start()
    try:
        rc, got, err, wall = port_cli_in_process(
            ["grep", "--follow", "--follow-idle-s", "2", "volcano",
             str(path)], out=out)
    finally:
        t.join()
        if saved is None:
            os.environ.pop("DGREP_DEVICE_MIN_BYTES", None)
        else:
            os.environ["DGREP_DEVICE_MIN_BYTES"] = saved
    launched = {k: m.launches - before[k] for k, m in counters.items()}
    rc1, once, _err, once_wall = port_cli_in_process(
        ["grep", "volcano", str(path)])
    g = gnu(["-n", "volcano", path])
    want = [(n, t_) for _p, n, _c, _b, t_ in gnu_tuples(
        g.stdout, [], label=str(path).encode())]
    rows = [(n, t_) for _p, n, _c, _b, t_ in port_tuples(got)]
    latency = []
    for marker, _chunk in appends:
        printed = next((ts for ts, b in out.writes if marker in b), None)
        if printed is None:
            raise AssertionError(f"follow: {marker!r} never printed")
        latency.append(printed - stamps[marker])
    # the last append's marker has no '\n': it is carried until the idle
    # exit's final poll, so its latency is the idle wait, not the poll's
    tail_latency = latency.pop()
    if (rc != 0 or got != once or rows != want or launched["shift_and"] < 1
            or rc1 != 0):
        raise AssertionError(
            f"follow: exit {rc}, {len(rows)} rows vs one-shot "
            f"{len(port_tuples(once))} and GNU {len(want)}, launches "
            f"{launched}; stderr {err[-400:]!r}")
    return (f"--follow --follow-idle-s 2 volcano over {path.stat().st_size} "
            f"bytes (16 MiB, then 8 appends of 1-2 MiB, the last without its "
            f"newline): exit {rc}, {len(rows)} rows equal to the one-shot "
            f"run's ({once_wall:.3f} s) and GNU grep's; wall {wall:.3f} s; "
            f"launches shift_and {launched['shift_and']}; latency from "
            f"append to print {min(latency):.3f}-{max(latency):.3f} s, mean "
            f"{sum(latency) / len(latency):.3f} s over the 7 terminated "
            f"appends (poll {os.environ.get('DGREP_FOLLOW_POLL_S', '0.5')} "
            f"s); the unterminated tail {tail_latency:.3f} s (the idle exit)")


def symbol_masks(pattern: str, ic: bool):
    """(m, 256) bool: the byte set of each symbol of a literal / bracket
    sequence (single characters and '[...]' lists of single characters,
    the forms of APPROX_QUERIES), both cases with ``ic``."""
    import numpy as np

    sets, i = [], 0
    while i < len(pattern):
        if pattern[i] == "[":
            j = pattern.index("]", i)
            sets.append(pattern[i + 1 : j])
            i = j + 1
        else:
            sets.append(pattern[i])
            i += 1
    masks = np.zeros((len(sets), 256), dtype=bool)
    for j, chars in enumerate(sets):
        for ch in chars:
            for c in {ch, ch.lower(), ch.upper()} if ic else {ch}:
                masks[j, ord(c)] = True
    return masks


def sellers_match(lines: list[bytes], masks, k: int):
    """Per line: does some substring match the symbol sequence ``masks``
    within k edits?  Sellers' edit-distance DP (free start and end in the
    text), vectorized over lines sorted by length in blocks, one numpy step
    per text column; the column's deletion chain is a running minimum:
    D[j] = j + min over i <= j of (T[i] - i), T the substitution /
    insertion candidates and T[0] = 0.  Independent of the port's
    bit-parallel recurrence."""
    import numpy as np

    m = masks.shape[0]
    lens = np.fromiter((len(x) for x in lines), dtype=np.int64,
                       count=len(lines))
    order = np.argsort(lens, kind="stable")
    out = np.zeros(len(lines), dtype=bool)
    jcol = np.arange(m + 1, dtype=np.int16)[:, None]
    for lo in range(0, len(lines), 65536):
        sel = order[lo : lo + 65536]
        ln = lens[sel]
        width = max(int(ln.max()), 1)
        mat = np.zeros((sel.size, width), dtype=np.uint8)
        flat = np.frombuffer(b"".join(lines[i] for i in sel.tolist()),
                             np.uint8)
        rows = np.repeat(np.arange(sel.size), ln)
        cols = np.arange(flat.size) - np.repeat(np.cumsum(ln) - ln, ln)
        mat[rows, cols] = flat
        prev = np.repeat(jcol, sel.size, axis=1)  # D[0][j] = j
        best = np.full(sel.size, m, dtype=np.int16)
        for c in range(width):
            miss = ~masks[:, mat[:, c]]  # (m, n): symbol j-1 misses
            t = np.minimum(prev[:-1] + miss, prev[1:] + 1) - jcol[1:]
            cur = jcol + np.minimum.accumulate(
                np.vstack((np.zeros((1, sel.size), np.int16), t)), axis=0)
            live = c < ln
            best[live] = np.minimum(best[live], cur[m, live])
            prev = cur
        out[sel] = best <= k
    return out


def approx_oracle_lines(path: Path, pattern: str, k: int, ic: bool,
                        pieces: list[str]) -> list[tuple[int, str]]:
    """The approx queries' oracle: ``LC_ALL=C grep -na -E`` over the
    pattern's k+1 pieces (with -i) picks the lines that can match, and
    Sellers' DP (``sellers_match``) keeps those within k edits.  (line
    number, line) pairs, decoded as the grep app decodes them."""
    args = ["-E", *(["-i"] if ic else [])]
    for p in pieces:
        args += ["-e", p]
    if shutil.which("grep") is None:
        raise RuntimeError("grep not found: it is the prefilter of the "
                           "approx oracle")
    out = subprocess.run(["grep", "-na", *args, str(path)],
                         capture_output=True, timeout=900,
                         env={**os.environ, "LC_ALL": "C"})
    if out.returncode > 1:
        raise RuntimeError(f"grep prefilter failed: {out.stderr[:300]!r}")
    raw = out.stdout.split(b"\n")
    if raw and not raw[-1]:
        raw.pop()
    nums, texts = [], []
    for ln in raw:
        num, _, text = ln.partition(b":")
        nums.append(int(num))
        texts.append(text)
    keep = sellers_match(texts, symbol_masks(pattern, ic), k)
    return [(n, t.decode("utf-8", "replace"))
            for n, t, ok in zip(nums, texts, keep.tolist()) if ok]


def job_lines(res) -> dict[str, list[tuple[int, str]]]:
    marker = " (line number #"
    out: dict[str, list] = {}
    for k, v in res.iter_results():
        i = k.rfind(marker)
        out.setdefault(k[:i], []).append((int(k[i + len(marker) : -1]), v))
    for lst in out.values():
        lst.sort()
    return out


# -------------------------------------------------------------- phases
def phase_kernels(torch, np, cuda_scan, sa_mod) -> int:
    """Kernel words vs the plain version's, bit for bit.  Returns the
    largest absolute difference seen (0 or the script has failed)."""
    from distributed_grep_tpu_torch.ops.layout import choose_layout, to_device_array

    rng = np.random.default_rng(1234)
    full = sa_mod.try_compile_shift_and("volcano")
    models = {
        "volcano": full,
        "volcano-filter": sa_mod.filtered_for_device(full),
        "-i Volcano": sa_mod.try_compile_shift_and("Volcano", ignore_case=True),
        "h[ae]llo": sa_mod.try_compile_shift_and("h[ae]llo"),
        "32 classes": sa_mod.try_compile_shift_and("[a-z ]" * 32),
    }
    assert all(m is not None for m in models.values())
    # (chunk, lanes): the reference tile shape, the main path's 64 MB
    # segment shape, and a small multi-word layout
    shapes = [(512, 4096), (1024, 65536), (160, 64)]
    worst = 0
    for chunk, lanes in shapes:
        text = words_block(rng, chunk * lanes)
        for p in rng.choice(text.size - 40, size=max(4, text.size // 20000),
                            replace=False).tolist():
            text[p : p + 7] = np.frombuffer(b"volcano", np.uint8)
            text[p + 20 : p + 25] = np.frombuffer(b"hallo", np.uint8)
        lay = choose_layout(text.size, target_lanes=lanes, min_chunk=chunk,
                            lane_multiple=32, chunk_multiple=32)
        assert (lay.chunk, lay.lanes) == (chunk, lanes), lay
        arr = to_device_array(text.tobytes(), lay)
        if chunk == 160:
            # a match ending across a word edge: bytes 29..35 of stripe 3
            arr[29:36, 3] = np.frombuffer(b"volcano", np.uint8)
        # the stripes; the plain version runs on the card beside the kernel
        # (on the CPU it took most of these checks' time)
        dev = torch.from_numpy(np.ascontiguousarray(arr.T)).cuda()
        for name, model in models.items():
            for coarse in (True, False):
                got = cuda_scan.shift_and_scan_words(dev, model, coarse)
                torch.cuda.synchronize()
                want = cuda_scan.shift_and_scan_words_plain(dev, model, coarse)
                g = got.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                w = want.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                err = int((g - w).abs().max())
                worst = max(worst, err)
                nz = int(torch.count_nonzero(w))
                if not torch.equal(got, want) or err:
                    raise AssertionError(
                        f"kernel != plain: {name} coarse={coarse} "
                        f"chunk={chunk} lanes={lanes} max_abs_err={err}")
                log(f"  ok {name:15s} coarse={int(coarse)} chunk={chunk:5d} "
                    f"lanes={lanes:6d} nonzero words={nz}")
    return worst


def nfa_models(nfa_mod) -> dict:
    """The NFA kernel's phase-2 models: 1 to 4 state words, '^', and many
    specials."""
    models = {
        "config4 filter -i": nfa_mod.compile_scan_model(CONFIG4, True)[0],
        "config4 exact -i": nfa_mod.try_compile_glushkov(CONFIG4, True),
        "config2 alternation": nfa_mod.try_compile_glushkov(CONFIG2),
        "4-word alternation": nfa_mod.try_compile_glushkov(
            "(" + "|".join(WIDE_WORDS) + ")"),
        "^anchor": nfa_mod.try_compile_glushkov("^anchor"),
        "a[bc]{40,90}d": nfa_mod.try_compile_glushkov("a[bc]{40,90}d"),
    }
    words = {k: m.n_words for k, m in models.items()}
    assert words == {"config4 filter -i": 1, "config4 exact -i": 2,
                     "config2 alternation": 2, "4-word alternation": 4,
                     "^anchor": 1, "a[bc]{40,90}d": 3}, words
    assert models["a[bc]{40,90}d"].n_specials == 51
    return models


def phase_nfa_kernels(torch, np, nfa_scan, nfa_mod) -> int:
    """NFA kernel words vs the plain version's (run on the card), bit for
    bit.  Returns the largest absolute difference seen."""
    from distributed_grep_tpu_torch.ops.layout import choose_layout, to_device_array

    rng = np.random.default_rng(4321)
    models = nfa_models(nfa_mod)
    plants = [b"volcano", b"anarchism", b"labyrinth", b"xylophone",
              b"GET /images/KSC-small.gif", b"get /icons/menu.gif",
              b"GET /a/b.gif", b"a" + b"bc" * 30 + b"d", b"\nanchor"]
    worst = 0
    for chunk, lanes in [(512, 4096), (1024, 65536), (160, 64)]:
        text = words_block(rng, chunk * lanes)
        for p in rng.choice(text.size - 80, size=max(16, text.size // 2000),
                            replace=False).tolist():
            nd = plants[p % len(plants)]
            text[p : p + len(nd)] = np.frombuffer(nd, np.uint8)
        lay = choose_layout(text.size, target_lanes=lanes, min_chunk=chunk,
                            lane_multiple=32, chunk_multiple=32)
        assert (lay.chunk, lay.lanes) == (chunk, lanes), lay
        arr = to_device_array(text.tobytes(), lay)
        # stripe heads: 'anchor' at every 5th stripe start (a line start to
        # the kernel), and a match ending across a word edge
        arr[0:6, ::5] = np.frombuffer(b"anchor", np.uint8)[:, None]
        arr[29:36, 3] = np.frombuffer(b"volcano", np.uint8)
        dev = torch.from_numpy(arr).cuda()
        for name, model in models.items():
            got = nfa_scan.nfa_scan_words(dev, model)
            torch.cuda.synchronize()
            want = nfa_scan.nfa_scan_words_plain(dev, model)
            g = got.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            w = want.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            err = int((g - w).abs().max())
            worst = max(worst, err)
            nz = int(torch.count_nonzero(w))
            if not torch.equal(got, want) or err:
                raise AssertionError(
                    f"nfa kernel != plain: {name} chunk={chunk} lanes={lanes} "
                    f"max_abs_err={err}")
            if name == "^anchor" and not nz:
                raise AssertionError("no '^anchor' match in the phase-2 text")
            log(f"  ok nfa {name:20s} chunk={chunk:5d} lanes={lanes:6d} "
                f"words={model.n_words} specials={model.n_specials:3d} "
                f"nonzero words={nz}")
    return worst


# The card-side differential sweep of the two table-driven kernels
# (csrc/nfa.cu, csrc/fdr.cu): seeded random models, each held to its plain
# version bit for bit at chunk 32 and 64 over 32 lanes, and a subset at
# the main path's 64 MB segment (the plain NFA version's cost grows with
# the specials: about 1400 small launches a step at 128).
SWEEP_SMALL = [(32, 32), (64, 32)]
# the depth of two phase-2 sweeps: random NFA models a width (1-4 state
# words; 6 until phase 3c came, 3 until phase 3f came) and random
# table-DFA regexes (24 until phase 3c came, 12 until phase 3f came, 6
# until phase 3g came)
NFA_SWEEP_PER_WIDTH = 1
DFA_SWEEP_TABLES = 3
# (chunk, lanes) of the table DFA's forced sub-stripe and no-meeting draws:
# 8 words, so every count up to 8 applies
DFA_FIXUP_SHAPE = (256, 64)
SWEEP_SEGMENT = (1024, 65536)
SWEEP_ALPHABET = "abcxyz"
# 'Z' then 127 starred letters: 128 positions over 4 words, all specials
ALL_SPECIALS = "Z" + "".join(f"{chr(97 + i % 26)}*" for i in range(127))


def dfa_regexes(dfa_mod, seed: int, n: int) -> list:
    """``n`` seeded random tables: ``rand_regex`` draws over
    SWEEP_ALPHABET, half of them ending in '$', some with a leading '^' or
    a nullable body (the '^$'-style accepts at a line's end), compiled
    with ``compile_dfa``: [(pattern, table, sample)]."""
    import numpy as np

    from distributed_grep_tpu_torch.models.dfa import RegexError

    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        parts = [rand_regex(rng) for _ in range(int(rng.integers(1, 5)))]
        pattern = "".join(p for p, _ in parts)
        if rng.random() < 0.5:
            pattern += "$"
        if rng.random() < 0.2:
            pattern = "^" + pattern
        if rng.random() < 0.1:
            pattern = f"({pattern})?$"
        try:
            table = dfa_mod.compile_dfa(pattern)
        except RegexError:  # past the state budget, or refused
            continue
        out.append((pattern, table,
                    lambda r, parts=parts: "".join(f(r) for _, f in parts)))
    return out


def phase_dfa_kernels(torch, np, dfa_scan, dfa_mod, aho_mod,
                      seed: int) -> tuple[int, int]:
    """The table-DFA kernel (csrc/dfa.cu) against its plain version, bit
    for bit: at the main path's 64 MB segment shape (65536 x 1024
    stripes, words text with 'needle', 'net' and config 3's members
    planted) for 'nee(dle|t)', three '$' patterns, '^$' and two
    Aho-Corasick banks (config 3's 1,000 members, past the shared-memory
    budget; 256 kernel_compare members, its class map and entries in
    shared memory); then a seeded sweep of random
    regex tables ('$' accepts, '^', nullable bodies) and small
    Aho-Corasick banks at 32 x 32 and 64 x 32 and, every 8th table, at the
    segment shape; every third stripe's last byte is not '\\n' (the
    stripe-tail rule), and half the draws read pitched stripes; both table
    branches must run (shared memory, byte-indexed or not, and the L2).
    Then one draw at each forced sub-stripe count and the draws whose
    fix-ups never meet (DFA_FIXUP_SHAPE).  Returns (K1 draws, the largest
    absolute difference, K2 draws, its largest)."""
    from distributed_grep_tpu_torch.benchmarks.kernel_compare import (
        aho_members,
    )
    from distributed_grep_tpu_torch.ops.layout import Layout, to_device_array

    rng = np.random.default_rng(seed)
    branches = {"shared": 0, "global": 0}
    stride_branches = {"shared": 0, "global": 0}
    worst = draws = stride_worst = stride_draws = 0

    def check(label: str, table, arr, pitched: bool,
              stride: bool = True) -> int:
        nonlocal worst, draws
        chunk, lanes = arr.shape
        arr = arr.copy()
        arr[-1, ::3] = ord("e")  # stripes whose last byte is not '\n'
        st = torch.from_numpy(np.ascontiguousarray(arr.T)).cuda()
        if pitched:
            wide = torch.full((lanes, chunk + 32), 0x0A, dtype=torch.uint8,
                              device=st.device)
            wide[:, :chunk] = st
            st = wide[:, :chunk]
        got, got_exits = dfa_scan.dfa_scan_words(st, table, with_exits=True)
        torch.cuda.synchronize()
        want, want_exits = dfa_scan.dfa_scan_words_plain(st, table,
                                                         with_exits=True)
        err = words_err(torch, got, want)
        worst = max(worst, err)
        draws += 1
        branches["global" if dfa_scan.launch_plan(table, lanes, chunk)[1]
                 == "global" else "shared"] += 1
        if not torch.equal(got, want) or err:
            raise AssertionError(
                f"dfa kernel != plain: {label} chunk={chunk} lanes={lanes} "
                f"pitched={pitched} max_abs_err={err}")
        if not torch.equal(got_exits, want_exits):
            raise AssertionError(f"dfa kernel exit states != plain: {label} "
                                 f"chunk={chunk} lanes={lanes}")
        if stride:
            check_stride(label, table, st, want)
        return int(torch.count_nonzero(want.view(torch.int32)))

    def check_stride(label: str, table, st, k1_words) -> None:
        """K2 at k = 2 and 4 where choose_stride's caps allow the stride,
        against its plain version and K1's words, bit for bit."""
        nonlocal stride_worst, stride_draws
        if table.accept_eol.any():
            return
        for k in (2, 4):
            cols = table.n_classes ** k
            if cols > 1 << 13 or table.n_states * cols > 1 << 23:
                continue
            stt = dfa_mod.build_stride_table(table, k)
            got = dfa_scan.dfa_stride_words(st, stt)
            torch.cuda.synchronize()
            want = dfa_scan.dfa_stride_words_plain(st, stt)
            err = max(words_err(torch, got, want),
                      words_err(torch, got, k1_words))
            stride_worst = max(stride_worst, err)
            stride_draws += 1
            stride_branches[dfa_scan.stride_launch_plan(
                stt, st.shape[0], st.shape[1])[1]] += 1
            if err or not torch.equal(got, want):
                raise AssertionError(
                    f"dfa stride kernel (k={k}) != plain or K1: {label} "
                    f"shape={tuple(st.shape)} max_abs_err={err}")

    chunk, lanes = SWEEP_SEGMENT
    text = words_block(rng, chunk * lanes)
    set3 = config3_set()
    needles = [b"needle", b"net", b"the end", *set3[:200]]
    put(text, rng.choice(text.size - 24, size=text.size // 2000,
                         replace=False), needles)
    seg = to_device_array(text.tobytes(), Layout(lanes=lanes, chunk=chunk,
                                                 n_real=text.size))
    fixed = {
        "nee(dle|t)": dfa_mod.compile_dfa("nee(dle|t)"),
        "the$": dfa_mod.compile_dfa("the$"),
        "^(of|the) [a-z]+$": dfa_mod.compile_dfa("^(of|the) [a-z]+$"),
        "o?$": dfa_mod.compile_dfa("o?$"),
        "^$": dfa_mod.compile_dfa("^$"),
        "config 3 bank": aho_mod.compile_aho_corasick(set3),
        "aho256 bank": aho_mod.compile_aho_corasick(aho_members(256)),
    }
    for i, (name, table) in enumerate(fixed.items()):
        nz = check(name, table, seg, pitched=bool(i % 2))
        log(f"  ok dfa {name:20s} chunk={chunk} lanes={lanes} states="
            f"{table.n_states} classes={table.n_classes} plan "
            f"{dfa_scan.launch_plan(table, lanes, chunk)} nonzero "
            f"words={nz}")
    if not (branches["shared"] and branches["global"]):
        raise AssertionError(f"dfa: a table branch not exercised {branches}")
    tables = dfa_regexes(dfa_mod, seed, DFA_SWEEP_TABLES)
    for k in range(8):  # small Aho-Corasick banks over the same alphabet
        members = rand_literals(
            int(rng.integers(1, 40)), 1, 6, seed=seed + k,
            alphabet=np.frombuffer(SWEEP_ALPHABET.encode(), np.uint8))
        banks = aho_mod.compile_aho_corasick_banks(
            members, max_states_per_bank=int(rng.integers(8, 200)))
        for b in banks:
            tables.append((f"aho bank of {len(members)}", b,
                           lambda r, m=members: m[int(r.integers(0, len(m)))]))
    for i, (name, table, sample) in enumerate(tables):
        samples = [sample(rng)[:100] for _ in range(8)] + ["a"]
        shapes = SWEEP_SMALL + ([SWEEP_SEGMENT] if i % 8 == 0 else [])
        for ch, ln in shapes:
            # K2 at the small shapes (the fixed tables hold it at the
            # segment's)
            check(name, table, sweep_text(rng, ch, ln, samples, False),
                  pitched=bool(i % 2), stride=(ch, ln) != SWEEP_SEGMENT)
    log(f"  dfa sweep: {len(tables)} random tables, {draws} draws in all "
        f"(table in shared memory {branches['shared']}, read through the "
        f"L2 {branches['global']}), each with its exit states; K2 (k = 2, "
        f"4 where the caps allow) {stride_draws} draws (composed table in "
        f"shared memory {stride_branches['shared']}, through the L2 "
        f"{stride_branches['global']})")
    if not (stride_branches["shared"] and stride_branches["global"]):
        raise AssertionError(f"dfa stride: a table branch not exercised "
                             f"{stride_branches}")
    # one draw at each forced sub-stripe count, then draws whose fix-ups
    # never meet their speculative walk: '^a*b' over stripes of 'x' and
    # 'a's with no '\n', on every K1 branch and K2 (on 'a*b'); each held
    # to the plain version, its fix-up rounds counted
    chunk, lanes = DFA_FIXUP_SHAPE
    rounds_seen = []
    for i, n_sub in enumerate((1, 2, 4, 8)):
        name, table, sample = tables[i % len(tables)]
        arr = sweep_text(rng, chunk, lanes, [sample(rng)[:100] for _ in
                                             range(8)] + ["a"], False)
        st = torch.from_numpy(np.ascontiguousarray(arr.T)).cuda()
        got = dfa_scan.dfa_scan_words(st, table, True, n_sub=n_sub)
        want = dfa_scan.dfa_scan_words_plain(st, table, True)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"dfa kernel != plain at n_sub={n_sub}: "
                                 f"{name}")
        draws += 1
    never = np.full((lanes, chunk), ord("a"), dtype=np.uint8)
    never[:, 0] = ord("x")
    never[5, 100] = ord("b")
    st = torch.from_numpy(never).cuda()
    anchored = dfa_mod.compile_dfa("^a*b")
    want = dfa_scan.dfa_scan_words_plain(st, anchored, True)
    for n_sub in (2, 4, 8):
        for branch in dfa_scan.BRANCHES:
            fx = torch.zeros(2, dtype=torch.int64, device=st.device)
            got = dfa_scan.dfa_scan_words(st, anchored, True, n_sub=n_sub,
                                          branch=branch, fixups=fx)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"dfa kernel != plain on stripes that "
                                     f"never meet: n_sub={n_sub} {branch}")
            if int(fx[1]) != n_sub - 1:
                raise AssertionError(f"dfa fix-up rounds {fx.tolist()} at "
                                     f"n_sub={n_sub} {branch}: want "
                                     f"{n_sub - 1}")
            rounds_seen.append(int(fx[1]))
            draws += 1
    unanchored = dfa_mod.build_stride_table(dfa_mod.compile_dfa("a*b"), 2)
    want = dfa_scan.dfa_stride_words_plain(st, unanchored)
    for n_sub in (2, 8):
        for branch in ("shared", "global"):
            got = dfa_scan.dfa_stride_words(st, unanchored, n_sub=n_sub,
                                            branch=branch)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"dfa stride kernel != plain on 'a*b': "
                                     f"n_sub={n_sub} {branch}")
            stride_draws += 1
    log(f"  dfa forced sub-stripe counts 1, 2, 4, 8 and no-meeting draws "
        f"(fix-up rounds {rounds_seen}) at chunk={chunk} lanes={lanes}: "
        f"exact")
    return draws, worst, stride_draws, stride_worst


def host_block(rng, n_bytes: int):
    """Word lines of 0..23 words (``words_block``'s recipe, with 'ab',
    'abab', 'xy', 'o' and a one-space word added), so about 1 line in 24
    is empty and some hold only spaces; exactly n_bytes bytes, the last
    line without its '\\n'."""
    import numpy as np

    words = [w.encode() for w in _WORDS] + [b"ab", b"abab", b"xy", b"o",
                                            b" "]
    vocab = words + [b"", b" ", b"\n"]
    n_lines = n_bytes // 36 + 16
    per_line = rng.integers(0, 24, size=n_lines)
    empty = per_line == 0
    per_line[empty] = 1
    idx = rng.integers(0, len(words), size=int(per_line.sum()))
    ends = np.cumsum(per_line) - 1
    idx[ends[empty]] = len(words)  # the empty word: a line of nothing
    sep = np.full(idx.size, len(words) + 1, dtype=np.int64)
    sep[ends] = len(words) + 2
    out = gather_tokens(vocab, np.stack([idx, sep], axis=1).reshape(-1))
    if out.size < n_bytes:
        raise RuntimeError("host block estimate too small")
    return out[:n_bytes]


# The host-route queries of phase 3: (label, the port CLI's arguments,
# GNU grep's, the route the engine must take).  '^$'-style patterns run on
# the host DFA scanner, backreferences on the host re loop, a set too
# dense for both set kernels on the scanner over its Aho-Corasick banks.
HOST_QUERIES = [
    ("^$", ["^$"], ["-n", "-e", "^$"], "native"),
    ("-c '^ *$'", ["-c", "^ *$"], ["-c", "-e", "^ *$"], "native"),
    ("-c '(ab)*$'", ["-c", "(ab)*$"], ["-c", "-E", "-e", "(ab)*$"], "native"),
    ("^(ab)*$", ["^(ab)*$"], ["-n", "-E", "-e", "^(ab)*$"], "native"),
    (r"-E '(the) \1'", ["-E", r"(the) \1"], ["-n", "-E", "-e", r"(the) \1"],
     "re"),
    ("-F -e ' ' -e xy", ["-F", "-e", " ", "-e", "xy"],
     ["-n", "-F", "-e", " ", "-e", "xy"], "native"),
    (r"-w -E '(the) \1'", ["-w", "-E", r"(the) \1"],
     ["-n", "-w", "-E", "-e", r"(the) \1"], "re"),
    ("-v -c '^$'", ["-v", "-c", "^$"], ["-v", "-c", "-e", "^$"], "native"),
    ("--backend cpu -E 'abab (of|the)$'",
     ["--backend", "cpu", "-E", "abab (of|the)$"],
     ["-n", "-E", "-e", "abab (of|the)$"], "native"),
]


def port_cli_in_process(argv: list[str], out=None
                        ) -> tuple[int, bytes, bytes, float]:
    """The port CLI's main(argv) in this process, standard output and
    error captured (standard output into ``out``, a BytesIO, when given):
    (exit status, stdout, stderr, wall seconds)."""
    import io

    from distributed_grep_tpu_torch.__main__ import main as port_main

    out, err = out if out is not None else io.BytesIO(), io.BytesIO()
    saved = sys.stdout, sys.stderr
    wrappers = (io.TextIOWrapper(out, write_through=True),
                io.TextIOWrapper(err, write_through=True))
    sys.stdout, sys.stderr = wrappers
    t0 = time.perf_counter()
    try:
        rc = port_main(argv)
    finally:
        wall = time.perf_counter() - t0
        sys.stdout, sys.stderr = saved
        for w in wrappers:
            w.flush()
            w.detach()  # the buffers stay open
    return rc, out.getvalue(), err.getvalue(), wall


def host_query_runs(path: Path, work: Path, counters: dict) -> list[str]:
    """Each HOST_QUERIES query through the port CLI (in this process, with
    --metrics) on ``path`` against ``LC_ALL=C grep -a`` with the matching
    flags: the same exit status and the same (line number, line) rows, or
    the same count; the route in --metrics must be the query's, and no
    kernel may launch.  GNU grep's runs go side by side first.  Returns a
    log line a query: route, host_scan_seconds, wall."""
    with ThreadPoolExecutor(len(HOST_QUERIES)) as pool:
        oracles = list(pool.map(lambda q: gnu([*q[2], path]), HOST_QUERIES))
    lines = []
    for (label, args, gargs, route), want in zip(HOST_QUERIES, oracles):
        before = {k: m.launches for k, m in counters.items()}
        rc, out, err, wall = port_cli_in_process(
            ["grep", *args, str(path), "--metrics", "--work-dir",
             str(work / "host-query")])
        metrics = cli_metrics(label, rc, err)
        launched = {k: m.launches - before[k] for k, m in counters.items()}
        if "-c" in gargs:
            got_rows, want_rows = out, want.stdout
        else:
            got_rows = [(n, text) for _p, n, _c, _b, text in port_tuples(out)]
            want_rows = [(n, text) for _p, n, _c, _b, text in gnu_tuples(
                want.stdout, [path], label=str(path).encode())]
        if (rc != want.returncode or got_rows != want_rows
                or metrics.get("route") != route or any(launched.values())):
            raise AssertionError(
                f"host query {label}: exit {rc} vs GNU grep "
                f"{want.returncode}, rows equal {got_rows == want_rows}, "
                f"route {metrics.get('route')} (want {route}), launches "
                f"{launched}; stderr {err[-400:]!r}")
        eng = metrics.get("engine", {})
        n = (int(out) if "-c" in gargs else len(got_rows))
        lines.append(
            f"host query {label} ({path.stat().st_size} bytes): exit {rc}, "
            f"{n} {'count' if '-c' in gargs else 'rows'} equal to GNU "
            f"grep's; route {metrics['route']}, host_scan_seconds "
            f"{eng.get('host_scan_seconds', 0.0):.3f}, end_offsets "
            f"{eng.get('end_offsets', 0)}, wall {wall:.3f} s (job "
            f"{metrics['seconds']['cli_job']:.3f} s, print "
            f"{metrics['seconds']['cli_print']:.3f} s), no kernel launched")
    return lines


def rand_regex(rng, depth: int = 0):
    """(pattern, sample): a random regex over SWEEP_ALPHABET and a function
    of an rng that draws one string the regex matches."""
    kind = int(rng.integers(0, 8 if depth < 3 else 2))
    if kind == 0:
        c = str(rng.choice(list(SWEEP_ALPHABET)))
        return c, lambda r: c
    if kind == 1:
        chars = sorted(set(rng.choice(list(SWEEP_ALPHABET), size=3).tolist()))
        return "[" + "".join(chars) + "]", lambda r: str(r.choice(chars))
    if kind in (2, 3):
        parts = [rand_regex(rng, depth + 1)
                 for _ in range(int(rng.integers(2, 6)))]
        return ("".join(p for p, _ in parts),
                lambda r: "".join(f(r) for _, f in parts))
    inner, f = rand_regex(rng, depth + 1)
    if kind == 4:
        alts = [(inner, f)] + [rand_regex(rng, depth + 1)
                               for _ in range(int(rng.integers(1, 3)))]
        return ("(" + "|".join(p for p, _ in alts) + ")",
                lambda r: alts[int(r.integers(0, len(alts)))][1](r))
    if kind == 5:
        return f"({inner})?", lambda r: f(r) if r.integers(0, 2) else ""
    if kind == 6:
        lo = int(rng.integers(0, 2))
        return (f"({inner}){'*+'[lo]}",
                lambda r: "".join(f(r) for _ in range(lo + int(r.integers(0, 3)))))
    lo = int(rng.integers(0, 4))
    hi = lo + int(rng.integers(0, 40))
    return (f"({inner}){{{lo},{hi}}}",
            lambda r: "".join(f(r) for _ in range(int(r.integers(lo, hi + 1)))))


def sweep_regexes(nfa_mod, seed: int, per_words: int) -> list:
    """``per_words`` seeded random models of each width 1-4 state words
    (top-level concatenations of random pieces, the specials whatever the
    draw gives), then 'a[bc]{0,126}d' (126 specials) and ALL_SPECIALS
    (128): [(pattern, -i, model, sample)]."""
    import numpy as np

    from distributed_grep_tpu_torch.models.dfa import RegexError

    rng = np.random.default_rng(seed)
    got: dict[int, list] = {w: [] for w in range(1, 5)}
    tries = 0
    while min(len(v) for v in got.values()) < per_words:
        tries += 1
        if tries > 20000:
            raise AssertionError(f"sweep: too few models drawn {got}")
        parts = [rand_regex(rng) for _ in range(int(rng.integers(1, 24)))]
        pattern = "".join(p for p, _ in parts)
        ic = bool(rng.integers(0, 4) == 0)
        try:
            model = nfa_mod.try_compile_glushkov(pattern, ic)
        except RegexError:  # the parser refused the draw
            continue
        if model is None or len(got[model.n_words]) >= per_words:
            continue
        got[model.n_words].append(
            (pattern, ic, model,
             lambda r, parts=parts: "".join(f(r) for _, f in parts)))
    out = [d for w in range(1, 5) for d in got[w]]
    for pattern, sample in (("a[bc]{0,126}d", lambda r: "a" + "bc" * int(
            r.integers(0, 63)) + "d"), (ALL_SPECIALS, lambda r: "Zabc")):
        out.append((pattern, False, nfa_mod.try_compile_glushkov(pattern),
                    sample))
    return out


def sweep_text(rng, chunk: int, lanes: int, samples, fold: bool):
    """(chunk, lanes) stripes of random SWEEP_ALPHABET text (upper case
    too when ``fold``) with newlines, the samples planted at random
    offsets, at stripe heads (rows 0..len-1 of every 3rd lane) and across
    32-row word edges."""
    import numpy as np

    from distributed_grep_tpu_torch.ops.layout import Layout, to_device_array

    alpha = SWEEP_ALPHABET + (SWEEP_ALPHABET.upper() if fold else "") + "\n"
    text = rng.choice(np.frombuffer(alpha.encode(), np.uint8),
                      size=chunk * lanes)
    nd = [s.encode() for s in samples if s]
    n = max(8, text.size // 200)
    put(text, rng.integers(0, text.size - 140, size=n), nd)
    arr = to_device_array(text.tobytes(), Layout(lanes=lanes, chunk=chunk,
                                                 n_real=text.size))
    for k, lane in enumerate(range(0, lanes, 3)):
        s = nd[k % len(nd)][:chunk]
        arr[: len(s), lane] = np.frombuffer(s, np.uint8)
    for k, lane in enumerate(range(1, lanes, 5)):
        s = nd[k % len(nd)][: chunk // 2]
        r0 = max(0, min(32 - len(s) // 2, chunk - len(s)))
        arr[r0 : r0 + len(s), lane] = np.frombuffer(s, np.uint8)
    return arr


def phase_nfa_sweep(torch, np, nfa_scan, nfa_mod, seed: int) -> tuple[int, int]:
    """The NFA kernel against its plain version on seeded random models of
    1-4 words with 0-128 specials: every draw at SWEEP_SMALL, a 4-word
    draw and the 128-specials model at SWEEP_SEGMENT (no more, for the
    smoke's time: phase 2's NFA checks run six models at that shape).  Returns (draws compared, the
    largest absolute difference)."""
    rng = np.random.default_rng(seed)
    draws = sweep_regexes(nfa_mod, seed, per_words=NFA_SWEEP_PER_WIDTH)
    on_segment = {id(draws[4 * NFA_SWEEP_PER_WIDTH - 1]), id(draws[-1])}
    n = worst = 0
    for d in draws:
        pattern, ic, model, sample = d
        samples = [sample(rng) for _ in range(12)]
        shapes = SWEEP_SMALL + ([SWEEP_SEGMENT] if id(d) in on_segment else [])
        nonzero = 0
        for chunk, lanes in shapes:
            dev = torch.from_numpy(sweep_text(rng, chunk, lanes, samples,
                                              ic)).cuda()
            got = nfa_scan.nfa_scan_words(dev, model)
            torch.cuda.synchronize()
            want = nfa_scan.nfa_scan_words_plain(dev, model)
            err = words_err(torch, got, want)
            worst = max(worst, err)
            n += 1
            if not torch.equal(got, want) or err:
                raise AssertionError(
                    f"nfa sweep: kernel != plain for {pattern!r} (-i {ic}, "
                    f"{model.n_words} words, {model.n_specials} specials) "
                    f"chunk={chunk} lanes={lanes} max_abs_err={err}")
            nonzero += int(torch.count_nonzero(want.view(torch.int32)))
        if not nonzero:
            raise AssertionError(f"nfa sweep: no match of {pattern!r} in "
                                 f"its text")
        if id(d) in on_segment or model.n_specials >= 100:
            log(f"  ok nfa sweep {model.n_words} words {model.n_specials:3d} "
                f"specials, shapes {shapes}: {pattern[:60]!r}")
    by_words = {w: sum(d[2].n_words == w for d in draws) for w in range(1, 5)}
    log(f"  nfa sweep: {len(draws)} models (by words {by_words}; specials "
        f"{min(d[2].n_specials for d in draws)}-"
        f"{max(d[2].n_specials for d in draws)}), {n} draws compared, all "
        f"bit-identical")
    return n, worst


def sweep_banks(fdr_mod, seed: int, n: int) -> list:
    """``n`` seeded random FDR banks: m = 1..6 in turn, 1-16 checks at
    random slots, families and domains (tables at most 8192 entries), the
    tables built from a random group of members of m+1..m+6 letters."""
    import numpy as np

    rng = np.random.default_rng(seed)
    banks = []
    for i in range(n):
        m = 1 + i % fdr_mod.MAX_DEPTHS
        n_checks = 1 + int(rng.integers(0, 16)) if i % 4 else 16
        checks = []
        total = 0
        for _ in range(n_checks):
            dom = int(rng.choice(fdr_mod.DOMAINS))
            while total + dom > 8192 - 128 * (n_checks - len(checks) - 1):
                dom //= 2
            dom = max(dom, 128)
            total += dom
            checks.append((int(rng.integers(0, m)), int(rng.integers(0, 2)),
                           dom))
        group = [p.encode() for p in rand_literals(
            int(rng.integers(5, 400)), m + 1, m + 6, seed=seed + i)]
        tables = fdr_mod._build_tables(group, fdr_mod._bucket_of(group), m,
                                       tuple(checks))
        banks.append(fdr_mod.fdr_bank_from_arrays(
            m, checks, tables, group, fdr_mod._fp_of_tables(tables)))
    return banks


def phase_fdr_sweep(torch, np, fdr_scan, fdr_mod, seed: int) -> tuple[int, int]:
    """The FDR kernel against its plain version on seeded random banks, at
    SWEEP_SMALL (all) and SWEEP_SEGMENT (every 5th: each m, 16 checks),
    with and without case folding, members
    planted across the text, at stripe heads (ending at rows 0..m) and
    across word edges; half the launches OR into a nonzero plane (out=).
    Returns (draws compared, the largest absolute difference)."""
    from distributed_grep_tpu_torch.ops.layout import Layout, to_device_array

    rng = np.random.default_rng(seed)
    banks = sweep_banks(fdr_mod, seed, 32)
    n = worst = 0
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCXYZ \n", np.uint8)
    for chunk, lanes in SWEEP_SMALL + [SWEEP_SEGMENT]:
        size = chunk * lanes
        base_text = rng.choice(alpha, size=size)
        # every bank at the small shapes, every 5th (each m, 16 checks
        # included) at the segment, inside the smoke's time limit
        step = 5 if (chunk, lanes) == SWEEP_SEGMENT else 1
        for b_i, bank in list(enumerate(banks))[::step]:
            text = base_text.copy()
            members = bank.patterns
            n_put = max(8, min(size // 60, 20000))
            put(text, rng.integers(0, size - 16, size=n_put),
                [p.upper() if k % 3 == 0 else p
                 for k, p in enumerate(members)])
            arr = to_device_array(text.tobytes(), Layout(
                lanes=lanes, chunk=chunk, n_real=size))
            for r in range(bank.m + 1):  # a member ending at row r
                p = members[r % len(members)]
                tail = p[max(0, len(p) - r - 1):]
                arr[: len(tail), r::bank.m + 1] = np.frombuffer(
                    tail, np.uint8)[:, None]
            p = members[0]
            r0 = min(30, chunk - len(p))  # across a word edge where it fits
            arr[r0 : r0 + len(p), 2::7] = np.frombuffer(p, np.uint8)[:, None]
            dev = torch.from_numpy(arr).cuda()
            for fold in (False, True):
                acc = (b_i + fold) % 2 == 1
                if acc:
                    base = torch.from_numpy(rng.integers(
                        0, 2**32, size=(chunk // 32, lanes),
                        dtype=np.uint32) & np.uint32(0x11111111)).cuda()
                    got = base.clone()
                    fdr_scan.fdr_scan_words(dev, bank, fold, out=got)
                else:
                    got = fdr_scan.fdr_scan_words(dev, bank, fold)
                torch.cuda.synchronize()
                want = fdr_scan.fdr_scan_words_plain(dev, bank, fold)
                if acc:
                    want = (want.view(torch.int32)
                            | base.view(torch.int32)).view(torch.uint32)
                err = words_err(torch, got, want)
                worst = max(worst, err)
                n += 1
                if not torch.equal(got, want) or err:
                    raise AssertionError(
                        f"fdr sweep: kernel != plain for bank {b_i} (m="
                        f"{bank.m}, checks={bank.checks}) fold={fold} out="
                        f"{acc} chunk={chunk} lanes={lanes} max_abs_err={err}")
    log(f"  fdr sweep: {len(banks)} banks (m 1-{fdr_mod.MAX_DEPTHS}, checks "
        f"{min(b.n_checks for b in banks)}-{max(b.n_checks for b in banks)}"
        f", families {sorted({f for b in banks for f in b.families})}), "
        f"{n} draws compared at {SWEEP_SMALL} and (every 5th bank) "
        f"{SWEEP_SEGMENT}, all bit-identical")
    return n, worst


# The card-side sweep of the two sub-stripe kernels (csrc/shift_and.cu,
# csrc/approx.cu): seeded random models held to their plain versions bit
# for bit, with samples planted across every word boundary.  The kernels
# take as many sub-stripes as the card's size asks for: on these narrow
# tensors every word starts one (288 bytes, 9 words: an odd count), at
# SUB_MID a few words do, at the 64 MB segment none.
SUB_CHUNKS = (32, 64, 96, 288, 1024)
SUB_LANES = (32, 64, 96)
SUB_MID = (1024, 8192)


def rand_symbols(rng, m: int) -> str:
    """m symbols over SWEEP_ALPHABET: letters, two-letter classes and '.'."""
    out = []
    for _ in range(m):
        r = int(rng.integers(0, 6))
        if r == 0:
            out.append("[" + "".join(sorted(set(rng.choice(
                list(SWEEP_ALPHABET), size=2).tolist()))) + "]")
        elif r == 1:
            out.append(".")
        else:
            out.append(str(rng.choice(list(SWEEP_ALPHABET))))
    return "".join(out)


def sample_of(rng, sym_ranges) -> bytes:
    """A string the symbols match: a random byte of a random range each."""
    out = bytearray()
    for ranges in sym_ranges:
        lo, hi = ranges[int(rng.integers(0, len(ranges)))]
        out.append(int(rng.integers(lo, hi + 1)))
    return bytes(out)


def edited(rng, s: bytes, k: int) -> bytes:
    """``s`` after 0..k random substitutions, insertions or deletions of
    SWEEP_ALPHABET letters."""
    b = bytearray(s)
    for _ in range(int(rng.integers(0, k + 1))):
        op, p = int(rng.integers(0, 3)), int(rng.integers(0, len(b)))
        ch = ord(str(rng.choice(list(SWEEP_ALPHABET))))
        if op == 0:
            b[p] = ch
        elif op == 1:
            b.insert(p, ch)
        elif len(b) > 1:
            del b[p]
    return bytes(b)


def substripe_text(np, rng, lanes: int, chunk: int, samples, warm: int):
    """(lanes, chunk) stripes of SWEEP_ALPHABET text, upper case too, with
    a '\\n' per ~37 bytes and the samples at random places; then at every
    word boundary c0 (the kernels may start a sub-stripe at any) a sample
    ending d = 0..warm + 2 bytes after c0 (lanes j + d, j + d + warm + 6,
    ... for the j-th boundary: across c0 where d is below its length) and
    '\\n' at c0 - warm - 1, c0 - warm and c0 - 1 on other lanes."""
    alpha = np.frombuffer((SWEEP_ALPHABET * 3 + SWEEP_ALPHABET.upper() * 3
                           + "\n").encode(), np.uint8)
    arr = alpha[rng.integers(0, alpha.size, size=(lanes, chunk),
                             dtype=np.uint8)]
    flat = arr.reshape(-1)
    n = max(4, min(flat.size // 300, 20000))
    put(flat, rng.integers(0, flat.size - 40, size=n), samples)
    period = warm + 6
    for j, c0 in enumerate(range(32, chunk, 32)):
        for d in range(min(warm + 3, chunk - c0)):
            nd = samples[d % len(samples)]
            end = c0 + d
            nd = nd[max(0, len(nd) - end - 1):]
            arr[(j + d) % period::period, end + 1 - len(nd) : end + 1] = \
                np.frombuffer(nd, np.uint8)
        for i, at in enumerate((c0 - warm - 1, c0 - warm, c0 - 1)):
            if at >= 0:
                arr[(j + warm + 3 + i) % period::period, at] = 0x0A
    return arr


def substripe_draws(torch, np, rng, shapes, samples, warm: int):
    """One stripe tensor per (chunk, lanes, pitched) of ``shapes``: a
    pitched one is the window [:, off : off + chunk] of a tensor 64 bytes
    wider (off = 0, 32 or 64), its pitch chunk + 64."""
    for chunk, lanes, pitched in shapes:
        arr = substripe_text(np, rng, lanes, chunk, samples, warm)
        if not pitched:
            yield chunk, lanes, torch.from_numpy(arr).cuda()
            continue
        off = 32 * int(rng.integers(0, 3))
        wide = np.full((lanes, chunk + 64), ord("#"), np.uint8)
        wide[:, off : off + chunk] = arr
        dev = torch.from_numpy(wide).cuda()[:, off : off + chunk]
        assert dev.stride() == (chunk + 64, 1)
        yield chunk, lanes, dev


def substripe_shapes(i: int, segment: bool) -> list:
    """Draw i's (chunk, lanes, pitched): every SUB_CHUNKS chunk over
    SUB_LANES in turn, odd ones pitched; SUB_MID for every fourth draw;
    the 64 MB segment where asked."""
    shapes = [(chunk, SUB_LANES[(i + j) % 3], (i + j) % 2 == 1)
              for j, chunk in enumerate(SUB_CHUNKS)]
    if i % 4 == 0:
        shapes.append(SUB_MID + ((i // 4) % 2 == 1,))
    return shapes + ([SWEEP_SEGMENT + (False,)] if segment else [])


def phase_shift_and_sweep(torch, np, cuda_scan, sa_mod,
                          seed: int) -> tuple[int, int]:
    """The Shift-And kernel against its plain version on seeded random
    models of the lengths 1, 9, 17, 25 and 32 (a third with -i) and the
    rare-class filters among them, in both modes, at ``substripe_shapes``
    (the 64 MB segment for the seventh model, the last and one filter).  Returns (draws
    compared, the largest absolute difference)."""
    rng = np.random.default_rng(seed)
    models = []
    # every eighth length and 32 (every fourth until phase 3g came, every
    # odd length until phase 3f (d)-(g) came, every length before 3f)
    for m in [*range(1, 33, 8), 32]:
        full = sa_mod.try_compile_shift_and(rand_symbols(rng, m),
                                            bool(rng.integers(0, 3) == 0))
        assert full is not None and full.length == m
        models.append((full, full))
        filt = sa_mod.filtered_for_device(full)
        if filt is not None:
            models.append((filt, full))
    first_filter = next(i for i, (a, b) in enumerate(models) if a is not b)
    on_segment = {6, len(models) - 1, first_filter}
    n = worst = 0
    for i, (model, full) in enumerate(models):
        warm = 32 * cuda_scan.warmup_words(model)
        samples = [sample_of(rng, full.sym_ranges) for _ in range(6)]
        nonzero = 0
        shapes = substripe_shapes(i, i in on_segment)
        for chunk, lanes, dev in substripe_draws(torch, np, rng, shapes,
                                                 samples, warm):
            for coarse in (True, False):
                got = cuda_scan.shift_and_scan_words(dev, model, coarse)
                torch.cuda.synchronize()
                want = cuda_scan.shift_and_scan_words_plain(dev, model, coarse)
                err = words_err(torch, got, want)
                worst = max(worst, err)
                n += 1
                if not torch.equal(got, want) or err:
                    raise AssertionError(
                        f"shift_and sweep: kernel != plain for "
                        f"{model.pattern!r} (m={model.length}, filter="
                        f"{model is not full}) coarse={coarse} chunk={chunk} "
                        f"lanes={lanes} pitch={dev.stride(0)} "
                        f"max_abs_err={err}")
                nonzero += int(torch.count_nonzero(want.view(torch.int32)))
        if not nonzero:
            raise AssertionError(f"shift_and sweep: no match of "
                                 f"{model.pattern!r} in its text")
        if i in on_segment:
            log(f"  ok shift_and sweep m={model.length} filter="
                f"{model is not full} warm-up {warm} bytes, shapes {shapes}: "
                f"{model.pattern!r}")
    log(f"  shift_and sweep: {len(models)} models (m 1-29 every fourth "
        f"and 32, "
        f"{sum(a is not b for a, b in models)} filters), {n} draws compared "
        f"(both modes) at chunks {SUB_CHUNKS} over {SUB_LANES} lanes, "
        f"contiguous and pitched, {SUB_MID} for every fourth, and "
        f"{SWEEP_SEGMENT} for {len(on_segment)}, all bit-identical")
    return n, worst


def phase_approx_sweep(torch, np, approx_scan, ax_mod,
                       seed: int) -> tuple[int, int]:
    """The approx kernel against its plain version on seeded random models
    (k = 1-3 with m of k + 1, 20 and 32, so m + k - 1 up to 34: two
    warm-up words; a third with -i), samples within k
    edits, at ``substripe_shapes`` (the 64 MB segment for three of them,
    one per k at m = 32).  Returns (draws compared, the largest absolute
    difference)."""
    rng = np.random.default_rng(seed)
    # (three random draws more until phase 3g came)
    specs = [(k, m) for k in (1, 2, 3) for m in (k + 1, 20, 32)]
    models = []
    for k, m in specs:
        model = ax_mod.try_compile_approx(rand_symbols(rng, m), k,
                                          bool(rng.integers(0, 3) == 0))
        assert model is not None and model.length == m
        models.append(model)
    on_segment = {2, 5, 8}  # (1, 32), (2, 32), (3, 32)
    n = worst = 0
    for i, model in enumerate(models):
        warm = 32 * approx_scan.warmup_words(model)
        samples = [edited(rng, sample_of(rng, model.base.sym_ranges), model.k)
                   for _ in range(6)]
        nonzero = 0
        shapes = substripe_shapes(i, i in on_segment)
        for chunk, lanes, dev in substripe_draws(torch, np, rng, shapes,
                                                 samples, warm):
            got = approx_scan.approx_scan_words(dev, model)
            torch.cuda.synchronize()
            want = approx_scan.approx_scan_words_plain(dev, model)
            err = words_err(torch, got, want)
            worst = max(worst, err)
            n += 1
            if not torch.equal(got, want) or err:
                raise AssertionError(
                    f"approx sweep: kernel != plain for "
                    f"{model.base.pattern!r} (m={model.length}, k={model.k}) "
                    f"chunk={chunk} lanes={lanes} pitch={dev.stride(0)} "
                    f"max_abs_err={err}")
            nonzero += int(torch.count_nonzero(want.view(torch.int32)))
        if not nonzero:
            raise AssertionError(f"approx sweep: no match of "
                                 f"{model.base.pattern!r} in its text")
        if i in on_segment:
            log(f"  ok approx sweep k={model.k} m={model.length} warm-up "
                f"{warm} bytes, shapes {shapes}: {model.base.pattern!r}")
    log(f"  approx sweep: {len(models)} models (k 1-3, m 2-32, warm-up "
        f"words {sorted({approx_scan.warmup_words(x) for x in models})}), "
        f"{n} draws compared at chunks {SUB_CHUNKS} over {SUB_LANES} lanes, "
        f"contiguous and pitched, {SUB_MID} for every fourth, and "
        f"{SWEEP_SEGMENT} for {len(on_segment)}, all bit-identical")
    return n, worst


def sweep_pairsets(rng, ps_mod, n: int) -> list:
    """n seeded random 1-2-byte sets over SWEEP_ALPHABET (1-6 members, -i
    for a third), and the 40-row set whose factorization is transposed,
    with and without -i."""
    letters = list(SWEEP_ALPHABET.encode())
    out = []
    for _ in range(n):
        members = sorted({bytes(rng.choice(letters, size=int(
            rng.integers(1, 3))).tolist()) for _ in range(int(
                rng.integers(1, 7)))})
        out.append(ps_mod.compile_pairset(
            members, ignore_case=bool(rng.integers(0, 3) == 0)))
    wide = [bytes([100 + i, b"uvwxyz"[j]]) for i in range(40)
            for j in range(6) if (i + 1) >> j & 1]
    out += [ps_mod.compile_pairset(wide, ignore_case=ic)
            for ic in (False, True)]
    assert out[-1].transposed and out[-2].transposed
    return out


def phase_pairset_sweep(torch, np, pairset_scan, ps_mod,
                        seed: int) -> tuple[int, int]:
    """The pairset kernel against its plain version on seeded random sets
    of both orientations (a third with -i), members planted to end 0..2
    bytes after every word boundary (where the kernel may start a
    sub-stripe, seeding its previous byte with the byte before), at
    ``substripe_shapes`` (the 64 MB segment for three sets), every other
    draw ORed into a nonzero plane (out=).  Returns (draws compared, the
    largest absolute difference)."""
    rng = np.random.default_rng(seed)
    models = sweep_pairsets(rng, ps_mod, 12)  # 22 until phase 3g came
    on_segment = {0, len(models) - 2, len(models) - 1}
    n = worst = 0
    for i, model in enumerate(models):
        samples = [m.upper() if j % 3 == 0 else m
                   for j, m in enumerate(model.patterns[:40])]
        nonzero = 0
        shapes = substripe_shapes(i, i in on_segment)
        for chunk, lanes, dev in substripe_draws(torch, np, rng, shapes,
                                                 samples, 0):
            plain = pairset_scan.pairset_scan_words_plain(dev, model)
            use_out = n % 2 == 1
            if use_out:
                base = torch.from_numpy(rng.integers(
                    0, 2**32, size=(chunk // 32, lanes),
                    dtype=np.uint32)).cuda()
                got = pairset_scan.pairset_scan_words(dev, model,
                                                      out=base.clone())
                want = (plain.view(torch.int32)
                        | base.view(torch.int32)).view(torch.uint32)
            else:
                got = pairset_scan.pairset_scan_words(dev, model)
                want = plain
            torch.cuda.synchronize()
            err = words_err(torch, got, want)
            worst = max(worst, err)
            n += 1
            if not torch.equal(got, want) or err:
                raise AssertionError(
                    f"pairset sweep: kernel != plain for {model.patterns!r} "
                    f"(transposed={model.transposed}, -i={model.ignore_case})"
                    f" out={use_out} chunk={chunk} lanes={lanes} "
                    f"pitch={dev.stride(0)} max_abs_err={err}")
            nonzero += int(torch.count_nonzero(plain.view(torch.int32)))
        if not nonzero:
            raise AssertionError(f"pairset sweep: no match of "
                                 f"{model.patterns!r} in its text")
        if i in on_segment:
            log(f"  ok pairset sweep transposed={model.transposed} "
                f"-i={model.ignore_case} shapes {shapes}: "
                f"{len(model.patterns)} members")
    log(f"  pairset sweep: {len(models)} sets "
        f"({sum(m.transposed for m in models)} transposed, "
        f"{sum(m.ignore_case for m in models)} -i), {n} draws compared (half "
        f"with out=) at chunks {SUB_CHUNKS} over {SUB_LANES} lanes, "
        f"contiguous and pitched, {SUB_MID} for every fourth, and "
        f"{SWEEP_SEGMENT} for {len(on_segment)}, all bit-identical")
    return n, worst


def phase_swar_sweep(torch, np, swar_scan, sa_mod,
                     seed: int) -> tuple[int, int]:
    """The SWAR kernel against its plain version on seeded random models
    of every length 1-8 (letters, classes, '.', a third with -i) and the
    rare-class filters among them, at ``substripe_shapes`` (the 64 MB
    segment for lengths 8 and 3 and one filter).  Returns (draws compared,
    the largest absolute difference)."""
    rng = np.random.default_rng(seed)
    models = []
    for m in list(range(1, 9)) * 2:  # three each until phase 3g came
        full = sa_mod.try_compile_shift_and(rand_symbols(rng, m),
                                            bool(rng.integers(0, 3) == 0))
        assert full is not None and full.length == m
        models.append((full, full))
        filt = sa_mod.filtered_for_device(full)
        if filt is not None:
            models.append((filt, full))
    first_filter = next(i for i, (a, b) in enumerate(models) if a is not b)
    on_segment = {2, 7, first_filter}
    n = worst = 0
    for i, (model, full) in enumerate(models):
        warm = 32 * swar_scan.warmup_words(model)
        samples = [sample_of(rng, full.sym_ranges) for _ in range(6)]
        nonzero = 0
        shapes = substripe_shapes(i, i in on_segment)
        for chunk, lanes, dev in substripe_draws(torch, np, rng, shapes,
                                                 samples, warm):
            got = swar_scan.swar_scan_words(dev, model)
            torch.cuda.synchronize()
            want = swar_scan.swar_scan_words_plain(dev, model)
            err = words_err(torch, got, want)
            worst = max(worst, err)
            n += 1
            if not torch.equal(got, want) or err:
                raise AssertionError(
                    f"swar sweep: kernel != plain for {model.pattern!r} "
                    f"(m={model.length}, filter={model is not full}) "
                    f"chunk={chunk} lanes={lanes} pitch={dev.stride(0)} "
                    f"max_abs_err={err}")
            nonzero += int(torch.count_nonzero(want.view(torch.int32)))
        if not nonzero:
            raise AssertionError(f"swar sweep: no match of "
                                 f"{model.pattern!r} in its text")
        if i in on_segment:
            log(f"  ok swar sweep m={model.length} filter="
                f"{model is not full} warm-up {warm} bytes, shapes {shapes}: "
                f"{model.pattern!r}")
    log(f"  swar sweep: {len(models)} models (m 1-8, "
        f"{sum(a is not b for a, b in models)} filters), {n} draws compared "
        f"at chunks {SUB_CHUNKS} over {SUB_LANES} lanes, contiguous and "
        f"pitched, {SUB_MID} for every fourth, and {SWEEP_SEGMENT} for "
        f"{len(on_segment)}, all bit-identical")
    return n, worst


def set_models(fdr_mod, ps_mod) -> tuple[dict, dict]:
    """The set kernels' phase-2 models: the FDR banks of BASELINE configs
    2, 3 and 5 and a two-family bank with 1024-entry tables; pairset
    models of both orientations and a -i set."""
    banks = {
        "config2": fdr_mod.compile_fdr(CONFIG2_WORDS).banks[0],
        "config3": fdr_mod.compile_fdr(config3_set()).banks[0],
        "config5": fdr_mod.compile_fdr(config5_set()).banks[0],
    }
    group = [p.lower() for p in config3_set()[:400]]
    checks = ((4, 0, 128), (3, 0, 1024), (2, 0, 256), (0, 0, 1024),
              (4, 1, 512), (1, 1, 1024))
    tables = fdr_mod._build_tables(group, fdr_mod._bucket_of(group), 5, checks)
    banks["two families D1024"] = fdr_mod.fdr_bank_from_arrays(
        5, checks, tables, group, fdr_mod._fp_of_tables(tables))
    shapes = {k: (b.m, b.checks) for k, b in banks.items()}
    assert shapes["config2"] == (2, ((1, 0, 128), (0, 0, 128))), shapes
    assert shapes["config3"][0] == 5 and len(shapes["config3"][1]) == 5
    assert banks["config5"].families == (0, 1), shapes
    pairsets = {
        "2-byte set": ps_mod.compile_pairset(PAIR_SET),
        "transposed": ps_mod.compile_pairset(
            [bytes([100 + i, b"uvwxyz"[j]]) for i in range(40)
             for j in range(6) if (i + 1) >> j & 1]),
        "-i": ps_mod.compile_pairset([b"LA", b"he", b"Q#", b"q"],
                                     ignore_case=True),
    }
    assert pairsets["transposed"].transposed
    assert not pairsets["2-byte set"].transposed
    return banks, pairsets


def words_err(torch, got, want) -> int:
    """Largest absolute difference of two uint32 word planes."""
    g = got.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    w = want.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return int((g - w).abs().max())


def phase_set_kernels(torch, np, fdr_scan, pairset_scan, fdr_mod,
                      ps_mod) -> tuple[int, int]:
    """FDR and pairset kernel words vs their plain versions (run on the
    card), bit for bit, with and without out=: FDR on the (chunk, lanes)
    columns, pairset on the (lanes, chunk) stripes of the same bytes, and
    the out= plane ORed from both, as the engine's mixed sets do.  Returns
    the largest absolute difference seen for each kernel."""
    from distributed_grep_tpu_torch.ops.layout import choose_layout, to_device_array

    rng = np.random.default_rng(2468)
    banks, pairsets = set_models(fdr_mod, ps_mod)
    plants = config3_set()[:50] + config5_set()[:50] + PAIR_SET + [
        w.encode() for w in CONFIG2_WORDS] + [b"NEEDLE", b"LaHe"]

    worst = {"fdr": 0, "pairset": 0}
    for chunk, lanes in SET_SHAPES:
        for corpus in ("words", "pcap"):
            if corpus == "words":
                text = words_block(rng, chunk * lanes)
            else:
                text = rng.integers(0, 256, size=chunk * lanes, dtype=np.uint8)
                text[rng.integers(0, text.size, size=text.size // 120)] = 0x0A
            put(text, rng.choice(text.size - 16, size=max(32, text.size // 3000),
                                 replace=False), plants)
            lay = choose_layout(text.size, target_lanes=lanes, min_chunk=chunk,
                                lane_multiple=32, chunk_multiple=32)
            assert (lay.chunk, lay.lanes) == (chunk, lanes), lay
            arr = to_device_array(text.tobytes(), lay)
            arr[0:5, ::7] = np.frombuffer(b"eedle", np.uint8)[:, None]
            arr[30:33, 3::5] = np.frombuffer(b"Q#q", np.uint8)[:, None]
            dev = torch.from_numpy(arr).cuda()
            dev_st = torch.from_numpy(np.ascontiguousarray(arr.T)).cuda()
            runs = [("fdr", name, bank, fold)
                    for name, bank in banks.items() for fold in (False, True)]
            runs += [("pairset", name, m, m.ignore_case)
                     for name, m in pairsets.items()]
            for kernel, name, model, fold in runs:
                if kernel == "fdr":
                    got = fdr_scan.fdr_scan_words(dev, model, fold)
                    torch.cuda.synchronize()
                    want = fdr_scan.fdr_scan_words_plain(dev, model, fold)
                else:
                    got = pairset_scan.pairset_scan_words(dev_st, model)
                    torch.cuda.synchronize()
                    want = pairset_scan.pairset_scan_words_plain(dev_st,
                                                                 model)
                err = words_err(torch, got, want)
                worst[kernel] = max(worst[kernel], err)
                if not torch.equal(got, want) or err:
                    raise AssertionError(
                        f"{kernel} kernel != plain: {name} fold={fold} "
                        f"{corpus} chunk={chunk} lanes={lanes} "
                        f"max_abs_err={err}")
                log(f"  ok {kernel} {name:18s} fold={int(fold)} {corpus:5s} "
                    f"chunk={chunk:5d} lanes={lanes:6d} "
                    f"nonzero words={int(torch.count_nonzero(want.view(torch.int32)))}")
            # out=: later banks and the sidecar OR into one word plane
            out = fdr_scan.fdr_scan_words(dev, banks["config2"])
            fdr_scan.fdr_scan_words(dev, banks["config3"], out=out)
            pairset_scan.pairset_scan_words(dev_st, pairsets["2-byte set"],
                                            out=out)
            torch.cuda.synchronize()
            want = (fdr_scan.fdr_scan_words_plain(dev, banks["config2"])
                    .view(torch.int32)
                    | fdr_scan.fdr_scan_words_plain(dev, banks["config3"])
                    .view(torch.int32)
                    | pairset_scan.pairset_scan_words_plain(
                        dev_st, pairsets["2-byte set"]).view(torch.int32))
            if not torch.equal(out.view(torch.int32), want):
                raise AssertionError(f"out= OR differs from the plain "
                                     f"versions' OR ({corpus}, chunk={chunk})")
            log(f"  ok out= OR of config2 + config3 banks (columns) + 2-byte "
                f"set (stripes) {corpus:5s} chunk={chunk:5d} lanes={lanes:6d}")
    return worst["fdr"], worst["pairset"]


def approx_models(ax_mod) -> dict:
    """The approx kernel's models: the three approx queries (k = 1, 2 with
    -i, 3 on a class sequence) and k = 3 with -i."""
    models = {f"{p} k={k}{' -i' if ic else ''}":
              ax_mod.try_compile_approx(p, k, ignore_case=ic)
              for p, k, ic, _pieces in APPROX_QUERIES}
    models["Volcano k=3 -i"] = ax_mod.try_compile_approx("Volcano", 3, True)
    assert all(m is not None for m in models.values()), models
    return models


def swar_models(sa_mod) -> dict:
    """The SWAR kernel's models: the SWAR queries' full models and the
    volcano filter, each ``swar_values``-eligible."""
    full = sa_mod.try_compile_shift_and("volcano")
    models = {
        "volcano": full,
        "volcano-filter": sa_mod.filtered_for_device(full),
        "-i Volcano": sa_mod.try_compile_shift_and("Volcano", True),
        "being it": sa_mod.try_compile_shift_and("being it"),
    }
    assert all(sa_mod.swar_values(m) is not None for m in models.values())
    return models


def compare_words(torch, np, label: str, kernel, plain, models: dict,
                  shapes, lane_multiple: int, seed: int, needles,
                  edits, stripes: bool = False) -> int:
    """``kernel`` against ``plain`` (both run on the card) for every model,
    bit for bit, at each (chunk, lanes) of ``shapes``: words text with
    ``needles(rng, n)`` put at random places (one per 2000 bytes), then
    each (rows, lanes, bytes) of ``edits`` written down those lanes of the
    column layout, handed over as columns or, with ``stripes``, as the
    (lanes, chunk) stripes of the same bytes.  Returns the largest
    absolute difference seen."""
    from distributed_grep_tpu_torch.ops.layout import choose_layout, to_device_array

    rng = np.random.default_rng(seed)
    worst = 0
    for chunk, lanes in shapes:
        text = words_block(rng, chunk * lanes)
        n = max(16, text.size // 2000)
        put(text, rng.choice(text.size - 24, size=n, replace=False),
            needles(rng, n))
        lay = choose_layout(text.size, target_lanes=lanes, min_chunk=chunk,
                            lane_multiple=lane_multiple, chunk_multiple=32)
        assert (lay.chunk, lay.lanes) == (chunk, lanes), lay
        arr = to_device_array(text.tobytes(), lay)
        for rows, cols, needle in edits:
            arr[rows, cols] = np.frombuffer(needle, np.uint8)[:, None]
        dev = torch.from_numpy(np.ascontiguousarray(arr.T) if stripes
                               else arr).cuda()
        for name, model in models.items():
            got = kernel(dev, model)
            torch.cuda.synchronize()
            want = plain(dev, model)
            err = words_err(torch, got, want)
            worst = max(worst, err)
            nz = int(torch.count_nonzero(want.view(torch.int32)))
            if not torch.equal(got, want) or err or not nz:
                raise AssertionError(
                    f"{label} kernel != plain (or no match): {name} "
                    f"chunk={chunk} lanes={lanes} max_abs_err={err} "
                    f"nonzero={nz}")
            log(f"  ok {label} {name:24s} chunk={chunk:5d} lanes={lanes:6d} "
                f"nonzero words={nz}")
    return worst


def phase_approx_kernels(torch, np, approx_scan, ax_mod) -> int:
    """Approx kernel words vs the plain version's at the main path's
    segment shape and a small one, on stripes: errorful needles in the
    text, one at every 5th stripe head and one across a word edge."""
    return compare_words(
        torch, np, "approx", approx_scan.approx_scan_words,
        approx_scan.approx_scan_words_plain, approx_models(ax_mod),
        [(1024, 65536), (160, 64)], 32, 1357,
        lambda rng, n: [errorful(rng, APPROX_BASES[k]) for k in
                        rng.integers(0, len(APPROX_BASES), size=n).tolist()],
        [(slice(0, 7), slice(None, None, 5), b"volcxno"),
         (slice(27, 37), slice(3, 4), b"Schwarzeen")], stripes=True)


def phase_swar_kernels(torch, np, swar_scan, sa_mod) -> int:
    """SWAR kernel words vs the plain version's at the main path's segment
    shape and a small one, on stripes: the queries' needles in the text
    and 'volcano' across a word edge of every 7th stripe."""
    return compare_words(
        torch, np, "swar", swar_scan.swar_scan_words,
        swar_scan.swar_scan_words_plain, swar_models(sa_mod),
        [(1024, 65536), (160, 128)], 128, 8642,
        lambda rng, n: [b"volcano", b"VOLCANO", b"being it"],
        [(slice(29, 36), slice(1, None, 7), b"volcano")], stripes=True)


def sass_opcodes(build, name: str) -> dict[str, list[str]]:
    """The SASS opcodes of each kernel function in the build of
    csrc/<name>.cu (``cuobjdump -sass`` beside nvcc), or {} without
    cuobjdump."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        return {}
    out = subprocess.run([str(tool), "-sass", str(build._target(name))],
                         capture_output=True, text=True, timeout=120)
    ops: dict[str, list[str]] = {}
    func = None
    for line in out.stdout.splitlines():
        text = line.strip()
        if text.startswith("Function : "):
            func = text[len("Function : "):]
            ops[func] = []
        elif func is not None and text.startswith("/*") and ";" in text:
            words = text.split("*/", 1)[-1].replace("{", " ").split()
            if words and words[0].startswith("@"):  # a predicated instruction
                words = words[1:]
            ops[func].append(words[0].rstrip(";") if words else "?")
    return ops


def sass_counts(build, name: str) -> dict[str, int]:
    """SASS instructions of each kernel function in the build of
    csrc/<name>.cu, or {} without cuobjdump.  A kernel's steps per word
    (per 128-byte box for csrc/shift_and.cu) are unrolled, so a count over
    them is close to its instructions per input byte, setup included (per
    packed uint32 for the SWAR kernel, whose loop holds two words)."""
    return {f: len(o) for f, o in sass_opcodes(build, name).items()}


# the narrow probe kernel's template argument (width bits) in its mangled name
NARROW_WIDTHS = {"ILi32E": "i32", "ILi16E": "i16", "ILi8E": "i8"}


def narrow_label(func: str) -> str:
    return next((w for k, w in NARROW_WIDTHS.items() if k in func), func)


def narrow_text(np, rng, chunk: int, lanes: int, group: int):
    """(chunk, lanes) bytes for the narrow probe: words text whose last
    quarter of rows is random bytes (every value, beside class bytes in
    one register), 'volcano' down lanes ending 0..6 bytes into every word
    (every lane position of a thread's group of ``group`` lanes), and
    'volcann' beside an 'o' in the lane below its last 'n' in one register
    (where a borrowing zero-byte test would see a seventh 'o')."""
    arr = words_block(rng, chunk * lanes).reshape(chunk, lanes)
    tail = chunk - chunk // 4
    arr[tail:] = rng.integers(0, 256, size=(chunk - tail, lanes),
                              dtype=np.uint8)
    word = np.frombuffer(b"volcano", np.uint8)[:, None]
    for edge in range(32, chunk, 32):
        for k in range(1, 8):
            arr[edge - k : edge - k + 7,
                (k + edge // 32) % group :: 3 * group + 1] = word
    for c0 in range(3, chunk - 7, 37):
        cols = np.arange(1 + c0 % (group - 1), lanes, group * 5)
        arr[c0 : c0 + 7, cols] = np.frombuffer(b"volcann", np.uint8)[:, None]
        arr[c0 + 6, cols - 1] = ord("o")
    return arr


def phase_narrow_kernels(torch, np, narrow_probe) -> int:
    """Narrow probe words vs the plain version's at every width (narrow_text),
    at the main path's segment shape, a small one and lanes that are a
    multiple of 32 but not of a block's lanes.  Returns the largest absolute
    difference seen."""
    rng = np.random.default_rng(9753)
    worst = 0
    for chunk, lanes in [(1024, 65536), (160, 64), (96, 544)]:
        arr = narrow_text(np, rng, chunk, lanes, narrow_probe.LANES_PER_THREAD)
        dev = torch.from_numpy(arr).cuda()
        for width in narrow_probe.WIDTHS:
            got = narrow_probe.narrow_probe_words(dev, width)
            torch.cuda.synchronize()
            want = narrow_probe.narrow_probe_words_plain(dev, width)
            err = words_err(torch, got, want)
            worst = max(worst, err)
            nz = int(torch.count_nonzero(want.view(torch.int32)))
            if not torch.equal(got, want) or err or not nz:
                raise AssertionError(
                    f"narrow_probe kernel != plain (or no match): {width} "
                    f"chunk={chunk} lanes={lanes} max_abs_err={err} "
                    f"nonzero={nz}")
            log(f"  ok narrow_probe {width:3s} chunk={chunk:5d} "
                f"lanes={lanes:6d} nonzero words={nz}")
    return worst


def phase_mxu_kernels(torch, np, mxu_probe) -> int:
    """The one-hot product kernel vs its plain version (byte counts @
    member) on the card, every lane block's 128 x 128 sums: 1, 2 and 16
    lane blocks; the probe's member and a full-range int8 one (-128 ..
    127); one block per SM, one block, more blocks than rows, and counts
    whose ranges start, end and straddle inside lane blocks; words text
    with a random-byte tail (every byte value).  Returns the largest
    absolute difference seen."""
    rng = np.random.default_rng(8765)
    members = {
        "probe": torch.from_numpy(mxu_probe.probe_member()).cuda(),
        "full-range": torch.from_numpy(rng.integers(
            -128, 128, size=(256, 128), dtype=np.int8)).cuda()}
    worst = 0
    texts: dict = {}  # one text a shape, shared by its cases
    for chunk, lanes, blocks, which in [
            (1024, 65536, None, "probe"), (1024, 65536, None, "full-range"),
            (1024, 65536, 7, "full-range"), (512, 4096, None, "probe"),
            (512, 4096, 1, "full-range"), (512, 4096, 600, "probe"),
            (512, 8192, 3, "full-range")]:
        if (chunk, lanes) not in texts:
            text = words_block(rng, chunk * lanes)
            text[-text.size // 8:] = rng.integers(
                0, 256, size=text.size // 8, dtype=np.uint8)
            texts[(chunk, lanes)] = torch.from_numpy(
                text.reshape(chunk, lanes)).cuda()
        dev = texts[(chunk, lanes)]
        member = members[which]
        got = mxu_probe.mxu_dot(dev, member, blocks=blocks)
        torch.cuda.synchronize()
        want = mxu_probe.mxu_dot_plain(dev, member)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want) or err:
            raise AssertionError(
                f"mxu_dot kernel != plain: chunk={chunk} lanes={lanes} "
                f"blocks={blocks} member={which} max_abs_err={err}")
        used = blocks or mxu_probe.default_blocks(dev.device)
        log(f"  ok mxu_dot chunk={chunk:5d} lanes={lanes:6d} blocks={used:3d} "
            f"member={which:10s} sum={int(want.to(torch.int64).sum())}")
    return worst


def run_main(main, argv: list[str]) -> list[dict]:
    """Run a script's ``main(argv)`` in this process and return its JSON
    stdout lines (each also logged); a non-zero exit raises."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.strip()]
    for ln in lines:
        log("  " + json.dumps(ln))
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv}: exit status {rc}")
    return lines


CONFIG_BYTES = 64 * 10**6  # the config suite's --size-mb 64


def measuring_corpus(which: int):
    """One corpus of the measuring path, built in a worker process: 0 the
    bench's, 1-5 the config suite's specs."""
    sys.path.insert(0, str(ROOT))
    from distributed_grep_tpu_torch import bench
    from distributed_grep_tpu_torch.benchmarks import baseline_configs

    if which == 0:
        return bench.make_corpus(bench.CORPUS_BYTES)
    return baseline_configs.CONFIGS[which](CONFIG_BYTES)


def phase_measuring(counters: dict) -> dict:
    """Phase 4: the port's measuring path, each script's main() in this
    process, every launch count zeroed just before and read just after.
    The scripts' corpora (the reference's per-line Python recipes, tens of
    seconds each) are built first, in parallel worker processes, and each
    script gets its own recipe's bytes.  Returns the launch counts and the
    scripts' JSON lines."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from distributed_grep_tpu_torch import bench
    from distributed_grep_tpu_torch.benchmarks import (
        baseline_configs,
        kernel_compare,
        probe_narrow,
    )

    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            6, mp_context=multiprocessing.get_context("spawn")) as pool:
        built = dict(zip(range(6), pool.map(measuring_corpus, range(6))))
    log(f"measuring corpora (6 worker processes): "
        f"{time.perf_counter() - t0:.1f} s")

    def prebuilt(which: int, size: int, **kw):
        if (size != (bench.CORPUS_BYTES if which == 0 else CONFIG_BYTES)
                or kw not in ({}, {"n_patterns": 10_000})):
            raise AssertionError(f"corpus {which} asked at {size} bytes, {kw}")
        return built[which]

    recipes = bench.make_corpus, baseline_configs.CONFIGS
    bench.make_corpus = lambda n: prebuilt(0, n)
    baseline_configs.CONFIGS = {
        k: (lambda size, k=k, **kw: prebuilt(k, size, **kw))
        for k in recipes[1]}
    try:
        return drive_measuring(counters, bench, kernel_compare, probe_narrow,
                               baseline_configs)
    finally:
        bench.make_corpus, baseline_configs.CONFIGS = recipes


def drive_measuring(counters: dict, bench, kernel_compare, probe_narrow,
                    baseline_configs) -> dict:
    """Phase 4's run proper (see phase_measuring): each script's main(), its
    lines checked, between zeroing the launch counts and reading them."""
    for m in counters.values():
        m.reset_launches()
    t0 = time.perf_counter()
    (head,) = run_main(bench.main, [])
    if (set(head) != {"metric", "value", "unit", "vs_baseline"}
            or head["metric"] != "regex_scan_throughput_per_chip_literal"
            or not head["value"] > 0):
        raise AssertionError(f"bench line malformed: {head}")
    log(f"bench: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    engines = ["pallas", "nfa", "nfa_alt8", "pairset", "mxu_dot", "dfa",
               "stride2", "stride4", "aho256", "native_mt"]
    kc = run_main(kernel_compare.main, ["--size-mb", "64", "--engines",
                                        ",".join(engines)])
    if [ln["engine"] for ln in kc] != engines or any(
            not ln.get("value", 0) > 0 for ln in kc):
        raise AssertionError(f"kernel_compare lines: {kc}")
    log("kernel_compare table DFA: " + ", ".join(
        f"{ln['engine']} {ln['value']:.2f} GB/s"
        + (f" ({ln['banks']} bank)" if "banks" in ln else "")
        for ln in kc[5:]))
    log(f"kernel_compare: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    narrow = run_main(probe_narrow.main, ["slope"])
    if ([ln["probe"] for ln in narrow] != ["slope_i32", "slope_i16"]
            or narrow[0]["count"] != narrow[1]["count"]
            or not all(ln["gbs"] > 0 for ln in narrow)):
        raise AssertionError(f"probe_narrow slope lines: {narrow}")
    log(f"probe_narrow slope: {time.perf_counter() - t0:.1f} s")

    # the config suite end to end with --check, then with slope timing
    t0 = time.perf_counter()
    e2e = run_main(baseline_configs.main, ["--check", "--size-mb", "64"])
    slope = run_main(baseline_configs.main, ["--timing", "slope",
                                             "--size-mb", "64"])
    for ln in e2e + slope:
        if "error" in ln or not ln["value"] > 0:
            raise AssertionError(f"config suite line: {ln}")
    bad = [ln for ln in e2e if ln["check"] != "ok"]
    if [ln["config"] for ln in e2e] != [1, 2, 3, 4, 5] or bad:
        raise AssertionError(f"config suite --check: {bad or e2e}")
    log(f"baseline_configs e2e --check and slope: "
        f"{time.perf_counter() - t0:.1f} s")
    launched = {k: m.launches for k, m in counters.items()}
    log(f"measuring path launches: {launched}")
    for k in ("shift_and", "nfa", "fdr", "pairset", "narrow_probe", "mxu_dot",
              "dfa", "dfa_stride"):
        if not launched[k]:
            raise AssertionError(f"measuring path: no {k} launch")
    return {"launches": launched, "bench": head, "kernel_compare": kc,
            "narrow": narrow, "e2e": e2e, "slope": slope}


# Inputs of the native phase: the strict-UTF-8 edge cases of utf8_valid
NATIVE_UTF8 = [b"", b"plain", "café €😀".encode(), b"\xc3", b"\xc0\xaf",
               b"\xe0\x80\xaf", b"\xed\xa0\x80", b"\xf4\x90\x80\x80",
               b"\xf5\x80\x80\x80", b"\x80", b"\xff", b"a\x00b"]


def phase_native(np) -> dict:
    """Every entry point of the host library (csrc/dgrep.cpp, built by
    g++ -march=native for this machine's CPU) against its plain version on
    the same inputs, bit for bit, at sizes where the threaded and AVX2
    paths run: 16 MiB of word lines with NUL, 0xFF, CR and broken UTF-8
    planted.  Raises on any difference; returns the ``native`` line."""
    import tempfile

    from distributed_grep_tpu_torch.models.dfa import compile_dfa
    from distributed_grep_tpu_torch.ops import _build, host_match
    from distributed_grep_tpu_torch.ops import lines as lines_mod
    from distributed_grep_tpu_torch.ops.confirm_set import (
        ConfirmSet,
        ConfirmSetNumpy,
    )
    from distributed_grep_tpu_torch.runtime import columnar
    from distributed_grep_tpu_torch.runtime.job import JobResult
    from distributed_grep_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.lib()  # the build (or the load of a current one), untimed below
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(4848)
    clean = words_block(rng, 16 << 20).tobytes()
    dirty = bytearray(clean)
    for pos, b in zip(rng.integers(0, len(clean), 4000).tolist(),
                      rng.choice([0x00, 0xFF, 0x0D, 0xC3], 4000).tolist()):
        dirty[pos] = b
    dirty = bytes(dirty)
    checks: dict = {}

    def check(name: str, run, plain, n: int, same=None) -> None:
        t0 = time.perf_counter()
        got = run()
        t1 = time.perf_counter()
        want = plain()
        t2 = time.perf_counter()
        ok = same(got, want) if same else got == want
        checks[name] = {"ok": bool(ok), "n": int(n),
                        "ms": round((t1 - t0) * 1e3, 3),
                        "plain_ms": round((t2 - t1) * 1e3, 3)}
        if not ok:
            raise AssertionError(f"native {name}: differs from its plain "
                                 f"version")

    arrays = lambda a, b: np.array_equal(np.asarray(a), np.asarray(b))  # noqa: E731
    keys = [f"/data/p\udcff{i} (line number #{j})"
            for i, j in zip(range(20000), rng.integers(1, 10**9, 20000))]
    check("fnv32a", lambda: [native.fnv32a(k) for k in keys],
          lambda: [native.fnv32a_py(k) for k in keys], len(keys))
    nl = lines_mod.newline_index(dirty)
    check("newline_index", lambda: native.newline_index(dirty),
          lambda: lines_mod.newline_index_numpy(dirty), len(dirty), arrays)
    piece = dirty[: 4 << 20]
    check("literal_scan", lambda: native.literal_scan(piece, b"the"),
          lambda: native.literal_scan_py(piece, b"the"), len(piece), arrays)
    table = compile_dfa("(old|new) th[a-z]+$")
    full = table.full_table()
    small = dirty[: 256 << 10]
    for accept, tag in ((table.accept, ""), (table.accept_eol, " eol")):
        check("dfa_scan" + tag,
              lambda: native.dfa_scan(small, full, accept, table.start),
              lambda: native.dfa_scan_py(small, full, accept, table.start),
              len(small), lambda a, b: arrays(a[0], b[0]) and a[1] == b[1])
    mid = dirty[: 1 << 20]
    check("dfa_scan_mt", lambda: native.dfa_scan_mt(mid, full, table.accept,
                                                    table.start),
          lambda: native.dfa_scan_py(mid, full, table.accept,
                                     table.start)[0], len(mid), arrays)
    n_lines = int(nl.size)
    starts, ends = columnar.line_spans(np.arange(1, n_lines + 1), nl,
                                       len(dirty))
    check("dfa_lines_match (gather_ranges, dfa_scan_mt, unique_lines)",
          lambda: host_match.dfa_lines_match(table, dirty, starts, ends),
          lambda: host_match.dfa_lines_match_numpy(table, dirty, starts,
                                                   ends), n_lines, arrays)
    members = []
    for length, at in zip(rng.integers(1, 21, 3000).tolist(),
                          rng.integers(0, len(clean) - 32, 3000).tolist()):
        members.append(clean[at : at + length].replace(b"\n", b" "))
    cand = np.sort(rng.integers(0, len(dirty) + 2, 2_000_000))
    freed = []
    for ic in (False, True):
        cs = ConfirmSet(members, ignore_case=ic)
        check(f"confirm_build, confirm_scan{' -i' if ic else ''}",
              lambda: cs.confirm(dirty, cand),
              lambda: ConfirmSetNumpy(members, ignore_case=ic).confirm(
                  dirty, cand), cand.size, arrays)
        real_free = cs._free
        cs._free = lambda h, real_free=real_free: (freed.append(h),
                                                   real_free(h))
        del cs
    checks["confirm_free"] = {"ok": len(freed) == 2, "n": len(freed)}
    if len(freed) != 2:
        raise AssertionError("native confirm_free: a handle was not freed")
    src = np.frombuffer(dirty, np.uint8)
    g0 = rng.integers(0, len(dirty), 500_000)
    g1 = np.minimum(g0 + rng.integers(0, 80, g0.size), len(dirty))
    check("gather_ranges", lambda: columnar.gather_ranges(src, g0, g1)[0],
          lambda: columnar.gather_ranges_numpy(src, g0, g1)[0], g0.size)
    lines = [dirty[a:b] for a, b in zip(starts[:100_000].tolist(),
                                        ends[:100_000].tolist())]
    check("utf8_valid", lambda: [native.utf8_valid(x)
                                 for x in lines + NATIVE_UTF8],
          lambda: [native.utf8_valid_py(x) for x in lines + NATIVE_UTF8],
          len(lines) + len(NATIVE_UTF8))
    clean_nl = lines_mod.newline_index(clean)
    sel = np.arange(1, clean_nl.size + 1)[::3]
    clean_src = np.frombuffer(clean, np.uint8)
    batch = columnar.make_batch_from_lines("/data/w\udcff.txt", sel,
                                           clean_src, clean_nl, len(clean))
    prefix = "/data/w\udcff.txt (line number #".encode("utf-8",
                                                      "surrogateescape")
    check("format_batch", lambda: native.format_batch(
        prefix, batch.linenos, batch.offsets, batch.slab),
          batch.format_lines_bytes_numpy, len(batch))
    check("unique_lines", lambda: lines_mod.unique_match_lines(cand[1:], nl),
          lambda: lines_mod.unique_match_lines_numpy(cand[1:], nl),
          cand.size - 1, arrays)
    check("line_spans", lambda: columnar.line_spans(sel, nl, len(dirty)),
          lambda: columnar.line_spans_numpy(sel, nl, len(dirty)), sel.size,
          lambda a, b: arrays(a[0], b[0]) and arrays(a[1], b[1]))

    def parts(split):
        return {p: (b.linenos.tolist(), b.offsets.tolist(), b.slab)
                for p, b in split.items()}

    deferred = lambda: columnar.DeferredBatch(  # noqa: E731
        "/data/w\udcff.txt", sel, src, nl, len(dirty), 7)
    check("build_records", lambda: parts(deferred().split_by_partition(10)),
          lambda: parts(deferred().split_by_partition_numpy(10)), sel.size)
    bufs = []
    for i in range(10):
        pick = np.sort(rng.choice(sel, 20000, replace=False))
        bufs.append(b"".join(
            columnar.make_batch_from_lines(
                f"/data/{name}", pick, src, nl, len(dirty)
            ).format_lines_bytes()
            # "\udcc3" (a raw 0xC3) sorts after "é" (0xC3 0xA9) as str
            for name in sorted(["é", "\udcc3", "a", f"f{i}"])))
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, b in enumerate(bufs):
            files.append(Path(tmp) / f"mr-out-{i}")
            files[-1].write_bytes(b)
        res = JobResult(output_files=files, fileline_sorted=True)
        check("merge_display", lambda: native.merge_display(bufs),
              lambda: b"".join(res.iter_display_bytes_sorted()),
              sum(len(b) for b in bufs))

    def trigram(fn):
        bloom = np.zeros(1 << 16, np.uint8)
        fn(dirty[: 4 << 20], bloom)
        return bloom.tobytes()

    check("trigram_summary", lambda: trigram(native.trigram_summary_into),
          lambda: trigram(native.trigram_summary_numpy), 4 << 20)
    covered = {n for name in checks for n in re.findall(r"[a-z0-9_]+", name)}
    missing = set(native.ENTRY_POINTS) - covered
    if missing:
        raise AssertionError(f"native entry points not checked: {missing}")
    version, target = _build.gxx()[1].split("\n", 1)
    march = re.search(r"-march=\s+(\S+)", target)
    return {"native": {"gxx": version.strip(),
                       "march": march.group(1) if march else None,
                       "threads": native.THREADS,
                       "library": Path(native.lib()._name).name,
                       "build_s": round(build_s, 3),
                       "checks": checks}}


def cuda_ms(torch, fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_warm_tiers(args, words: list[Path], pats3: Path, counters: dict,
                     card: str, torch) -> None:
    """Phase 3b (module docstring): its own main path, the launch counts
    zeroed just before it and read just after (the CLI runs' launches are
    their processes' own, from --metrics).  Needs the word corpus and the
    small-file tree (WORK / "tree")."""
    from distributed_grep_tpu_torch.benchmarks import many_small_files

    log(f"== phase 3b: the warm tiers, card: {card}")
    t_warm = time.perf_counter()
    for m in counters.values():
        m.reset_launches()
    log(f"{recursive_batched_run(WORK / 'tree', pats3)} [{card}]")
    for line in small_input_runs(words[0], WORK):
        log(f"{line} [{card}]")
    for line in corpus_cache_runs(words, WORK, args.workers, torch):
        log(f"{line} [{card}]")
    log(f"{follow_run(words, WORK, counters)} [{card}]")
    # 500 files of 32 KiB (its default is 2,000): its corpus recipe draws
    # each word in Python, so the file count sets most of its time
    msf = run_main(many_small_files.main, ["--check", "--files",
                                           str(MANY_SMALL_FILES)])[-1]
    if msf.get("check") != "ok" or not msf["launches"].get("shift_and"):
        raise AssertionError(f"many_small_files: {msf}")
    warm_launches = {k: m.launches for k, m in counters.items()}
    log(f"many_small_files --check: packed {msf['packed_gbps']:.3f} GB/s e2e "
        f"against host {msf['host_gbps']:.3f} GB/s "
        f"({msf['speedup_vs_host']:.3f}x), {msf['dispatches_packed']} "
        f"dispatches for {msf['files']} files, fill "
        f"{msf['batch_fill_ratio']:.6f} [{card}]")
    if not warm_launches["shift_and"]:
        raise AssertionError(f"warm tiers: no Shift-And launch in this "
                             f"process ({warm_launches})")
    log(f"phase 3b launches in this process: {warm_launches}; "
        f"{time.perf_counter() - t_warm:.1f} s")


# Phase 3c: the jobs phase 3 ran in process, again through a coordinator
# process and worker processes over HTTP; their mr-out bytes must equal
# phase 3's (sha256 a file)
CONTROL_QUERIES = ("volcano", "config3 -f")
CONTROL_TIMEOUT_S = 10.0  # the 3c jobs' task_timeout_s: a kill re-issues
WORDCOUNT_MB = 32


def mr_out_hashes(paths) -> dict[str, str]:
    import hashlib

    return {Path(p).name: hashlib.sha256(Path(p).read_bytes()).hexdigest()
            for p in paths}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def port_proc(args: list[str], env: dict | None = None) -> subprocess.Popen:
    """The port's CLI in a process of its own, stderr kept (drained by a
    thread, so the pipe never fills)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_grep_tpu_torch", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "DGREP_RPC_RETRIES": "10", **(env or {})})
    proc.err_lines = []

    def drain():
        for line in proc.stderr:
            proc.err_lines.append(line.decode(errors="replace"))
        proc.ended_at = time.perf_counter()  # its stderr closed: it exited

    proc.drainer = threading.Thread(target=drain, daemon=True)
    proc.drainer.start()
    return proc


def coordinator_status(port: int) -> dict | None:
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                    timeout=5) as resp:
            return json.loads(resp.read())
    except OSError:
        return None


class ControlJob:
    """One job through ``coordinator --config`` and ``worker --addr``
    processes; ``status`` is the last /status read (polled every 0.2 s,
    the done one among them: the coordinator serves for 2 s after it),
    ``marks`` the seconds from the coordinator's start until a map was
    first assigned, every map had committed, and the job was done."""

    def __init__(self, name: str, files: list[Path], app_options: dict,
                 application: str | None = None, spans: bool = False):
        self.port = free_port()
        self.work = WORK / f"control-{name}"
        self.work.mkdir(parents=True, exist_ok=True)
        cfg = {"input_files": [str(p) for p in files],
               "app_options": app_options, "n_reduce": 10,
               "work_dir": str(self.work), "coordinator_port": self.port,
               "task_timeout_s": CONTROL_TIMEOUT_S}
        if application:
            cfg["application"] = application
        if spans:
            cfg["spans"] = True
        self.cfg = self.work / "job.json"
        self.cfg.write_text(json.dumps(cfg))
        self.procs: list[subprocess.Popen] = []
        self.workers: list[subprocess.Popen] = []
        self.killed: set[int] = set()
        self.status: dict = {}
        self.marks: dict[str, float] = {}
        self.t0 = time.perf_counter()

    def coordinator(self, resume: bool = False) -> subprocess.Popen:
        self.t0_wall = time.time()  # the span log's clock
        self.coord = port_proc(["coordinator", "--config", str(self.cfg),
                                *(["--resume"] if resume else [])],
                               env={"DGREP_LOG": "INFO"})
        self.procs.append(self.coord)
        return self.coord

    def worker(self, slots: int) -> subprocess.Popen:
        started_at = time.time()
        w = port_proc(["worker", "--addr", f"127.0.0.1:{self.port}",
                       "--slots", str(slots)], env={"DGREP_LOG": "INFO"})
        w.started_at = started_at
        self.workers.append(w)
        self.procs.append(w)
        return w

    def poll_until(self, pred, timeout: float = 300.0) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = coordinator_status(self.port)
            if st is not None:
                self.status = st
                now = time.perf_counter() - self.t0
                if st["counters"].get("map_assigned"):
                    self.marks.setdefault("first_map_s", now)
                if st["map"]["completed"] == st["map"]["total"]:
                    self.marks.setdefault("maps_done_s", now)
                if st.get("done"):
                    self.marks.setdefault("done_s", now)
                if pred(st):
                    return st
            if self.coord.poll() is not None:
                raise AssertionError(
                    f"coordinator exited ({self.coord.returncode}) waiting: "
                    + "".join(self.coord.err_lines[-20:]))
            time.sleep(0.2)
        raise AssertionError(f"control job: timed out at {self.status}")

    def kill(self, proc: subprocess.Popen) -> None:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        self.killed.add(id(proc))

    def finish(self, on_done=None) -> dict:
        """Wait for the job: the coordinator prints one JSON line naming
        every output (its workers are checked by ``check_workers``).
        ``on_done()`` runs at the first poll that reads the job done,
        while the coordinator still serves."""

        def done(st) -> bool:
            if st.get("done") and on_done is not None:
                on_done()
            return bool(st.get("done"))

        self.poll_until(done)
        out, _ = self.coord.communicate(timeout=120)
        self.t_finish = time.perf_counter()
        self.wall = self.t_finish - self.t0
        lines = out.decode().strip().splitlines()
        if self.coord.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"coordinator rc {self.coord.returncode}, "
                                 f"stdout {lines}: "
                                 + "".join(self.coord.err_lines[-20:]))
        self.outputs = [Path(p) for p in json.loads(lines[0])["outputs"]]
        return self.status

    def check_workers(self) -> None:
        """Every worker not killed on purpose exited 0; ``marks`` gains
        the seconds from the coordinator's exit to the last worker's."""
        for w in self.workers:
            if id(w) in self.killed:
                continue
            if w.wait(timeout=120) != 0:
                w.drainer.join(timeout=5)
                raise AssertionError(f"worker exited {w.returncode}: "
                                     + "".join(w.err_lines[-30:]))
            w.drainer.join(timeout=5)
            late = getattr(w, "ended_at", self.t_finish) - self.t_finish
            self.marks["workers_exit_s"] = max(
                self.marks.get("workers_exit_s", 0.0), late)
            if late > 10.0:  # its log says what it waited for
                log(f"  a worker exited {late:.1f} s after its coordinator; "
                    f"its log's end:\n" + "".join(w.err_lines[-40:]))

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def phase_control_plane(words: list[Path], set3: list[bytes],
                        inproc: dict, card: str, device: str = "cuda") -> dict:
    """Phase 3c (module docstring): (a) 'volcano' and config 3's set over
    the word files through a coordinator process and two worker processes
    (one of two slots) on the card, each job's mr-out bytes equal to phase
    3's in-process job of the same options, Shift-And and FDR launches
    shipped by the workers; (b) 'volcano' with a worker SIGKILLed while it
    holds a map task; beside it, (c) 'volcano' with the coordinator
    SIGKILLed after two map commits and restarted with --resume (the
    journal's maps not assigned again); (d) ``run --config`` of the word count over 32 MiB
    of word lines against a collections.Counter, in a process of its own
    beside (a)-(c).  Returns the phase's one line as a dict."""
    import collections

    log(f"== phase 3c: the control plane, card: {card}")
    t_phase = time.perf_counter()
    queries = {
        "volcano": {"pattern": "volcano", "ignore_case": False,
                    "device": device},
        "config3 -f": {"patterns": [m.decode() for m in set3],
                       "device": device},
    }
    result: dict = {"phase": "3c", "card": card}
    jobs: list[ControlJob] = []
    lines: dict[str, ControlJob] = {}
    # (d) starts first and runs beside the others (host work only), its
    # oracle counted on a thread meanwhile
    text = words[0].read_bytes()[: WORDCOUNT_MB << 20]
    text = text[: text.rfind(b"\n") + 1]
    wc_file = WORK / "wordcount.txt"
    wc_file.write_bytes(text)
    wc_cfg = WORK / "wordcount.json"
    wc_cfg.write_text(json.dumps({
        "input_files": [str(wc_file)],
        "application": "distributed_grep_tpu_torch.apps.wordcount",
        "app_options": {"device": device},
        "n_reduce": 10, "work_dir": str(WORK / "control-wordcount")}))
    wc = subprocess.Popen(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "run",
         "--config", str(wc_cfg), "--workers", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    wc_done: dict = {}

    def wait_wc(t0=time.perf_counter()):
        wc_done["out"], wc_done["err"] = wc.communicate(timeout=600)
        wc_done["wall_s"] = time.perf_counter() - t0
        wc_done["want"] = collections.Counter(
            w.lower().decode() for w in re.findall(rb"[A-Za-z]+", text))

    wc_thread = threading.Thread(target=wait_wc, daemon=True)
    wc_thread.start()

    def job_line(job: ControlJob) -> dict:
        st = job.status
        return {"wall_s": job.wall, **job.marks,
                "data_plane": st.get("data_plane", {}),
                "seconds": st.get("seconds", {}),
                "rpcs": sum(st.get("rpcs", {}).values()),
                "map_retries": st["counters"].get("map_retries", 0),
                "reduce_retries": st["counters"].get("reduce_retries", 0),
                "quarantined": st["quarantine"]["quarantined_total"],
                "launches": st.get("launches", {}), "mr_out": "identical"}

    try:
        # (a) both queries, two worker processes, one with two slots
        for label, kernel in (("volcano", "shift_and"),
                              ("config3 -f", "fdr")):
            job = ControlJob(label.split()[0], words, queries[label])
            jobs.append(job)
            job.coordinator()
            job.worker(1)
            job.worker(2)
            st = job.finish()
            if mr_out_hashes(job.outputs) != inproc[label]:
                raise AssertionError(f"3c (a) {label}: mr-out differs from "
                                     f"the in-process job")
            if device == "cuda" and not st["launches"].get(kernel):
                raise AssertionError(f"3c (a) {label}: no {kernel} launch "
                                     f"shipped: {st['launches']}")
            lines[f"a {label}"] = job
        # (b) and (c) side by side (each job its own coordinator and
        # workers): the phase stays inside its time
        def worker_killed() -> None:
            # (b) a worker killed while it holds a map task
            job = ControlJob("kill", words, queries["volcano"])
            jobs.append(job)
            job.coordinator()
            first = job.worker(1)
            job.poll_until(lambda st: any(r["type"] == "map"
                                          for r in st["in_flight"]))
            job.kill(first)  # the only worker: the task is its
            job.worker(2)
            st = job.finish()
            if mr_out_hashes(job.outputs) != inproc["volcano"]:
                raise AssertionError("3c (b): mr-out differs after the kill")
            if st["counters"].get("map_retries", 0) < 1:
                raise AssertionError(f"3c (b): no re-issue: {st['counters']}")
            lines["b worker killed"] = job

        def coordinator_killed() -> None:
            # (c) the coordinator killed after two map commits, then
            # resumed; two workers of one slot, both there from the start
            # (one that starts late may join as the job ends: ROADMAP C9)
            job = ControlJob("resume", words, queries["volcano"])
            jobs.append(job)
            job.coordinator()
            job.worker(1)
            job.worker(1)
            job.poll_until(lambda st: st["map"]["completed"] >= 2)
            job.kill(job.coord)
            journal = (job.work / "journal" / "tasks.jsonl").read_text()
            journaled = {json.loads(x)["task_id"]
                         for x in journal.splitlines() if '"map_done"' in x}
            if len(journaled) < 2 or len(journaled) == len(words):
                raise AssertionError(f"3c (c): journal holds {journaled}")
            job.coordinator(resume=True)
            st = job.finish()
            if mr_out_hashes(job.outputs) != inproc["volcano"]:
                raise AssertionError("3c (c): mr-out differs after the "
                                     "resume")
            assigned = st["counters"].get("map_assigned", 0)
            if assigned > len(words) - len(journaled):
                raise AssertionError(f"3c (c): {assigned} maps assigned "
                                     f"after the resume, {len(journaled)} of "
                                     f"{len(words)} were journaled")
            lines["c coordinator killed"] = job
            job.marks.update(journaled_maps=len(journaled),
                             maps_assigned_after_resume=assigned)

        with ThreadPoolExecutor(2) as pool:
            for f in [pool.submit(worker_killed),
                      pool.submit(coordinator_killed)]:
                f.result()
        result["chain_s"] = time.perf_counter() - t_phase
        for job in jobs:
            job.check_workers()
        result.update({k: job_line(job) for k, job in lines.items()})
        # (d) the word count's result
        wc_thread.join(timeout=600)
        result["wordcount_joined_s"] = time.perf_counter() - t_phase
        if wc.returncode != 0:
            raise AssertionError(
                f"3c (d): run exited {wc.returncode}: "
                f"{wc_done.get('err', b'')[-2000:].decode(errors='replace')}")
        got = {}
        for line in wc_done["out"].decode().splitlines():
            k, _, v = line.rpartition(" ")
            got[k] = int(v)
        if got != dict(wc_done["want"]):
            raise AssertionError(f"3c (d): {len(got)} words counted, the "
                                 f"Counter has {len(wc_done['want'])}")
        result["d run wordcount"] = {
            "wall_s": wc_done["wall_s"], "bytes": wc_file.stat().st_size,
            "words": len(got), "occurrences": sum(got.values()),
            "counts": "equal to collections.Counter"}
    finally:
        for job in jobs:
            job.stop()
        if wc.poll() is None:
            wc.kill()
            wc.wait()
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3c: {json.dumps(result, sort_keys=True)}")
    return result


# Phase 3d: the telemetry.  The traced job's Shift-And kernels are found in
# the profiler's trace by this substring of their (mangled or demangled)
# names; no symbol is written out.
TRACED_KERNEL = "shift_and_kernel"


def prom_value(text: str, name: str) -> float | None:
    """The value of an unlabeled sample in Prometheus text, or None."""
    m = re.search(rf"^{re.escape(name)} (\S+)$", text, re.M)
    return float(m.group(1)) if m else None


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


_LOG_LINE = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) \S+ \S+: "
                       r"(.*)$")


def log_lines(proc):
    """(wall time, message) of each line a port process logged with
    DGREP_LOG (its asctime is the local time, to the millisecond)."""
    for line in proc.err_lines:
        m = _LOG_LINE.match(line.rstrip("\n"))
        if m:
            yield (time.mktime(time.strptime(m[1], "%Y-%m-%d %H:%M:%S"))
                   + int(m[2]) / 1e3, m[3])


def worker_start_split(w) -> dict:
    """A worker process's seconds before its first map, from its log:
    the interpreter and the CLI's imports (its start to its first line),
    the legs ``run_http_worker`` times (config, app, device, host
    library), then its wait for its first map."""
    out: dict = {}
    ready = None
    for ts, msg in log_lines(w):
        if msg.endswith("fetching the job's config") and "imports_s" not in out:
            out["imports_s"] = ts - w.started_at
        elif "; start: " in msg and ready is None:
            ready = ts
            for leg in msg.split("; start: ", 1)[1].split(", "):
                name, _, secs = leg.rpartition(" ")[0].rpartition(" ")
                out[f"{name.replace(' ', '_')}_s"] = float(secs)
        elif ready is not None and re.fullmatch(r"worker \d+: map \d+",
                                                  msg):
            out["ready_to_first_map_s"] = ts - ready
            out["first_map_s"] = ts - w.started_at
            break
    return out


def phase_telemetry(args, words: list[Path], set3: list[bytes], inproc: dict,
                    card: str, counters: dict) -> dict:
    """Phase 3d (module docstring): (a) 'volcano' in process with the span
    pipeline on and under the profiler, its trace's kernels against the
    launch counter and the card's busy share over the traced window; (b)
    config 3's set through a coordinator process and two worker processes
    with ``"spans": true``, read through ``status --addr``, GET /metrics
    and ``trace-export``.  Returns the phase's one line as a dict."""
    import collections
    import urllib.request

    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig
    from distributed_grep_tpu_torch.utils.spans import EventLog

    log(f"== phase 3d: telemetry, card: {card}")
    t_phase = time.perf_counter()
    result: dict = {"phase": "3d", "card": card}
    in_bytes = sum(p.stat().st_size for p in words)
    segs = sum(-(-p.stat().st_size // (64 << 20)) for p in words)

    # (a) the traced in-process job, the launch counts zeroed just before
    trace_dir = WORK / "trace"
    work = WORK / "traced"
    for m in counters.values():
        m.reset_launches()
    os.environ["DGREP_TRACE_DIR"] = str(trace_dir)
    t0 = time.perf_counter()
    try:
        res = run_job(JobConfig(
            input_files=[str(p) for p in words],
            app_options={"pattern": "volcano", "ignore_case": False},
            n_reduce=10, task_timeout_s=60.0, work_dir=str(work),
            journal=False, durable=False, spans=True, job_id="traced"),
            n_workers=args.workers, device="cuda")
    finally:
        os.environ.pop("DGREP_TRACE_DIR", None)
    wall = time.perf_counter() - t0
    launched = {k: m.launches for k, m in counters.items()}
    if mr_out_hashes(res.output_files) != inproc["volcano"]:
        raise AssertionError("3d (a): the traced job's mr-out differs from "
                             "the untraced one")
    events = EventLog.read(work / EventLog.FILENAME)
    names = collections.Counter(e.get("name") for e in events)
    if names["map:task"] != len(words) or names["reduce:task"] != 10:
        raise AssertionError(f"3d (a): {names['map:task']} map:task and "
                             f"{names['reduce:task']} reduce:task spans")
    scans = [e for e in events
             if str(e.get("name", "")).startswith("scan:")]
    scanned = sum(e["args"]["bytes"] for e in scans)
    if scanned != in_bytes or any(e["args"]["device_fallback"]
                                  for e in scans):
        raise AssertionError(f"3d (a): scan records hold {scanned} bytes "
                             f"of {in_bytes}: {scans[:2]}")
    traces = sorted(trace_dir.glob(f"trace-{os.getpid()}-*.json"))
    if len(traces) != 1:
        raise AssertionError(f"3d (a): trace files {traces}")
    trace_events = json.loads(traces[0].read_text())["traceEvents"]
    spans_x = [e for e in trace_events
               if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in spans_x if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("3d (a): the trace of a cuda job holds no "
                             "kernel: the card's activity was not recorded")
    sa = [e for e in kernels if TRACED_KERNEL in e.get("name", "")]
    if len(sa) != launched["shift_and"] or launched["shift_and"] < segs:
        raise AssertionError(
            f"3d (a): {len(sa)} Shift-And kernels in the trace, "
            f"{launched['shift_and']} launches counted, {segs} segments")
    regions = collections.Counter(
        str(e.get("name")).split(":")[0] for e in spans_x
        if e.get("cat") == "user_annotation")
    if regions["map_read"] != len(words) or regions["map_compute"] != len(
            words):
        raise AssertionError(f"3d (a): worker regions in the trace: "
                             f"{dict(regions)}")
    t_lo = min(e["ts"] for e in spans_x)
    window_us = max(e["ts"] + e["dur"] for e in spans_x) - t_lo
    busy_us = union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    sa_us = sum(e["dur"] for e in sa)
    result["a traced volcano"] = {
        "wall_s": wall, "trace_mb": traces[0].stat().st_size / 1e6,
        "trace_events": len(trace_events), "kernel_events": len(kernels),
        "shift_and_events": len(sa), "launches": launched,
        "window_ms": window_us / 1e3, "kernel_busy_ms": busy_us / 1e3,
        "shift_and_ms": sa_us / 1e3, "busy_share": busy_us / window_us,
        "spans": sum(names.values()), "scan_bytes": scanned}
    log(f"3d (a) traced 'volcano' job: {len(sa)} Shift-And kernels in the "
        f"trace = {launched['shift_and']} launches counted; the card busy "
        f"{busy_us / 1e3:.3f} ms of the {window_us / 1e3:.3f} ms traced "
        f"window: busy share {busy_us / window_us:.6f} (idle share "
        f"{1 - busy_us / window_us:.6f}); Shift-And kernels "
        f"{sa_us / 1e3:.3f} ms; job wall {wall:.3f} s traced [{card}]")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(trace_dir, ignore_errors=True)

    # (b) config 3's set through a coordinator and two worker processes
    job = ControlJob("spans", words,
                     {"patterns": [m.decode() for m in set3],
                      "device": "cuda"}, spans=True)
    scraped: dict = {}
    try:
        job.coordinator()
        starts = [time.time()]
        job.worker(1)
        starts.append(time.time())
        job.worker(2)
        job.poll_until(lambda st: st.get("done") or any(
            r["type"] == "map" for r in st["in_flight"]))
        if job.status.get("done"):
            raise AssertionError("3d (b): the job was done before status "
                                 "--addr could read it running")
        cli = subprocess.run(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "status",
             "--addr", f"127.0.0.1:{job.port}"],
            cwd=ROOT, capture_output=True, timeout=60)
        live = json.loads(cli.stdout) if cli.returncode == 0 else {}
        if not {"done", "map", "reduce", "metrics", "workers",
                "in_flight"} <= set(live) or live["done"]:
            raise AssertionError(f"3d (b): status --addr exited "
                                 f"{cli.returncode}: {cli.stdout[:500]!r} "
                                 f"{cli.stderr[-500:]!r}")

        def scrape() -> None:
            # /metrics, then /status: an assign poll is counted as an RPC
            # before its histogram observes it, so the later RPC count
            # bounds the earlier poll count
            if "text" not in scraped:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{job.port}/metrics",
                        timeout=5) as resp:
                    scraped["text"] = resp.read().decode()
                after = coordinator_status(job.port) or {}
                scraped["rpcs"] = after.get("rpcs", {}).get("AssignTask")

        st = job.finish(on_done=scrape)
        job.check_workers()
    finally:
        job.stop()
    if mr_out_hashes(job.outputs) != inproc["config3 -f"]:
        raise AssertionError("3d (b): mr-out differs from the in-process "
                             "job")
    if not st["launches"].get("fdr"):
        raise AssertionError(f"3d (b): no fdr launch shipped: "
                             f"{st['launches']}")
    text = scraped.get("text", "")
    polls = prom_value(text, "dgrep_assign_poll_seconds_count")
    assigned = (st["counters"].get("map_assigned", 0)
                + st["counters"].get("reduce_assigned", 0))
    requeued = (st["counters"].get("map_retries", 0)
                + st["counters"].get("reduce_retries", 0))
    if (prom_value(text, "dgrep_map_phase_seconds_count") != 1
            or prom_value(text, "dgrep_reduce_phase_seconds_count") != 1
            or polls is None or scraped.get("rpcs") is None
            or not assigned <= polls <= scraped["rpcs"]
            or prom_value(text, "dgrep_tasks_requeued_total") != requeued):
        raise AssertionError(f"3d (b): /metrics disagrees with the job "
                             f"({st['counters']}, {scraped.get('rpcs')} "
                             f"AssignTask RPCs after it):\n{text}")
    out = WORK / "spans-trace.json"
    export = subprocess.run(
        [sys.executable, "-m", "distributed_grep_tpu_torch", "trace-export",
         str(job.work), "-o", str(out)],
        cwd=ROOT, capture_output=True, timeout=120)
    if export.returncode != 0:
        raise AssertionError(f"3d (b): trace-export exited "
                             f"{export.returncode}: {export.stderr[-500:]!r}")
    exported = json.loads(out.read_text())["traceEvents"]
    rows = {e["args"]["name"] for e in exported
            if e["ph"] == "M" and e["name"] == "thread_name"}
    events = EventLog.read(job.work / EventLog.FILENAME)
    assigns = [e for e in events if e.get("name") in ("assign_map",
                                                      "assign_reduce")]
    wids = sorted({e["args"]["worker"] for e in assigns})
    worker_rows = {f"worker {w}" for w in wids}
    if "coordinator" not in rows or not worker_rows <= rows or len(
            worker_rows) < len(job.workers):
        raise AssertionError(f"3d (b): trace rows {sorted(rows)} for "
                             f"workers {wids}")
    first = {}
    for w in wids:
        ts = [e["ts"] for e in assigns
              if e["name"] == "assign_map" and e["args"]["worker"] == w]
        if ts:
            first[w] = min(ts) - job.t0_wall
    spans_n = collections.Counter(e.get("name") for e in events)
    result["b config3 spans"] = {
        "wall_s": job.wall, **job.marks, "rows": sorted(rows),
        "worker_procs_started_s": [round(t - job.t0_wall, 6)
                                   for t in starts],
        "first_assign_map_s": {str(w): first[w] for w in sorted(first)},
        "map_task_spans": spans_n["map:task"],
        "reduce_task_spans": spans_n["reduce:task"],
        "assign_polls": polls, "assign_rpcs": scraped["rpcs"],
        "launches": st["launches"], "mr_out": "identical"}
    for w in sorted(first):
        log(f"3d (b) worker {w}: first assign_map {first[w]:.3f} s after "
            f"the coordinator's start (worker processes started at "
            + ", ".join(f"{t - job.t0_wall:.3f}" for t in starts)
            + f" s) [{card}]")
    splits = [worker_start_split(w) for w in job.workers]
    coord_ready = next((ts - job.t0_wall for ts, msg in log_lines(job.coord)
                        if msg.startswith("coordinator serving on")), None)
    result["b config3 spans"]["coordinator_ready_s"] = coord_ready
    result["b config3 spans"]["worker_start"] = splits
    for i, split in enumerate(splits):
        log(f"3d (b) worker process {i}: start split "
            + json.dumps({k: round(v, 3) for k, v in split.items()})
            + f"; the coordinator served from {coord_ready} s [{card}]")
    result["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3d: {json.dumps(result, sort_keys=True)}")
    return result


# Phase 3e: the shared tiers (the shard index and scan fusion)
TIERS_SMALL_FILES = 2000
TIERS_TOKEN_SMALL = 20  # small files the rare token is planted in
TIERS_TOKEN_LARGE = 2  # large files the rare token is planted in
TIERS_MIN_PRUNED_SMALL = 1900
TIERS_MIN_PRUNED_LARGE = 20
TIERS_INVERT_FILES = 250  # the -v jobs' small files (every line a record)
# 200 until run 17F, 120 until phase 3f came, 40 until phase 3g came
FUSE_SWEEP_DRAWS = 24
FUSE_SWEEP_BYTES = 4 << 20
FUSE_SWEEP_POOL = (8, 6, 14)  # literals, -F sets, regexes drawn once


def tiers_job(label: str, files: list, opts: dict, work: Path, workers: int,
              device: str, index_dir: Path, counters: dict,
              index_on: bool = True, host: bool = False) -> dict:
    """One run_job of phase 3e (a) in this process, with ``index_dir``:
    on the card through the grep_cuda module (its engine's totals read),
    or with ``host`` on the host engine (backend cpu, a fresh app).  A
    split of small files is one map task (batch_bytes 32 MiB, as the
    CLI's).  Returns its wall, mr-out hashes, the job's counters (the
    index's prunes and maybes the map attempts shipped) and the deltas of
    its engine's totals and of the kernel launches."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module
    from distributed_grep_tpu_torch.ops import engine as engine_mod
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    saved = os.environ.pop("DGREP_INDEX", None)
    if not index_on:
        os.environ["DGREP_INDEX"] = "0"
    # a fresh engine a job: the cross-job cache would hand the warm
    # 'volcano' job the cold one's engine, totals and all
    engine_mod.model_cache_clear()
    eng0 = grep_cuda._engine
    totals0 = dict(eng0.totals) if eng0 is not None else {}
    launches0 = {k: m.launches for k, m in counters.items()}
    t0 = time.perf_counter()
    try:
        res = run_job(JobConfig(
            input_files=[str(f) for f in files], batch_bytes=32 << 20,
            app_options={**opts, "index_dir": str(index_dir),
                         **({"backend": "cpu"} if host else {})},
            n_reduce=10, task_timeout_s=60.0,
            work_dir=str(work / f"job-{label}"), journal=False,
            durable=False),
            n_workers=workers, device=device,
            app=None if host else from_module(grep_cuda))
    finally:
        os.environ.pop("DGREP_INDEX", None)
        if saved is not None:
            os.environ["DGREP_INDEX"] = saved
    wall = time.perf_counter() - t0
    out = {"label": label, "wall": wall,
           "hashes": mr_out_hashes(res.output_files),
           "counters": dict(res.metrics["counters"]),
           "launches": {k: m.launches - launches0[k]
                        for k, m in counters.items()}}
    if not host:
        eng = grep_cuda._engine
        base = totals0 if eng is eng0 else {}
        out["totals"] = {k: v - base.get(k, 0) for k, v in eng.totals.items()
                         if isinstance(v, (int, float))}
    shutil.rmtree(res.metrics["work_dir"], ignore_errors=True)
    return out


def tiers_index(args, large: list[Path], small: list[Path], token: str,
                root: Path, device: str, counters: dict) -> list[str]:
    """Phase 3e (a): the shard index over the small tree and the large
    files, every job's mr-out held to the host engine's job with
    DGREP_INDEX=0 (the exact answer), the rare-token job's also to its
    DGREP_INDEX=0 twin on the card; the warm rare-token job's prunes against
    the summaries' own verdicts, its uploads against the unpruned
    shards."""
    from distributed_grep_tpu_torch.index import plan as index_plan
    from distributed_grep_tpu_torch.index import summary as index_summary

    idx = root / "idx"
    files = small + large
    rare = {"pattern": token}
    jobs = [
        ("cold volcano", files, {"pattern": "volcano"}),
        ("warm rare", files, rare),
        ("warm volcano", files, {"pattern": "volcano"}),
        # -v selects every other line: a quarter of the small tree
        ("warm -v rare", small[:TIERS_INVERT_FILES], {**rare,
                                                      "invert": True}),
    ]
    runs = {}
    for label, fs, opts in jobs:
        runs[label] = tiers_job(label, fs, opts, root, args.workers, device,
                                idx, counters)
    # what the summaries say of each file, before the twins run
    req = index_plan.requirements_for_query(pattern=token)
    verdicts = {}
    for f in files:
        summ = index_summary.lookup_summary(index_summary.file_key(f))
        if summ is None:
            raise AssertionError(f"index: no summary of {f} after the jobs")
        verdicts[f] = not req.may_match(summ)
    pruned_small = sum(verdicts[f] for f in small)
    pruned_large = sum(verdicts[f] for f in large)
    for f, cut in verdicts.items():
        if cut and token.encode() in f.read_bytes():
            raise AssertionError(f"index: {f} holds the token and its "
                                 f"summary rules it out")
    # the host engine's index-off jobs decide exactness; the card's own
    # index-off twin runs for the job that prunes
    twins = {"rare": tiers_job("off rare", files, rare, root, args.workers,
                               device, idx, counters, index_on=False)}
    for label, fs, opts in (("rare", files, rare),
                            ("volcano", files, {"pattern": "volcano"}),
                            ("-v rare", small[:TIERS_INVERT_FILES],
                             {**rare, "invert": True})):
        twins[f"host {label}"] = tiers_job(f"host {label}", fs, opts, root,
                                           args.workers, device, idx,
                                           counters, index_on=False,
                                           host=True)
    for label, others in (("cold volcano", ["host volcano"]),
                          ("warm rare", ["rare", "host rare"]),
                          ("warm volcano", ["host volcano"]),
                          ("warm -v rare", ["host -v rare"])):
        for other in others:
            if runs[label]["hashes"] != twins[other]["hashes"]:
                raise AssertionError(f"index: job {label!r}: mr-out differs "
                                     f"from {other!r}")
    warm = runs["warm rare"]
    c = warm["counters"]
    if (c.get("index_shards_pruned", 0) != pruned_small + pruned_large
            or pruned_small < min(TIERS_MIN_PRUNED_SMALL, len(small) - 20)
            or pruned_large < min(TIERS_MIN_PRUNED_LARGE, len(large) - 2)):
        raise AssertionError(
            f"index: warm rare job pruned {c.get('index_shards_pruned', 0)}; "
            f"the summaries rule out {pruned_small} of {len(small)} small and "
            f"{pruned_large} of {len(large)} large files")
    for label in ("warm volcano", "warm -v rare"):
        if runs[label]["counters"].get("index_shards_pruned"):
            raise AssertionError(f"index: {label} pruned "
                                 f"{runs[label]['counters']}")
    if not runs["cold volcano"]["totals"].get("uploads"):
        raise AssertionError(f"index: the cold job uploaded nothing "
                             f"{runs['cold volcano']['totals']}")
    # the warm rare job's uploads: the unpruned large files' segments and
    # at most one a batch window the card scanned (a window of the few
    # unpruned small files is under the small-input bound: the host)
    t = warm["totals"]
    large_segs = sum(-(-f.stat().st_size // (64 << 20)) for f in large
                     if not verdicts[f])
    windows = (t.get("batch_dispatches", 0) + t.get("solo_dispatches", 0)
               - t.get("small_host_scan", 0))
    if device == "cuda" and not (large_segs <= t.get("uploads", 0)
                                 <= large_segs + max(windows, 0)):
        raise AssertionError(f"index: warm rare job uploads {t} for "
                             f"{large_segs} unpruned large segments")
    if device == "cuda" and sum(warm["launches"].values()) > t.get(
            "uploads", 0) * 2:
        raise AssertionError(f"index: warm rare job launches "
                             f"{warm['launches']} for {t} uploads")
    lines = []
    for label, r in [*runs.items(), *((f"off {k}" if not k.startswith(
            "host") else k, v) for k, v in twins.items())]:
        c, t = r["counters"], r.get("totals", {})
        lines.append(
            f"index {label!r}: wall {r['wall']:.3f} s, index_shards_pruned "
            f"{c.get('index_shards_pruned', 0)}, index_maybe_scans "
            f"{c.get('index_maybe_scans', 0)}, index_bytes_skipped "
            f"{c.get('index_bytes_skipped', 0)}, uploads "
            f"{t.get('uploads', 0)}, file_reads {t.get('file_reads', 0)}, "
            f"launches {({k: v for k, v in r['launches'].items() if v})}")
    lines.append(
        f"index: {len(small)} small files, {len(large)} large; the token "
        f"{token!r} in {TIERS_TOKEN_SMALL} small and {TIERS_TOKEN_LARGE} "
        f"large; the warm rare job pruned {pruned_small} small and "
        f"{pruned_large} large files; every mr-out equal to the host "
        f"engine's with DGREP_INDEX=0, the rare job's also to its "
        f"DGREP_INDEX=0 twin on the card; "
        f"{len(list(idx.glob('*.tgs')))} summaries in the store")
    return lines


def fusion_splits(large: list[Path], max_bytes: int) -> list[list[Path]]:
    """Consecutive large files grouped into splits whose packed size (a
    file, and a '\n' where it ends without one) is at most ``max_bytes``
    (a fused attempt's whole-read bound): one packed window a split."""
    out, cur, size = [], [], 0
    for f in large:
        with open(f, "rb") as fh:
            fh.seek(-1, os.SEEK_END)
            n = f.stat().st_size + (fh.read(1) != b"\n")
        if cur and size + n > max_bytes:
            out.append(cur)
            cur, size = [], 0
        cur.append(f)
        size += n
    if cur:
        out.append(cur)
    return out


def tiers_fusion(large: list[Path], device: str, counters: dict
                 ) -> list[str]:
    """Phase 3e (b): FusedScanner.scan_batch over the large files, split
    as a fused attempt splits them and packed into one window a split, in
    the set mix and the regex mix (K = 4), each query's lines against its
    solo scan on the card; then map_fused_fn over one split, three
    participants with different options, against their solo records."""
    from distributed_grep_tpu_torch.apps.loader import load_application
    from distributed_grep_tpu_torch.ops import fuse as fuse_mod
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.runtime import fusion as fusion_mod

    set3 = [m.decode() for m in config3_set()]
    mixes = {
        "set mix": ([(None, tuple(set3[k * 250:(k + 1) * 250]), False)
                     for k in range(4)], "fdr"),
        "regex mix": ([("volcano", None, False), ("Volcano", None, True),
                       ("^the (old|new) ", None, False),
                       (CONFIG2, None, False)], "nfa"),
    }
    splits = fusion_splits(large, fusion_mod.MAX_FUSED_SPLIT_BYTES)
    # one packed window a split: every file under the small bound
    opts = {"device": device, "batch_bytes": fusion_mod.MAX_FUSED_SPLIT_BYTES,
            "device_min_bytes": 64 << 20}
    lines = []
    for label, (specs, kernel) in mixes.items():
        fuse_mod.fusion_counters_clear()
        before = {k: m.launches for k, m in counters.items()}
        t0 = time.perf_counter()
        fs = fuse_mod.FusedScanner(specs, **opts)
        fused: list[list] = [[] for _ in specs]
        segs = 0
        for split in splits:
            outs = fs.scan_batch([(f.name, str(f)) for f in split])
            segs += fs.union.stats.get("segments", 0)
            for k, per in enumerate(outs):
                fused[k].extend(per)
        fused_wall = time.perf_counter() - t0
        f_launch = {k: m.launches - before[k] for k, m in counters.items()}
        cc = fuse_mod.fusion_counters()
        solo_walls, s_total = [], 0
        for spec, got in zip(specs, fused):
            pat, pats, ic = spec
            before = {k: m.launches for k, m in counters.items()}
            t0 = time.perf_counter()
            eng = GrepEngine(pat, patterns=list(pats) if pats else None,
                             ignore_case=ic, **opts)
            want = [x for split in splits
                    for x in eng.scan_batch([(f.name, str(f))
                                             for f in split])]
            solo_walls.append(time.perf_counter() - t0)
            s_total += sum(m.launches - before[k]
                           for k, m in counters.items())
            if ([(n, r.matched_lines.tolist()) for n, r in got]
                    != [(n, r.matched_lines.tolist()) for n, r in want]):
                raise AssertionError(f"fusion {label}: query {spec[:1]} "
                                     f"differs from its solo scan")
        n_bytes = sum(f.stat().st_size for f in large)
        f_total = sum(f_launch.values())
        # one launch of the union's route a segment, for K queries
        if (device == "cuda" and (f_launch[kernel] != segs
                                  or f_total != segs
                                  or s_total < len(specs) * segs)) \
                or cc.get("fused_dispatches") != len(splits) \
                or cc.get("fusion_bytes_saved") != (len(specs) - 1) * n_bytes:
            raise AssertionError(
                f"fusion {label}: route {fs.union.route}, fused launches "
                f"{f_launch} over {segs} segments, solo launches {s_total}, "
                f"counters {cc}")
        lines.append(
            f"fusion {label} (K={len(specs)}, union route {fs.union.route}):"
            f" {len(splits)} windows, {segs} segments; fused wall "
            f"{fused_wall:.3f} s against solo walls "
            f"{', '.join(f'{w:.3f}' for w in solo_walls)} (sum "
            f"{sum(solo_walls):.3f} s, fused/sum "
            f"{fused_wall / sum(solo_walls):.3f}); launches fused "
            f"{({k: v for k, v in f_launch.items() if v})} ({f_total}) "
            f"against {s_total} solo; fused_dispatches "
            f"{cc['fused_dispatches']}, fusion_bytes_saved "
            f"{cc['fusion_bytes_saved']}; every query's lines equal its "
            f"solo scan's")

    # map_fused_fn: three participants of one split, options that differ
    split = splits[0][:2]
    items = [(f.name, str(f)) for f in split]
    popts = [{"pattern": "volcano", "word_regexp": True, **opts},
             {"pattern": "[a-z ]*volcano[a-z ]*", "line_regexp": True,
              **opts},
             {"pattern": "Volcano", "ignore_case": True, **opts}]
    parts = [{"job_id": f"p{j}", "app_options": o,
              "filenames": [f"/p{j}/{n}" for n, _ in items]}
             for j, o in enumerate(popts)]
    t0 = time.perf_counter()
    fused = load_application(
        "distributed_grep_tpu_torch.apps.grep_cuda").map_fused_fn(items,
                                                                  parts)
    fused_wall = time.perf_counter() - t0

    def kvs(records):
        return [(kv.key, kv.value) for r in records for kv in (
            r.to_keyvalues() if hasattr(r, "to_keyvalues") else [r])]

    n_rec = []
    for p, got in zip(parts, fused):
        solo = load_application("distributed_grep_tpu_torch.apps.grep_cuda",
                                **p["app_options"])
        want = kvs(solo.map_batch_fn([(nm, path) for nm, (_n, path)
                                      in zip(p["filenames"], items)]))
        if kvs(got) != want:
            raise AssertionError(f"map_fused_fn: participant "
                                 f"{p['app_options']} differs from its solo "
                                 f"records")
        n_rec.append(len(want))
    lines.append(f"map_fused_fn over {len(items)} files, 3 participants "
                 f"(-w, -x, -i): {fused_wall:.3f} s; records {n_rec}, each "
                 f"equal to its solo map_batch_fn's")
    return lines


def sweep_corpus(rng, n_bytes: int, samples) -> bytes:
    """``n_bytes`` of word lines over the lower-case letters and
    SWEEP_ALPHABET's upper case (the specs are drawn over SWEEP_ALPHABET,
    so most lines hold no match), with CR before some newlines, NUL and
    0xFF bytes, and each sample function's strings planted 40 times."""
    import numpy as np

    alphabet = np.frombuffer(
        ("abcdefghijklmnopqrstuvwxyz" + SWEEP_ALPHABET.upper() + " " * 5
         + "\n").encode(), np.uint8)
    buf = rng.choice(alphabet, size=n_bytes)
    nl = np.flatnonzero(buf == 10)
    cr = nl[rng.random(nl.size) < 0.05]
    buf[cr[cr > 0] - 1] = 13
    odd = rng.integers(0, n_bytes, size=n_bytes // 1000)
    buf[odd] = rng.choice(np.array([0, 255], np.uint8), size=odd.size)
    for sample in samples:
        for pos in rng.integers(0, n_bytes - 64, size=40):
            s = sample(rng).encode()[:60]
            buf[pos:pos + len(s)] = np.frombuffer(s, np.uint8)
    return buf.tobytes()


def re_oracle_lines(data: bytes, spec) -> list[int]:
    """The 1-based lines of ``data`` holding a match of ``spec`` by Python
    re (a set as escaped alternatives; -i folds ASCII as the engine does).
    No spec of the sweep matches across a newline, so the matches of one
    pass over the whole buffer mark every matching line."""
    import numpy as np

    pat, pats, ic = spec
    src = (b"|".join(re.escape(p.encode()) for p in pats) if pats
           else pat.encode())
    rx = re.compile(src, re.IGNORECASE if ic else 0)
    starts = np.fromiter((m.start() for m in rx.finditer(data)),
                         dtype=np.int64)
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    return np.unique(np.searchsorted(nl, starts) + 1).tolist()


def tiers_sweep(seed: int, device: str, counters: dict) -> list[str]:
    """Phase 3e (c): FUSE_SWEEP_DRAWS draws of K = 2..8 specs from a seeded
    pool (literals, -F sets, regexes of the NFA sweep's grammar, about a
    third -i) over FUSE_SWEEP_BYTES of word lines with CR, NUL and 0xFF;
    the small-input bound pinned to 0 (ROADMAP C8) so every union scan
    launches; each query's fused lines against its solo scan on the card
    and the re oracle.  A draw that raises FuseError is counted, not
    failed."""
    import numpy as np

    from distributed_grep_tpu_torch.ops import fuse as fuse_mod
    from distributed_grep_tpu_torch.ops.engine import GrepEngine

    rng = np.random.default_rng(seed)
    letters = list(SWEEP_ALPHABET)

    def word(lo, hi):
        return "".join(rng.choice(letters, size=int(rng.integers(lo, hi + 1))))

    n_lit, n_set, n_rx = FUSE_SWEEP_POOL
    pool, samples = [], []
    for _ in range(n_lit):
        w = word(3, 6)
        pool.append((w, None, bool(rng.random() < 0.3)))
        samples.append(lambda r, w=w: w)
    for _ in range(n_set):
        members = tuple(sorted({word(1, 5) for _ in range(
            int(rng.integers(2, 13)))}))
        pool.append((None, members, bool(rng.random() < 0.3)))
        samples.append(lambda r, m=members: m[int(r.integers(0, len(m)))])
    while len(pool) < n_lit + n_set + n_rx:
        # the grammar from depth 2: no quantifier inside a quantifier,
        # which keeps the re oracle's backtracking bounded
        parts = [rand_regex(rng, 2) for _ in range(int(rng.integers(1, 5)))]
        pat = "".join(p for p, _ in parts)
        if re.fullmatch(pat, "") is not None:
            continue  # a spec matching every line: nothing to fuse
        pool.append((pat, None, bool(rng.random() < 0.3)))
        samples.append(lambda r, parts=parts: "".join(f(r) for _, f in parts))
    data = sweep_corpus(rng, FUSE_SWEEP_BYTES, samples)
    solo = {}
    for spec in list(pool):
        pat, pats, ic = spec
        try:
            eng = GrepEngine(pat, patterns=list(pats) if pats else None,
                             ignore_case=ic, device=device)
        except ValueError:  # a draw the parser refuses: not in the pool
            pool.remove(spec)
            continue
        solo[spec] = eng.scan(data).matched_lines.tolist()
        if solo[spec] != re_oracle_lines(data, spec):
            raise AssertionError(f"sweep: solo scan of {spec} differs from "
                                 f"the re oracle")
    mismatches = fuse_errors = launched_draws = 0
    routes: dict = {}
    build_s = scan_s = 0.0
    t0 = time.perf_counter()
    for _ in range(FUSE_SWEEP_DRAWS):
        k = int(rng.integers(2, 9))
        specs = [pool[int(i)] for i in rng.choice(len(pool), size=k,
                                                  replace=False)]
        before = sum(m.launches for m in counters.values())
        t1 = time.perf_counter()
        try:
            fs = fuse_mod.FusedScanner(specs, device=device)
        except fuse_mod.FuseError:
            fuse_errors += 1
            continue
        finally:
            build_s += time.perf_counter() - t1
        t1 = time.perf_counter()
        res = fs.scan(data)
        scan_s += time.perf_counter() - t1
        if sum(m.launches for m in counters.values()) > before:
            launched_draws += 1
        elif device == "cuda":
            raise AssertionError(f"sweep: the union of {specs} (route "
                                 f"{fs.union.route}) launched no kernel")
        routes[fs.union.route] = routes.get(fs.union.route, 0) + 1
        for spec, r in zip(specs, res):
            if r.matched_lines.tolist() != solo[spec]:
                mismatches += 1
    if mismatches:
        raise AssertionError(f"sweep: {mismatches} fused queries differ from "
                             f"their solo scans and the re oracle")
    return [f"fused sweep: {FUSE_SWEEP_DRAWS} draws of K = 2..8 from a pool "
            f"of {len(pool)} specs over {len(data)} bytes: {mismatches} "
            f"mismatches, {fuse_errors} FuseError draws skipped, "
            f"{launched_draws} union scans launched, union routes {routes}; "
            f"{time.perf_counter() - t0:.1f} s (the unions' builds "
            f"{build_s:.1f} s, their scans and confirms {scan_s:.1f} s)"]


def phase_tiers(args, words: list[Path], card: str, counters: dict,
                device: str = "cuda") -> None:
    """Phase 3e (module docstring): the shard index and scan fusion, the
    launch counts zeroed just before and read just after.  The corpus
    cache is off for the phase (DGREP_CORPUS_BYTES=0): what the index
    saves shows as uploads and reads, and the solo passes it compares
    fusion with read and upload as the fused one does."""
    import numpy as np

    from distributed_grep_tpu_torch.index import summary as index_summary

    log(f"== phase 3e: the shared tiers (shard index, scan fusion), card: "
        f"{card}")
    t_phase = time.perf_counter()
    root = WORK / "tiers"
    saved = {k: os.environ.get(k) for k in ("DGREP_CORPUS_BYTES",
                                            "DGREP_DEVICE_MIN_BYTES")}
    os.environ["DGREP_CORPUS_BYTES"] = "0"
    for m in counters.values():
        m.reset_launches()
    try:
        t0 = time.perf_counter()
        large = cut_in_thirds(words, root / "large")
        make_small_tree(words[1], root / "tree", TIERS_SMALL_FILES,
                        seed=args.seed + 17)
        small = sorted(p for p in (root / "tree").rglob("*") if p.is_file())
        rng = np.random.default_rng(args.seed + 31)
        token = "qzj" + "".join(rng.choice(list("xkq0123456789"), size=7))
        line = f"a line with {token} in it\n".encode()
        for f in small:  # 'volcano' is in every file
            data = f.read_bytes()
            if b"volcano" not in data:
                f.write_bytes(data + b"the volcano line\n")
        for f in [*(small[int(i)] for i in rng.choice(
                len(small), TIERS_TOKEN_SMALL, replace=False)),
                  *(large[int(i)] for i in rng.choice(
                      len(large), TIERS_TOKEN_LARGE, replace=False))]:
            with open(f, "ab") as fh:
                fh.write(line)
        log(f"phase 3e corpus: {len(small)} small files, {len(large)} large "
            f"({sum(f.stat().st_size for f in large)} bytes), "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        for ln in tiers_index(args, large, small, token, root, device,
                              counters):
            log(f"{ln} [{card}]")
        index_summary.clear()  # detach the store: (b) and (c) scan all
        log(f"phase 3e (a): {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        # the fused mixes over a sixth of the large files (all 24 until
        # phase 3g came, a third until phase 3h's pattern axis)
        for ln in tiers_fusion(large[:len(large) // 6], device, counters):
            log(f"{ln} [{card}]")
        log(f"phase 3e (b): {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        os.environ["DGREP_DEVICE_MIN_BYTES"] = "0"
        for ln in tiers_sweep(args.seed + 4949, device, counters):
            log(f"{ln} [{card}]")
        log(f"phase 3e (c): {time.perf_counter() - t0:.1f} s [{card}]")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        index_summary.clear()
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: m.launches for k, m in counters.items()}
    if device == "cuda" and not all(launches[k] for k in ("shift_and", "fdr",
                                                          "nfa")):
        raise AssertionError(f"phase 3e: launches {launches}")
    log(f"phase 3e launches in this process: {launches}; "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")


# phase 3f's tenants: phase 3's in-process jobs of these labels give
# their mr-out hashes and their solo walls
SERVICE_QUERIES = ("volcano", "-i Volcano", "config3 -f", "^the (old|new) ")
SERVICE_TIMEOUT_S = 60.0  # the 3f jobs' task_timeout_s


def service_options(set3: list[bytes]) -> dict:
    """The app options of phase 3f's tenants: phase 3's, the set's
    members as str (a job config is JSON)."""
    return {
        "volcano": {"pattern": "volcano", "ignore_case": False},
        "-i Volcano": {"pattern": "Volcano", "ignore_case": True},
        "config3 -f": {"patterns": [m.decode() for m in set3]},
        "^the (old|new) ": {"pattern": "^the (old|new) ",
                            "ignore_case": False},
    }


def service_events(root: Path, job_id: str) -> list[dict]:
    from distributed_grep_tpu_torch.utils.spans import EventLog

    return EventLog.read(root / job_id / "events.jsonl")


def wait_service_jobs(svc, jids, timeout: float = 600.0) -> None:
    for j in jids:
        if not svc.wait_job(j, timeout=timeout):
            raise AssertionError(f"service job {j} did not end: "
                                 f"{svc.job_status(j)}")
        st = svc.job_status(j)
        if st["state"] != "done":
            raise AssertionError(f"service job {j} ended {st['state']}: "
                                 f"{st.get('error')}")


def collated_hash(paths) -> str:
    """sha256 of a job's records (its outputs' lines, sorted): a result-cache
    hit writes its stored blobs, not mr-out-* files, so its records are
    compared laid out as one sorted stream."""
    import hashlib

    lines = []
    for p in paths:
        lines.extend(ln for ln in Path(p).read_bytes().splitlines(
            keepends=True) if ln.strip())
    return hashlib.sha256(b"".join(sorted(lines))).hexdigest()


def phase_service(words: list[Path], set3: list[bytes], inproc: dict,
                  solo_walls: dict, card: str, counters: dict) -> None:
    """Phase 3f (module docstring): the service daemon in this process, the
    launch counts zeroed just before each part and read just after."""
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.ops import engine as engine_mod
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
    )
    from distributed_grep_tpu_torch.utils.config import JobConfig

    log(f"== phase 3f: the service daemon, card: {card}")
    t_phase = time.perf_counter()
    opts = service_options(set3)
    files = [str(p) for p in words]
    segs = sum(-(-p.stat().st_size // (64 << 20)) for p in words)
    # the shard index off: its trigram pass is phase 3e's to measure
    saved = {k: os.environ.get(k) for k in ("DGREP_INDEX",
                                             "DGREP_RESULT_CACHE")}
    os.environ["DGREP_INDEX"] = "0"

    def job(label: str) -> JobConfig:
        return JobConfig(input_files=files, app_options=dict(opts[label]),
                         n_reduce=10, task_timeout_s=SERVICE_TIMEOUT_S,
                         journal=False, durable=False)

    def check_hashes(part: str, svc, jids: dict) -> None:
        for label, j in jids.items():
            got = mr_out_hashes(svc.job_result(j)["outputs"])
            if got != inproc[label]:
                raise AssertionError(f"phase 3f {part}: {label!r}'s mr-out "
                                     f"differs from phase 3's job")

    def zero() -> dict:
        for m in counters.values():
            m.reset_launches()
        return {k: m.launches for k, m in counters.items()}

    def launched(before: dict) -> dict:
        return {k: m.launches - before[k] for k, m in counters.items()
                if m.launches - before[k]}

    root = WORK / "service"
    svc = GrepService(work_root=root, spans=True,
                      task_timeout_s=SERVICE_TIMEOUT_S)
    server = ServiceServer(svc)
    server.start()
    svc_b = None
    appended = None
    try:
        # (a) four tenants submitted to a daemon with no worker, then two
        # local workers (the second once the first fused assignment is
        # out); the result cache is on (the daemon's default): they publish
        before = zero()
        t0 = time.perf_counter()
        jids = {label: svc.submit(job(label)) for label in SERVICE_QUERIES}
        svc.start_local_workers(1)
        deadline = time.monotonic() + 120
        while not svc.status().get("fusion", {}).get("fused_dispatches"):
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 3f (a): no fused assignment: "
                                     f"{svc.status()}")
            time.sleep(0.01)
        svc.start_local_workers(1)
        wait_service_jobs(svc, jids.values())
        wall_a = time.perf_counter() - t0
        got = launched(before)
        fusion = svc.status()["fusion"]
        check_hashes("(a)", svc, jids)
        # the three pattern tenants fuse (an NFA union, one launch a
        # segment); the set runs solo on FDR (runtime/fusion.query_family).
        # A claim that loses a race to another worker's assignment of the
        # same task leaves that task to scan solo (its own route: Shift-And
        # or the NFA): each of the three tenants' splits is scanned once,
        # by a fused dispatch or alone
        per_file = segs // len(words)
        alone = 3 * len(words) - fusion["fused_jobs"]
        if (not fusion["fused_dispatches"] or got.get("fdr") != segs
                or set(got) - {"nfa", "fdr", "shift_and"}
                or got.get("nfa", 0) + got.get("shift_and", 0)
                != (fusion["fused_dispatches"] + alone) * per_file):
            raise AssertionError(f"phase 3f (a): fusion {fusion}, launches "
                                 f"{got} for {segs} segments a route")
        solo = sum(solo_walls[label] for label in SERVICE_QUERIES)
        fused_solo = sum(solo_walls[label] for label in SERVICE_QUERIES
                         if label != "config3 -f")
        log(f"phase 3f (a) four tenants ({', '.join(SERVICE_QUERIES)}) over "
            f"{len(words)} word files, 2 local workers: {wall_a:.3f} s "
            f"against {solo:.3f} s of phase 3's four solo jobs "
            f"({wall_a / solo:.3f}x); fused_dispatches "
            f"{fusion['fused_dispatches']}, fused_jobs {fusion['fused_jobs']},"
            f" fusion_bytes_saved {fusion['fusion_bytes_saved']} (the three "
            f"pattern tenants' solo walls {fused_solo:.3f} s); launches {got}"
            f" for {segs} segments: one union launch a segment a fused "
            f"dispatch, {alone} pattern task(s) alone, one FDR launch a "
            f"segment for the set; every tenant's mr-out equal to phase "
            f"3's [{card}]")
        first_a = min(e["ts"] for j in jids.values()
                      for e in service_events(root, j)
                      if e.get("name") == "assign_map") - svc.started_at
        cold_hash = collated_hash(svc.job_result(jids["volcano"])["outputs"])

        # (d) the result cache: 'volcano' again, every split from the store
        before = zero()
        t0 = time.perf_counter()
        jd = svc.submit(job("volcano"))
        wait_service_jobs(svc, [jd])
        wall_d = time.perf_counter() - t0
        got_d = launched(before)
        rec_d = svc.record(jd)
        assigns = [e for e in service_events(root, jd)
                   if e.get("name") in ("assign_map", "assign_reduce")]
        if (got_d or rec_d.scheduler is not None or assigns
                or rec_d.result_splits_reused != len(words)
                or collated_hash(svc.job_result(jd)["outputs"])
                != cold_hash):
            raise AssertionError(f"phase 3f (d): launches {got_d}, "
                                 f"scheduler {rec_d.scheduler}, assigns "
                                 f"{len(assigns)}, reused "
                                 f"{rec_d.result_splits_reused}")

        # (e) explain: a fused tenant of (a), and (d)'s hit
        fused_doc = None
        for label in ("volcano", "-i Volcano", "^the (old|new) "):
            doc = svc.job_explain(jids[label])
            if "nfa" in doc["routing"]["engine_modes"]:
                fused_doc = doc
                break
        hit_doc = svc.job_explain(jd)
        if (fused_doc is None or fused_doc["routing"]["route"] != "device"
                or not fused_doc["routing"].get("fusion")
                or hit_doc["routing"]["result_cache"].get(
                    "planner_splits_reused") != len(words)):
            raise AssertionError(f"phase 3f (e): fused {fused_doc}, hit "
                                 f"{hit_doc}")

        # (b) the warm resubmit on a second daemon of this process with the
        # result cache off (a hit would build nothing either way): its
        # workers' apps are new, each map asks the cross-job engine cache
        os.environ["DGREP_RESULT_CACHE"] = "0"
        svc_b = GrepService(work_root=WORK / "service-b", spans=True,
                            task_timeout_s=SERVICE_TIMEOUT_S)
        svc_b.start_local_workers(2)
        cache0 = engine_mod.model_cache_counters()
        before = zero()
        t0 = time.perf_counter()
        jb = svc_b.submit(job("volcano"))
        wait_service_jobs(svc_b, [jb])
        wall_b = time.perf_counter() - t0
        got_b = launched(before)
        cache1 = engine_mod.model_cache_counters()
        check_hashes("(b)", svc_b, {"volcano": jb})
        names = [e.get("name") for e in service_events(WORK / "service-b",
                                                       jb)]
        hits = names.count("cache:hit")
        if (not hits or "cache:miss" in names
                or cache1["compile_cache_misses"]
                != cache0["compile_cache_misses"]):
            raise AssertionError(f"phase 3f (b): cache instants "
                                 f"{[n for n in names if n.startswith('cache:')]}"
                                 f", counters {cache0} -> {cache1}")
        log(f"phase 3f (b) warm resubmit of 'volcano': {wall_b:.3f} s "
            f"against phase 3's {solo_walls['volcano']:.3f} s; {hits} "
            f"cache:hit, no cache:miss, compile_cache {cache1} (misses "
            f"unchanged: no build); launches {got_b}; mr-out equal [{card}]")

        # (d) continued: 1 MiB of word lines holding 'volcano' (1 in 64)
        # appended to one file: only its split scans, its segments' launches
        import numpy as np

        rng = np.random.default_rng(19)
        extra = bytearray(words_block(rng, 1 << 20).tobytes())
        lines = bytes(extra).split(b"\n")
        extra = b"\n".join(ln + (b" volcano" if i % 64 == 0 else b"")
                           for i, ln in enumerate(lines[:-1])) + b"\n"
        appended = (words[0], words[0].stat().st_size)
        with open(words[0], "ab") as f:
            f.write(extra)
        before = zero()
        t0 = time.perf_counter()
        jp = svc.submit(job("volcano"))
        wait_service_jobs(svc, [jp])
        wall_p = time.perf_counter() - t0
        got_p = launched(before)
        rec_p = svc.record(jp)
        # scan_file reads a file in 64 MiB blocks, one scan (one segment,
        # one Shift-And filter launch) a block
        want_p = -(-words[0].stat().st_size // (64 << 20))
        t0 = time.perf_counter()
        jc = svc_b.submit(job("volcano"))  # the cold job, the cache off
        wait_service_jobs(svc_b, [jc])
        wall_cold = time.perf_counter() - t0
        if (len(rec_p.map_splits) != 1
                or rec_p.result_splits_reused != len(words) - 1
                or got_p != {"shift_and": want_p}
                or collated_hash(svc.job_result(jp)["outputs"])
                != collated_hash(svc_b.job_result(jc)["outputs"])):
            raise AssertionError(f"phase 3f (d): partial hit scanned "
                                 f"{len(rec_p.map_splits)} splits, reused "
                                 f"{rec_p.result_splits_reused}, launches "
                                 f"{got_p} (want {want_p} shift_and)")
        os.truncate(words[0], appended[1])  # phase 3's bytes again
        appended = None
        rc = svc.status()["result_cache"]
        log(f"phase 3f (d) result cache: 'volcano' resubmitted, a full hit "
            f"in {wall_d:.3f} s: {rec_d.result_splits_reused} splits reused, "
            f"{rec_d.result_bytes_unscanned} bytes unscanned, no worker "
            f"assignment, launches {got_d or 0}, records equal (a)'s; then "
            f"1 MiB appended to {words[0].name}: a partial hit in "
            f"{wall_p:.3f} s, 1 split scanned, {rec_p.result_splits_reused} "
            f"reused, launches {got_p} for its {want_p} segments; records "
            f"equal to a cold job with DGREP_RESULT_CACHE=0 "
            f"({wall_cold:.3f} s); /status result_cache {rc} [{card}]")

        # (e) continued: an all_lines query ('a*') over 1 MiB: on the host
        small = WORK / "service-all" / "small.txt"
        small.parent.mkdir(parents=True, exist_ok=True)
        small.write_bytes(extra)
        before = zero()
        ja = svc.submit(JobConfig(input_files=[str(small)],
                                  app_options={"pattern": "a*"}, n_reduce=2,
                                  task_timeout_s=SERVICE_TIMEOUT_S,
                                  journal=False, durable=False))
        wait_service_jobs(svc, [ja])
        got_all = launched(before)
        all_doc = svc.job_explain(ja)
        if (got_all or all_doc["routing"]["route"] != "host"
                or set(all_doc["routing"]["engine_modes"]) != {"all_lines"}):
            raise AssertionError(f"phase 3f (e): 'a*' launches {got_all}, "
                                 f"report {all_doc['routing']}")
        modes = fused_doc["routing"]["engine_modes"]
        log(f"phase 3f (e) explain: {fused_doc['job_id']} (a fused tenant of "
            f"(a)) route {fused_doc['routing']['route']}, engine_modes "
            f"{ {m: r['scans'] for m, r in modes.items()} }, fusion "
            f"{fused_doc['routing']['fusion']}; (d)'s hit result_cache "
            f"{hit_doc['routing']['result_cache']}; 'a*' route "
            f"{all_doc['routing']['route']}, modes "
            f"{list(all_doc['routing']['engine_modes'])}, launches "
            f"{got_all or 0} [{card}]")

        # (f) standing queries, the small-input bound at 0
        follow_line = service_follow(svc, server, words, zero, launched)
        log(f"phase 3f (f) {follow_line} [{card}]")
    finally:
        if appended is not None:
            os.truncate(*appended)
        server.shutdown()
        svc.stop()
        if svc_b is not None:
            svc_b.stop()
        grep_cuda._configured_with = None
        if saved["DGREP_RESULT_CACHE"] is None:
            os.environ.pop("DGREP_RESULT_CACHE", None)
        else:
            os.environ["DGREP_RESULT_CACHE"] = saved["DGREP_RESULT_CACHE"]

    # (c) a worker process attached to a daemon with no local worker,
    # serving two jobs through one attach over /data/<job>/
    root_c = WORK / "service-c"
    t_start = time.time()
    svc = GrepService(work_root=root_c, spans=True,
                      task_timeout_s=SERVICE_TIMEOUT_S)
    server = ServiceServer(svc)
    server.start()
    worker = None
    try:
        t0 = time.perf_counter()
        worker = port_proc(["worker", "--addr", f"127.0.0.1:{server.port}"])
        jids = {label: svc.submit(job(label))
                for label in ("volcano", "-i Volcano")}
        wait_service_jobs(svc, jids.values())
        wall_c = time.perf_counter() - t0
        check_hashes("(c)", svc, jids)
        status = svc.status()
        shipped = {}
        for j in jids.values():
            for k, v in svc.job_status(j)["metrics"]["launches"].items():
                shipped[k] = shipped.get(k, 0) + v
        first_c = min(e["ts"] for j in jids.values()
                      for e in service_events(root_c, j)
                      if e.get("name") == "assign_map") - t_start
        if len(status["workers"]) != 1 or not sum(shipped.values()):
            raise AssertionError(f"phase 3f (c): workers "
                                 f"{status['workers']}, shipped launches "
                                 f"{shipped}")
        log(f"phase 3f (c) a worker process, one attach, 2 jobs (volcano, "
            f"-i Volcano) over /data/<job>/: {wall_c:.3f} s from its start; "
            f"its first assign_map {first_c:.3f} s after the daemon's start "
            f"(phase (a)'s local workers: {first_a:.3f} s); shipped launches "
            f"{shipped}; fusion {status.get('fusion', {})}; mr-out equal "
            f"[{card}]")
    finally:
        t_stop = time.perf_counter()
        svc.stop()
        server.shutdown(linger_s=0.5)
        if worker is not None:
            try:
                worker.wait(timeout=30)
            except subprocess.TimeoutExpired:
                worker.kill()
                worker.wait()
            worker.drainer.join(timeout=5)
        if saved["DGREP_INDEX"] is None:
            os.environ.pop("DGREP_INDEX", None)
        else:
            os.environ["DGREP_INDEX"] = saved["DGREP_INDEX"]
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(root_c, ignore_errors=True)
        shutil.rmtree(WORK / "service-b", ignore_errors=True)
        shutil.rmtree(WORK / "service-all", ignore_errors=True)
    if worker.returncode != 0:
        raise AssertionError(f"phase 3f (c): the worker exited "
                             f"{worker.returncode}: "
                             f"{''.join(worker.err_lines)[-2000:]}")
    log(f"phase 3f (c) the worker process exited "
        f"{worker.ended_at - t_stop:.3f} s after the daemon's stop (C9)")

    # (g) the elastic pool and the consoles
    log(f"phase 3f (g) {service_pool(words)} [{card}]")
    log(f"phase 3f: {time.perf_counter() - t_phase:.1f} s [{card}]")


FAILOVER_TIMEOUT_S = 10.0  # the 3g daemons' task_timeout_s
# phase 3g's worker processes: a dead peer's fetch gives up in about 1.4 s
# ((a), (b)); over an address list the retries span a promotion ((c))
PEER_WORKER_ENV = {"DGREP_LOG": "INFO", "DGREP_RPC_RETRIES": "3",
                   "DGREP_RPC_BACKOFF_S": "0.2"}
HA_WORKER_ENV = {"DGREP_LOG": "INFO", "DGREP_RPC_RETRIES": "8",
                 "DGREP_RPC_BACKOFF_S": "0.2"}
HA_TTL_S = "2"


def http_status(addr: str, path: str = "/status") -> dict | None:
    """One GET of a daemon, None when it does not answer JSON."""
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{addr}{path}",
                                    timeout=5) as resp:
            return json.loads(resp.read())
    except (OSError, ValueError):
        return None


def wait_for(what: str, pred, timeout: float, poll_s: float = 0.02):
    """Poll ``pred`` until it returns something truthy; its value."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 3g: {what} not within {timeout} s")
        time.sleep(poll_s)


def peer_endpoint_of(proc) -> str | None:
    """The peer data server a worker process logged (DGREP_LOG=INFO)."""
    for line in proc.err_lines:
        m = re.search(r"peer shuffle data server on (http://\S+)", line)
        if m:
            return m.group(1)
    return None


def end_procs(procs, sig=signal.SIGKILL) -> None:
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.send_signal(sig)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def phase_failover(words: list[Path], set3: list[bytes], inproc: dict,
                   card: str) -> None:
    """Phase 3g (module docstring): the peer shuffle, a lost output and a
    failover, through worker and daemon processes on the card."""
    from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
    )
    from distributed_grep_tpu_torch.utils.config import JobConfig

    log(f"== phase 3g: failover and the peer data plane, card: {card}")
    t_phase = time.perf_counter()
    opts = service_options(set3)
    files = [str(p) for p in words]
    per_file = -(-words[0].stat().st_size // (64 << 20))
    segs = per_file * len(words)
    saved = {k: os.environ.get(k) for k in ("DGREP_INDEX",
                                             "DGREP_RESULT_CACHE")}
    os.environ["DGREP_INDEX"] = "0"
    os.environ["DGREP_RESULT_CACHE"] = "0"

    def job(label: str) -> JobConfig:
        return JobConfig(input_files=files, app_options=dict(opts[label]),
                         n_reduce=10, task_timeout_s=FAILOVER_TIMEOUT_S,
                         journal=False, durable=False)

    def shipped_of(st: dict) -> dict:
        return dict(st["metrics"].get("launches") or {})

    root_a = WORK / "failover-a"
    svc = GrepService(work_root=root_a, task_timeout_s=FAILOVER_TIMEOUT_S)
    server = ServiceServer(svc)
    server.start()
    addr = f"127.0.0.1:{server.port}"
    workers: list = []
    try:
        # (a) two worker processes on the peer shuffle: volcano (Shift-And)
        # and config 3's set (FDR); the daemon moves metadata only
        t0 = time.perf_counter()
        workers = [port_proc(["worker", "--addr", addr], env=PEER_WORKER_ENV)
                   for _ in range(2)]
        wait_for("two worker processes attached",
                 lambda: len(svc.status()["workers"]) == 2, 180)
        t_attach = time.perf_counter() - t0
        wait_for("the peer endpoints logged",
                 lambda: all(peer_endpoint_of(w) for w in workers), 30)
        endpoints = {peer_endpoint_of(w): w for w in workers}
        if None in endpoints or len(endpoints) != 2:
            raise AssertionError(f"phase 3g (a): peer endpoints {endpoints}")
        t0 = time.perf_counter()
        jids = {label: svc.submit(job(label))
                for label in ("volcano", "config3 -f")}
        wait_service_jobs(svc, jids.values())
        wall_a = time.perf_counter() - t0
        shipped, fetches = {}, 0
        for label, j in jids.items():
            st = svc.job_status(j)
            if mr_out_hashes(svc.job_result(j)["outputs"]) != inproc[label]:
                raise AssertionError(f"phase 3g (a): {label!r}'s mr-out "
                                     f"differs from phase 3's job")
            for k, v in shipped_of(st).items():
                shipped[k] = shipped.get(k, 0) + v
            fetches += st["metrics"]["counters"].get("peer_fetches", 0)
        relay = dict(svc._shuffle_stats)
        rows = svc.status()["workers"]
        if (relay["daemon_shuffle_bytes"] or not fetches
                or shipped.get("shift_and", 0) < segs
                or shipped.get("fdr", 0) < segs
                or sorted(r.get("data_endpoint") for r in rows.values())
                != sorted(endpoints)):
            raise AssertionError(f"phase 3g (a): relay {relay}, "
                                 f"peer_fetches {fetches}, shipped {shipped}"
                                 f", rows {rows}")
        log(f"phase 3g (a) peer shuffle: 2 worker processes attached "
            f"{t_attach:.3f} s after their start; volcano and config 3's set "
            f"over {len(words)} word files in {wall_a:.3f} s; daemon relay "
            f"bytes {relay['daemon_shuffle_bytes']} (puts "
            f"{relay['relay_puts']}, gets {relay['relay_gets']}); "
            f"peer_fetches {fetches}; shipped launches {shipped}; both "
            f"mr-out equal phase 3's [{card}]")

        # (b) one worker SIGKILLed once a map of its own committed and
        # before the map phase ends (so no reducer has fetched it): the
        # reducer's fetch fails, the map runs again on the other worker
        t0 = time.perf_counter()
        jb = svc.submit(job("volcano"))
        sched = wait_for("(b)'s scheduler",
                         lambda: svc.record(jb).scheduler, 60)

        def first_commit():
            for t in sched.map_tasks:
                if t.peer and t.state.value == "completed":
                    return t
            return None

        task = wait_for("(b)'s first map commit", first_commit, 300, 0.005)
        victim = endpoints.get(task.peer["endpoint"])
        done_at_kill = sched.status_counts()["map"]["completed"]
        end_procs([victim])
        t_kill = time.perf_counter()
        if victim is None or done_at_kill >= len(words):
            raise AssertionError(f"phase 3g (b): producer {task.peer} of "
                                 f"map {task.task_id}, {done_at_kill} maps "
                                 f"done at the kill")
        wait_service_jobs(svc, [jb])
        wall_b = time.perf_counter() - t_kill
        st = svc.job_status(jb)
        lost = st["metrics"]["counters"].get("maps_lost_output", 0)
        shipped_b = shipped_of(st)
        if (lost < 1 or shipped_b.get("shift_and", 0) < segs + per_file
                or mr_out_hashes(svc.job_result(jb)["outputs"])
                != inproc["volcano"]):
            raise AssertionError(f"phase 3g (b): maps_lost_output {lost}, "
                                 f"shipped {shipped_b} (a clean run ships "
                                 f"{segs})")
        log(f"phase 3g (b) lost output: the producer of map "
            f"{task.task_id} SIGKILLed {t_kill - t0:.3f} s after the submit "
            f"({done_at_kill} of {len(words)} maps committed); "
            f"maps_lost_output {lost}, shipped shift_and "
            f"{shipped_b.get('shift_and', 0)} (a clean run's {segs}); the "
            f"job ended {wall_b:.3f} s after the kill (the dead worker's "
            f"map in flight re-issued after the {FAILOVER_TIMEOUT_S:.0f} s "
            f"timeout); mr-out equal phase 3's [{card}]")
    finally:
        svc.stop()
        server.shutdown(linger_s=0.5)
        end_procs(workers)
        shutil.rmtree(root_a, ignore_errors=True)

    # (c) an active and a ``serve --standby`` on one work root (lease TTL
    # 2 s), two workers and the submit on both addresses; the active
    # SIGKILLed after the first map commit
    root_c = WORK / "failover-c"
    ha_env = {"DGREP_LEASE_TTL_S": HA_TTL_S, "DGREP_LOG": "INFO"}
    port_a, port_b = free_port(), free_port()
    a_addr, b_addr = f"127.0.0.1:{port_a}", f"127.0.0.1:{port_b}"
    addrs = f"{a_addr},{b_addr}"
    procs: list = []
    active = standby = submit = None
    try:
        t0 = time.perf_counter()
        active = port_proc(["serve", "--port", str(port_a), "--workers", "0",
                            "--work-root", str(root_c)], env=ha_env)
        procs.append(active)
        wait_for("the active", lambda: (http_status(a_addr) or {}).get(
            "role") == "active", 180, 0.1)
        standby = port_proc(["serve", "--standby", "--port", str(port_b),
                             "--workers", "0", "--work-root", str(root_c)],
                            env=ha_env)
        procs.append(standby)
        for _ in range(2):
            procs.append(port_proc(["worker", "--addr", addrs],
                                   env=HA_WORKER_ENV))
        wait_for("the standby", lambda: (http_status(b_addr) or {}).get(
            "role") == "standby", 180, 0.1)
        wait_for("two workers on the active", lambda: len(
            (http_status(a_addr) or {}).get("workers", {})) == 2, 180, 0.1)
        t_ready = time.perf_counter() - t0
        submit = port_proc(["submit", "--addr", addrs, "--n-reduce", "10",
                            "--timeout", "600", "volcano", *files])
        procs.append(submit)

        def committed():
            st = http_status(a_addr) or {}
            return [j for j, row in st.get("jobs", {}).items()
                    if row.get("map_completed", 0) >= 1]

        jobs_a = wait_for("the first map commit on the active", committed,
                          300)
        end_procs([active])
        t_kill = time.perf_counter()
        wait_for("the promotion", lambda: (http_status(b_addr) or {}).get(
            "role") == "active", 120, 0.05)
        t_promoted = time.perf_counter() - t_kill
        submit.wait(timeout=600)
        submit.drainer.join(timeout=5)
        t_end = submit.ended_at - t_kill
        out = submit.stdout.read().decode().strip().splitlines()
        doc = json.loads(out[-1]) if out else {}
        status_b = http_status(b_addr) or {}
        steals = [e for e in DaemonLog.read(root_c)
                  if e["kind"] == "lease_steal"]
        promoted = [e for e in DaemonLog.read(root_c)
                    if e["kind"] == "promoted"]
        job_b = http_status(b_addr, f"/jobs/{doc.get('job_id')}") or {}
        shipped_c = shipped_of(job_b) if job_b.get("metrics") else {}
        if (submit.returncode != 0 or doc.get("state") != "done"
                or len(out) != 1 or jobs_a != [doc["job_id"]]
                or list(status_b.get("jobs", {})) != [doc["job_id"]]
                or [e["epoch"] for e in steals] != [2]
                or mr_out_hashes(doc["outputs"]) != inproc["volcano"]):
            raise AssertionError(f"phase 3g (c): submit rc "
                                 f"{submit.returncode} {out[-3:]}, jobs "
                                 f"{jobs_a} / {list(status_b.get('jobs', {}))}"
                                 f", steals {steals}, shipped {shipped_c}, "
                                 f"standby log "
                                 f"{''.join(standby.err_lines)[-1500:]}")
        failover_s = (promoted[0]["payload"]["failover_s"] if promoted
                      else None)
        log(f"phase 3g (c) failover: the active, the standby and 2 workers "
            f"ready {t_ready:.3f} s after the active's start; the active "
            f"SIGKILLed after the first map commit of {doc['job_id']}; the "
            f"standby promoted (epoch 2, lease_steal in daemon.jsonl) "
            f"{t_promoted:.3f} s after the kill (its own failover_s "
            f"{failover_s}), the job done {t_end:.3f} s after the kill; one "
            f"job id; shipped launches after the promotion {shipped_c}; "
            f"mr-out equal phase 3's [{card}]")
    finally:
        end_procs([standby], signal.SIGTERM)
        end_procs(procs)
        shutil.rmtree(root_c, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"phase 3g: {time.perf_counter() - t_phase:.1f} s [{card}]")


# Phase 3h's engine queries: (label, engine arguments, the kernel whose
# launches the mesh multiplies, the kernel table's row)
MULTI_QUERIES = (
    ("volcano", {"pattern": "volcano"}, "shift_and", 1),
    ("^the (old|new) ", {"pattern": "^the (old|new) "}, "nfa", 3),
    ("config2", {"pattern": CONFIG2}, "fdr", 4),
    ("config3 -f", {"patterns": "config3"}, "fdr", 4),
    ("zq set", {"patterns": PAIR_SET}, "pairset", 5),
    ("--max-errors 1 volcano", {"pattern": "volcano", "max_errors": 1},
     "approx", 6),
)


def phase_multi_gpu(path: Path, set3: list[bytes], card: str,
                    counters: dict) -> None:
    """Phase 3h: multi-GPU on one host (parallel/, the engine's
    ``devices`` and ``mesh``), over one 128 MiB word file.  The mesh spans
    every card when the host has two or more, else four entries of
    cuda:0 (the counterpart of the reference's forced host device count:
    the lane split, the launches a block and the reassembly run on the
    real kernels, on one card).  Each engine query (rows 1 and 3-6) on the
    mesh gives the single-device engine's lines; its kernel launches are
    the entries times the single-device engine's; its
    ``psum_candidates`` equals a one-entry mesh's, the single-device
    nonzero-word count; and on the file's first 64 MiB segment each
    sharded kernel's words equal the single-device kernel's bit for bit.
    '^$' on a mesh engine routes "dfa" (K1 on the first entry, launched)
    with GNU grep's lines; ``run_job`` of volcano with a two-entry
    ``devices`` list and with ``mesh_shape: [4]`` give the one-card job's
    mr-out bytes; ``sharded_grep_step`` on needle counts at least one
    match, with K1's plain exit states and words."""
    import numpy as np
    import torch

    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.apps.loader import from_module
    from distributed_grep_tpu_torch.models import dfa as dfa_mod
    from distributed_grep_tpu_torch.ops import (
        approx_scan,
        cuda_scan,
        dfa_scan,
        engine as engine_mod,
        fdr_scan,
        nfa_scan,
        pairset_scan,
        swar_scan,
    )
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.parallel import sharded_kernels as shk
    from distributed_grep_tpu_torch.parallel import (
        make_mesh,
        sharded_grep_step,
    )
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    t_phase = time.perf_counter()
    log(f"== phase 3h: multi-GPU on one host, card: {card}")
    n_cards = torch.cuda.device_count()
    entries = ([f"cuda:{i}" for i in range(n_cards)] if n_cards >= 2
               else ["cuda:0"] * 4)
    mesh = make_mesh((len(entries),), ("data",), devices=entries)
    one = make_mesh((1,), ("data",), devices=["cuda:0"])
    tag = f"cards {mesh.cards}, mesh_entries {mesh.size}"
    log(f"mesh: {tag} ({', '.join(entries)})")
    data = path.read_bytes()
    n_segs = -(-len(data) // (64 << 20))
    for label, kw, kern, row in MULTI_QUERIES:
        kw = dict(kw)
        if kw.get("patterns") == "config3":
            kw["patterns"] = set3
        t0 = time.perf_counter()
        single = GrepEngine(**kw)
        before = counters[kern].launches
        t1 = time.perf_counter()
        want = single.scan(data)
        one_s = time.perf_counter() - t1
        one_launches = counters[kern].launches - before
        one_eng = GrepEngine(mesh=one, **kw)
        one_eng.scan(data)
        eng = GrepEngine(mesh=mesh, **kw)
        before = counters[kern].launches
        t1 = time.perf_counter()
        got = eng.scan(data)
        mesh_s = time.perf_counter() - t1
        launched = counters[kern].launches - before
        if eng.mode != single.mode or not np.array_equal(
                got.matched_lines, want.matched_lines):
            raise AssertionError(
                f"3h {label}: mesh engine (mode {eng.mode}) lines differ "
                f"from the single-device engine's ({got.n_matches} vs "
                f"{want.n_matches})")
        if one_launches < n_segs or launched != mesh.size * one_launches:
            raise AssertionError(
                f"3h {label}: {launched} {kern} launches on the mesh, "
                f"{one_launches} on one device, {n_segs} segments")
        psum = eng.stats.get("psum_candidates")
        if psum is None or psum != one_eng.stats.get("psum_candidates"):
            raise AssertionError(
                f"3h {label}: psum_candidates {psum} != the one-entry "
                f"mesh's {one_eng.stats.get('psum_candidates')}")
        log(f"3h {label!r} (row {row}, mode {eng.mode}): {got.n_matches} "
            f"lines = the single-device engine's; {kern} launches "
            f"{launched} = {mesh.size} x {one_launches}; psum_candidates "
            f"{psum} = the single-device nonzero words; scan walls one "
            f"card {one_s:.3f} s, mesh {mesh_s:.3f} s (host clock); "
            f"{time.perf_counter() - t0:.1f} s [{tag}] [{card}]")

    # the sharded kernels' words against one device's, bit for bit, on
    # the first 64 MiB segment
    t0 = time.perf_counter()
    st = segment_stripes(torch, data)
    cols = st.t().contiguous()
    sa = engine_mod.check_pattern("volcano").sa_filtered
    nfa = engine_mod.check_pattern("^the (old|new) ").glushkov
    fdr = engine_mod.check_patterns(set3).fdr
    ps = engine_mod.check_patterns(PAIR_SET).pairset
    ax = engine_mod.check_approx("volcano", 1).approx
    fdr_one = None
    for bank in fdr.banks:
        fdr_one = fdr_scan.fdr_scan_words(cols, bank, out=fdr_one)
    checks = {
        "shift_and": (shk.sharded_shift_and_words(st, sa, mesh),
                      cuda_scan.shift_and_scan_words(st, sa, True)),
        "shift_and_swar": (shk.sharded_shift_and_words(st, sa, mesh,
                                                       swar=True),
                           swar_scan.swar_scan_words(st, sa)),
        "nfa": (shk.sharded_nfa_words(st, nfa, mesh),
                nfa_scan.nfa_scan_words(cols, nfa)),
        "fdr": (shk.sharded_fdr_words(st, fdr, mesh), fdr_one),
        "pairset": (shk.sharded_pairset_words(st, ps, mesh),
                    pairset_scan.pairset_scan_words(st, ps)),
        "approx": (shk.sharded_approx_words(st, ax, mesh),
                   approx_scan.approx_scan_words(st, ax)),
    }
    torch.cuda.synchronize()
    for name, ((words, total), ref) in checks.items():
        nz = int(torch.count_nonzero(ref.view(torch.int32)))
        if not torch.equal(words, ref) or int(total) != nz:
            raise AssertionError(f"3h sharded {name} words differ from one "
                                 f"device's (total {int(total)} vs {nz})")
    log("3h sharded words = one device's, bit for bit, on a 64 MiB segment "
        f"({st.shape[0]} x {st.shape[1]}): " + ", ".join(
            f"{name} {int(total)}" for name, ((_w, total), _r)
            in checks.items()) + f" nonzero words; "
        f"{time.perf_counter() - t0:.1f} s [{tag}] [{card}]")

    # '^$' on a mesh engine: mode "dfa", K1 on the first entry
    t0 = time.perf_counter()
    arr = np.frombuffer(data[: 16 << 20], np.uint8).copy()
    at = np.random.default_rng(8).choice(arr.size - 2, size=2000,
                                         replace=False)
    arr[at] = arr[at + 1] = ord("\n")  # empty lines
    empty = WORK / "multi-empty-lines.txt"
    empty.write_bytes(arr.tobytes())
    before = counters["dfa"].launches
    eng = GrepEngine("^$", mesh=mesh)
    got = eng.scan(empty.read_bytes())
    k1 = counters["dfa"].launches - before
    want = [n for n, _t in grep_oracle_lines(empty, ["-e", "^$"])]
    if (eng.route != "dfa" or k1 <= 0 or not eng.stats.get("mesh_unsharded")
            or got.matched_lines.tolist() != want):
        raise AssertionError(
            f"3h '^$': route {eng.route}, K1 launches {k1}, "
            f"{got.n_matches} lines vs GNU grep's {len(want)}")
    log(f"3h '^$' on the mesh engine: route dfa (mesh_unsharded), K1 "
        f"launches {k1}, {len(want)} lines = GNU grep's; "
        f"{time.perf_counter() - t0:.1f} s [{tag}] [{card}]")

    # jobs: the one-card job against a device list and a mesh
    t0 = time.perf_counter()
    hashes, walls, job_launches = {}, {}, {}
    two = ([f"cuda:{i}" for i in range(2)] if n_cards >= 2
           else ["cuda:0", "cuda:0"])
    for label, extra in (("one card", {}), ("devices x2", {"devices": two}),
                         ("mesh_shape [4]", {
                             "mesh_shape": [4],
                             "devices": [f"cuda:{i % n_cards}"
                                         for i in range(4)]})):
        engine_mod.model_cache_clear()
        before = counters["shift_and"].launches
        t1 = time.perf_counter()
        res = run_job(JobConfig(
            input_files=[str(path)],
            app_options={"pattern": "volcano", **extra}, n_reduce=10,
            task_timeout_s=60.0, work_dir=str(WORK / f"multi-{len(hashes)}"),
            journal=False, durable=False), n_workers=2, device="cuda",
            app=from_module(grep_cuda))
        walls[label] = time.perf_counter() - t1
        job_launches[label] = counters["shift_and"].launches - before
        hashes[label] = mr_out_hashes(res.output_files)
        shutil.rmtree(res.metrics["work_dir"], ignore_errors=True)
    if not (hashes["devices x2"] == hashes["one card"]
            == hashes["mesh_shape [4]"]):
        raise AssertionError("3h: a job's mr-out differs from the one-card "
                             "job's")
    if job_launches["mesh_shape [4]"] != 4 * job_launches["one card"]:
        raise AssertionError(f"3h: job launches {job_launches}")
    log(f"3h run_job volcano: mr-out of the devices list and of mesh_shape "
        f"[4] = the one-card job's; walls " + ", ".join(
            f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; shift_and launches {job_launches} [{tag}] [{card}]")

    # the table-DFA step with its collectives
    t0 = time.perf_counter()
    st2 = needle_stripes(torch, st)
    table = dfa_mod.compile_dfa("needle")
    words, total, exits, neigh = sharded_grep_step(st2, table, mesh)
    want_words, want_exits = dfa_scan.dfa_scan_words_plain(st2, table,
                                                           with_exits=True)
    torch.cuda.synchronize()
    if (int(total) < 1 or not torch.equal(exits, want_exits)
            or not torch.equal(words, want_words)
            or neigh.shape != (mesh.size,)):
        raise AssertionError(f"3h sharded_grep_step: total {int(total)}, "
                             f"exit states or words differ")
    log(f"3h sharded_grep_step needle: total {int(total)} matched positions, "
        f"exit states and words = K1's plain version's, ring "
        f"{neigh.tolist()} ({time.perf_counter() - t0:.1f} s)")
    one_step = (int(total), exits, want_words)
    del st2, words, want_words, cols, checks, fdr_one
    multi_pattern_axis(path, data, st, set3, card, counters, one_step)
    log(f"phase 3h: {time.perf_counter() - t_phase:.1f} s; {tag}; no run "
        f"spans two cards unless cards >= 2 [{card}]")


def needle_stripes(torch, st):
    """The 64 MiB segment's stripes with 'needle' planted every 97th
    stripe: phase 3h's table-DFA step, in this process and in each rank."""
    st2 = st.clone()
    st2[:: 97, 100:106] = torch.frombuffer(bytearray(b"needle"),
                                           dtype=torch.uint8).to(st.device)
    return st2


def segment_stripes(torch, data: bytes):
    """The first 64 MiB segment of ``data`` as the engine lays it out
    (65536 x 1024), on cuda:0."""
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.ops.layout import (
        choose_layout,
        padded_stripes,
    )

    seg = data[: 64 << 20]
    lay = choose_layout(len(seg), **GrepEngine("volcano").layout_kwargs())
    return torch.from_numpy(padded_stripes(seg, lay).copy()).cuda()


def mixed_plan_set() -> list[bytes]:
    """40,000 members of config 5's recipe: compile_fdr makes two banks of
    two plans (m 4 and 6)."""
    import numpy as np

    alphabet = np.arange(1, 256)
    alphabet = alphabet[alphabet != 0x0A]
    return [p.encode("latin-1")
            for p in rand_literals(40_000, 5, 9, seed=5, alphabet=alphabet)]


class _Lines(logging.Handler):
    """The messages of one logger, kept while attached."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


# Phase 3h (d)'s ranks: each holds two entries of cuda:0 in a gloo group
# (NCCL refuses two ranks on one card); a collective waits this long at
# most on a rank that died
RANK_TIMEOUT_S = 300.0


def multi_pattern_axis(path: Path, data: bytes, st, set3: list[bytes],
                       card: str, counters: dict, one_step) -> None:
    """Phase 3h (a)-(e): the pattern axis and several processes (the
    module docstring), the launch counts zeroed just before and read just
    after."""
    import numpy as np
    import torch

    from distributed_grep_tpu_torch.entry import dryrun_multichip
    from distributed_grep_tpu_torch.models import aho as aho_mod
    from distributed_grep_tpu_torch.models import fdr as fdr_mod
    from distributed_grep_tpu_torch.ops import dfa_scan, fdr_scan
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.ops.fdr_scan import or_into
    from distributed_grep_tpu_torch.parallel import sharded_kernels as shk
    from distributed_grep_tpu_torch.parallel.mesh import make_mesh
    from distributed_grep_tpu_torch.parallel.sharded_scan import (
        sharded_pattern_set_step,
    )

    n_cards = torch.cuda.device_count()
    entries = [f"cuda:{i % n_cards}" for i in range(4)]
    mesh = make_mesh((2, 2), ("data", "seq"), devices=entries)
    tag = (f"ranks {mesh.n_ranks}, cards {mesh.cards}, mesh_entries "
           f"{mesh.size}")
    ep_kw = dict(mesh=mesh, mesh_axis="data", pattern_axis="seq")
    for m in counters.values():
        m.reset_launches()
    t_all = time.perf_counter()

    # (a) the pattern axis in the engine
    t0 = time.perf_counter()
    for label, kw in (("config3 -f", {"patterns": set3}),
                      ("-i config3 -f", {"patterns": set3,
                                         "ignore_case": True}),
                      ("config3 + # -f", {"patterns": set3 + [b"#"]})):
        want = GrepEngine(**kw).scan(data)
        eng = GrepEngine(**ep_kw, **kw)
        before = {k: counters[k].launches for k in ("fdr", "pairset")}
        t1 = time.perf_counter()
        got = eng.scan(data)
        ep_s = time.perf_counter() - t1
        launched = {k: counters[k].launches - v for k, v in before.items()}
        psum = eng.stats.get("psum_candidates", 0)
        sidecar = eng.fdr_pairset is not None
        if (not np.array_equal(got.matched_lines, want.matched_lines)
                or eng._fdr_ep_dev_tables is None or psum < 1
                or launched["fdr"] < 1
                or (launched["pairset"] >= 1) != sidecar):
            raise AssertionError(
                f"3h (a) {label}: {got.n_matches} lines vs the one-card "
                f"engine's {want.n_matches}, launches {launched}, "
                f"psum_candidates {psum}")
        log(f"3h (a) {label!r} over the pattern axis: {got.n_matches} lines "
            f"= the one-card engine's; {len(eng.fdr.banks)} bank(s) over "
            f"seq {mesh.shape['seq']}, launches {launched}"
            f"{' (the pairset sidecar lane-sharded)' if sidecar else ''}; "
            f"psum_candidates {psum}; scan {ep_s:.3f} s (host clock) "
            f"[{tag}] [{card}]")
    log(f"3h (a): {time.perf_counter() - t0:.1f} s")

    # (b) the FDR step: four same-plan banks, then a mixed-plan set
    t0 = time.perf_counter()
    quarters = [fdr_mod.compile_fdr(set3[i::4]) for i in range(4)]
    model = fdr_mod.FdrModel(banks=[b for q in quarters for b in q.banks],
                             ignore_case=False, n_patterns=len(set3))
    plans = {shk.bank_plan(b) for b in model.banks}
    if len(model.banks) != 4 or len(plans) != 1:
        raise AssertionError(f"3h (b): {len(model.banks)} banks of "
                             f"{len(plans)} plans from config 3's quarters")
    tabs = shk.fdr_pattern_tables(model, mesh, "seq")
    words, total = shk.sharded_fdr_pattern_step(st, model, mesh, "data",
                                                "seq", tabs_dev=tabs)
    cols = st.t().contiguous()
    ref = None
    for bank in model.banks:
        ref = or_into(ref, fdr_scan.fdr_scan_words(cols, bank))
    torch.cuda.synchronize()
    nz = int(torch.count_nonzero(ref.view(torch.int32)))
    if not torch.equal(words, ref) or int(total) != nz or nz < 1:
        raise AssertionError(f"3h (b): pattern-axis FDR words differ from "
                             f"one device's OR of the four banks (total "
                             f"{int(total)} vs {nz})")
    log(f"3h (b) sharded_fdr_pattern_step, config 3 in four quarters (4 "
        f"banks, 1 plan, runs {[len(r) for r in tabs]}): words = one "
        f"device's OR of the four banks, bit for bit; total {int(total)} "
        f"nonzero words ({st.shape[0]} x {st.shape[1]}) [{tag}] [{card}]")
    del words, ref, cols
    mixed = mixed_plan_set()
    # 16 MiB of the word file with 200 of the members planted
    part = bytearray(data[: 16 << 20])
    rng = np.random.default_rng(12)
    for i, at in enumerate(rng.choice(len(part) - 16, 200, replace=False)):
        member = mixed[i * 197 % len(mixed)]
        part[at: at + len(member)] = member
    part = bytes(part)
    handler = _Lines()
    scan_log = logging.getLogger("distributed_grep_tpu_torch.device_scan")
    scan_log.addHandler(handler)
    old_level = scan_log.level
    scan_log.setLevel(logging.INFO)
    try:
        eng = GrepEngine(patterns=mixed, **ep_kw)
        got = eng.scan(part)
    finally:
        scan_log.removeHandler(handler)
        scan_log.setLevel(old_level)
    want = GrepEngine(patterns=mixed).scan(part)
    n_plans = len({shk.bank_plan(b) for b in eng.fdr.banks})
    said = [m for m in handler.messages if m.startswith("mixed-plan FDR")]
    if (n_plans < 2 or not said or eng._fdr_ep_dev_tables is not None
            or not np.array_equal(got.matched_lines, want.matched_lines)):
        raise AssertionError(f"3h (b) mixed plans: {n_plans} plans, log "
                             f"{said}, {got.n_matches} lines vs "
                             f"{want.n_matches}")
    log(f"3h (b) a mixed-plan set ({len(mixed)} members, "
        f"{len(eng.fdr.banks)} banks of {n_plans} plans) on 16 MiB: "
        f"logged {said[0]!r}; lanes sharded alone; {got.n_matches} lines = "
        f"the one-card engine's [{tag}] [{card}]")
    log(f"3h (b): {time.perf_counter() - t0:.1f} s")

    # (c) the DFA banks over the pattern axis on K1
    t0 = time.perf_counter()
    tables = [aho_mod.compile_aho_corasick(set3[i::4]) for i in range(4)]
    words, total = sharded_pattern_set_step(st, tables, mesh, "data", "seq")
    one_dev = plain = None
    for t in tables:
        one_dev = or_into(one_dev, dfa_scan.dfa_scan_words(st, t))
        plain = or_into(plain, dfa_scan.dfa_scan_words_plain(st, t))
    torch.cuda.synchronize()
    if (not torch.equal(words, one_dev) or not torch.equal(words, plain)
            or int(total) < 1):
        raise AssertionError("3h (c): sharded_pattern_set_step's words "
                             "differ from the banks' K1 words OR'd")
    log(f"3h (c) sharded_pattern_set_step, config 3's quarters as 4 "
        f"Aho-Corasick banks ({', '.join(str(t.trans.shape[0]) for t in tables)} "
        f"states) on K1: words = one device's OR and K1's plain version's; "
        f"{int(total)} matched positions [{tag}] [{card}]")
    del words, one_dev, plain
    log(f"3h (c): {time.perf_counter() - t0:.1f} s")

    # (d) two ranks of a gloo group on this host
    t0 = time.perf_counter()
    rank_lines(path, data, set3, card, one_step)
    log(f"3h (d): {time.perf_counter() - t0:.1f} s")

    # (e) the dry run
    t0 = time.perf_counter()
    line = dryrun_multichip(4, devices=entries)
    if "dryrun_multichip OK" not in line:
        raise AssertionError(f"3h (e): {line}")
    log(f"3h (e) {line} ({time.perf_counter() - t0:.1f} s) [{card}]")

    launches = {k: m.launches for k, m in counters.items()}
    if not all(launches[k] for k in ("fdr", "pairset", "dfa")):
        raise AssertionError(f"3h (a)-(e): launches {launches}")
    log(f"3h (a)-(e) launches in this process (rows 4, 5, 9 on their new "
        f"routes): {launches}; {time.perf_counter() - t_all:.1f} s "
        f"[{card}]")


def rank_lines(path: Path, data: bytes, set3: list[bytes], card: str,
               one_step) -> None:
    """Phase 3h (d): this script twice with --mesh-rank, each rank two
    entries of cuda:0 in a gloo group; both ranks' lines, words, totals
    and exit states against this process's."""
    import numpy as np
    import torch

    from distributed_grep_tpu_torch.ops.engine import GrepEngine

    want = {"volcano": GrepEngine("volcano").scan(data).matched_lines,
            "config3": GrepEngine(patterns=set3).scan(data).matched_lines}
    port = free_port()
    outs = [WORK / f"rank{r}.pt" for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r),
         "--mesh-port", str(port), "--mesh-out", str(outs[r]),
         "--mesh-file", str(path)],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in (0, 1)]
    errs = []
    try:
        for p in procs:
            _o, err = p.communicate(timeout=RANK_TIMEOUT_S + 120)
            errs.append(err.decode(errors="replace")[-3000:])
    finally:
        end_procs(procs)
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"3h (d): ranks exited "
                             f"{[p.returncode for p in procs]}:\n"
                             + "\n".join(errs))
    total, exits, words = one_step
    for r, out in enumerate(outs):
        got = torch.load(out, weights_only=False)
        tag = f"ranks {got['n_ranks']}, cards {got['cards']}"
        w, t, x, neigh = got["step"]
        local = x.shape[0] // neigh.shape[0]
        ring = np.roll(x.numpy()[local - 1::local], 1)
        bad = [k for k in ("volcano", "config3")
               if not np.array_equal(got[k], want[k])]
        if (bad or t != total or not torch.equal(x, exits.cpu())
                or not torch.equal(w, words.cpu())
                or not np.array_equal(neigh.numpy(), ring)
                or got["n_ranks"] != 2 or got["cards"] != 1):
            raise AssertionError(f"3h (d) rank {r}: {bad or 'step'} differ "
                                 f"from one process's [{tag}]")
        log(f"3h (d) rank {r} of 2: 'volcano' {len(want['volcano'])} lines "
            f"and config 3 over the pattern axis {len(want['config3'])} "
            f"lines = the one-card engine's; sharded_grep_step needle total "
            f"{t}, exit states and words = one process's, ring "
            f"{neigh.tolist()}; walls {got['walls']}; launches "
            f"{got['launches']} [{tag}] [{card}]")
        out.unlink()


def mesh_rank_main(args) -> int:
    """One rank of phase 3h (d): joins the gloo group, builds the global
    (2, 2) mesh from two entries of cuda:0, scans the word file and runs
    the table-DFA step, and saves what it got to --mesh-out."""
    import torch

    from distributed_grep_tpu_torch.models.dfa import compile_dfa
    from distributed_grep_tpu_torch.ops import (
        cuda_scan,
        dfa_scan,
        fdr_scan,
        pairset_scan,
    )
    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.parallel import multihost
    from distributed_grep_tpu_torch.parallel.mesh import make_mesh
    from distributed_grep_tpu_torch.parallel.sharded_scan import (
        sharded_grep_step,
    )

    multihost.init_distributed(f"127.0.0.1:{args.mesh_port}", 2,
                               args.mesh_rank, backend="gloo",
                               timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = make_mesh((2, 2), ("data", "seq"),
                         devices=["cuda:0", "cuda:0"])
        data = Path(args.mesh_file).read_bytes()
        mods = (cuda_scan, fdr_scan, pairset_scan, dfa_scan)
        for m in mods:
            m.reset_launches()
        out = {"n_ranks": mesh.n_ranks, "cards": len({
            str(d) for d in mesh.devices.flat}), "walls": {}}
        for key, eng in (
                ("volcano", GrepEngine("volcano", mesh=mesh,
                                       mesh_axis="data")),
                ("config3", GrepEngine(patterns=config3_set(), mesh=mesh,
                                       mesh_axis="data",
                                       pattern_axis="seq"))):
            t0 = time.perf_counter()
            out[key] = eng.scan(data).matched_lines
            out["walls"][key] = round(time.perf_counter() - t0, 3)
        st2 = needle_stripes(torch, segment_stripes(torch, data))
        words, total, exits, neigh = sharded_grep_step(
            st2, compile_dfa("needle"), mesh)
        out["step"] = (words.cpu(), int(total), exits.cpu(), neigh.cpu())
        out["launches"] = {m.LIBRARY: m.launches for m in mods}
        torch.save(out, args.mesh_out)
    finally:
        multihost._dist().destroy_process_group()
    return 0


FOLLOW_QUERIES = (("volcano", {"pattern": "volcano"}),
                  ("-i Volcano", {"pattern": "Volcano", "ignore_case": True}),
                  ("^the (old|new) ", {"pattern": "^the (old|new) "}),
                  ("-c volcano", {"pattern": "volcano", "count_only": True}))


def service_follow(svc, server, words: list[Path], zero, launched) -> str:
    """Phase 3f (f): four standing queries over one 16 MiB word file on the
    card ('volcano', -i 'Volcano' and '^the (old|new) ' in one fused group;
    -c 'volcano', whose count option keeps it out, solo), while a thread
    appends eight slices of 1-2 MiB, each ending in a marker line; each
    stream, read over GET /jobs/<id>/stream, equals the one-shot scan of
    the final file (host engine) and GNU grep."""
    import urllib.request

    import numpy as np

    from distributed_grep_tpu_torch.ops.engine import GrepEngine
    from distributed_grep_tpu_torch.ops import lines as lines_mod
    from distributed_grep_tpu_torch.utils.config import JobConfig

    work = WORK / "service-follow"
    work.mkdir(parents=True, exist_ok=True)
    path = work / "grow.log"
    base = words[0].read_bytes()[: 16 << 20]
    path.write_bytes(base[: base.rfind(b"\n") + 1])
    src = words[1].read_bytes()[: 24 << 20]
    rng = np.random.default_rng(23)
    appends, pos = [], 0
    for k in range(8):
        end = src.find(b"\n", pos + int(rng.integers(1 << 20, 2 << 20))) + 1
        marker = b"volcano follow marker %d" % k
        appends.append((marker, src[pos:end] + marker + b"\n"))
        pos = end

    def oracle(opts: dict, data: bytes) -> list[tuple[int, str]]:
        eng = GrepEngine(opts["pattern"], backend="cpu",
                         ignore_case=bool(opts.get("ignore_case")))
        res = eng.scan(data)
        nl = lines_mod.newline_index(data)
        starts, ends = lines_mod.line_spans(res.matched_lines, nl, len(data))
        return [(int(n), data[s:e].decode("utf-8", "surrogateescape"))
                for n, s, e in zip(res.matched_lines.tolist(),
                                   starts.tolist(), ends.tolist())]

    def count_of(recs) -> int:
        return sum(int(r.get("count", 0)) for r in recs)

    def size_of(label: str, recs) -> int:
        return count_of(recs) if "count_only" in dict(
            FOLLOW_QUERIES)[label] else len(recs)

    saved = os.environ.get("DGREP_DEVICE_MIN_BYTES")
    os.environ.update(KERNELS_AT_EVERY_SIZE)
    base_data = path.read_bytes()
    want0 = {label: len(oracle(o, base_data))
             for label, o in FOLLOW_QUERIES}
    streams: dict[str, list] = {label: [] for label, _ in FOLLOW_QUERIES}
    arrivals: dict[str, list] = {label: [] for label, _ in FOLLOW_QUERIES}
    stop = threading.Event()
    url = f"http://127.0.0.1:{server.port}"
    jids = {}

    def reader(label: str, jid: str) -> None:
        cursor = 0
        while not stop.is_set():
            with urllib.request.urlopen(
                    f"{url}/jobs/{jid}/stream?cursor={cursor}&timeout=1",
                    timeout=30) as r:
                page = json.loads(r.read())
            now = time.perf_counter()
            for rec in page["records"]:
                streams[label].append(rec)
                arrivals[label].append((now, rec))
            cursor = page["next"]

    def wait_for(want: dict, what: str, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while any(size_of(label, streams[label]) < n
                  for label, n in want.items()):
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"phase 3f (f): {what}: streams "
                    f"{ {k: size_of(k, v) for k, v in streams.items()} } of "
                    f"{want}; status {svc.status().get('follow')}")
            time.sleep(0.02)

    readers = []
    try:
        t0 = time.perf_counter()
        for label, o in FOLLOW_QUERIES:
            jids[label] = svc.submit(JobConfig(
                input_files=[str(path)], app_options=dict(o), follow=True,
                follow_poll_s=0.1))
        for label, jid in jids.items():
            t = threading.Thread(target=reader, args=(label, jid),
                                 daemon=True)
            t.start()
            readers.append(t)
        wait_for(want0, "the catch-up of the 16 MiB file")
        deadline = time.monotonic() + 60
        fused = [jids[label] for label, o in FOLLOW_QUERIES
                 if not o.get("count_only")]
        while not all(svc.job_status(j)["follow"].get("fused") for j in fused):
            if time.monotonic() > deadline:
                raise AssertionError("phase 3f (f): the group never fused: "
                                     f"{svc.status().get('follow')}")
            time.sleep(0.02)
        catch_up = time.perf_counter() - t0
        groups = svc._follow_groups._groups
        (group,) = [g for g in groups.values()
                    if {m.runner.job_id for m in g.members()} == set(fused)]
        union_mode = group._fused.union.mode
        solo_jid = jids["-c volcano"]
        wakes0 = (group.wakes, svc.job_status(solo_jid)["follow"]["wakes"])
        before = zero()
        stamps: dict[bytes, float] = {}

        def appender():
            for marker, chunk in appends:
                with open(path, "ab") as f:
                    f.write(chunk)
                stamps[marker] = time.perf_counter()
                time.sleep(0.3)

        t_app = time.perf_counter()
        ta = threading.Thread(target=appender)
        ta.start()
        ta.join()
        final = path.read_bytes()
        want = {label: oracle(o, final) for label, o in FOLLOW_QUERIES}
        wait_for({k: len(v) for k, v in want.items()}, "the appends")
        wall = time.perf_counter() - t_app
        got = launched(before)
        wakes = (group.wakes - wakes0[0],
                 svc.job_status(solo_jid)["follow"]["wakes"] - wakes0[1])
        stop.set()
        for t in readers:
            t.join(timeout=10)
        for label, o in FOLLOW_QUERIES:
            if o.get("count_only"):
                if (count_of(streams[label]) != len(want[label])
                        or any("text" in r for r in streams[label])):
                    raise AssertionError(f"phase 3f (f): {label} counted "
                                         f"{count_of(streams[label])}, want "
                                         f"{len(want[label])}")
                continue
            rows = [(r["line"], r["text"]) for r in streams[label]]
            argv = ["-n", *(["-i"] if o.get("ignore_case") else []),
                    *(["-E"] if "(" in o["pattern"] else []),
                    o["pattern"], path]
            g = [(n, t_.decode("utf-8", "surrogateescape"))
                 for _p, n, _c, _b, t_ in gnu_tuples(
                     gnu(argv).stdout, [], label=str(path).encode())]
            if rows != want[label] or rows != g:
                raise AssertionError(f"phase 3f (f): {label}: {len(rows)} "
                                     f"records, one-shot {len(want[label])},"
                                     f" GNU grep {len(g)}")
        union_key = union_mode
        if (union_key not in got or union_key == "shift_and"
                or wakes[0] < 1 or wakes[1] < 1 or not got.get("shift_and")):
            raise AssertionError(f"phase 3f (f): launches {got} (union "
                                 f"{union_mode}), wakes {wakes}")
        latency = sorted(
            next(ts for ts, rec in arrivals["volcano"]
                 if rec.get("text", "").encode() == marker) - stamps[marker]
            for marker, _chunk in appends)
        status = svc.status()["follow"]
        return (f"standing queries over {path.stat().st_size} bytes (16 MiB, "
                f"then 8 appends of 1-2 MiB, 0.3 s apart), "
                f"DGREP_DEVICE_MIN_BYTES=0, poll 0.1 s: one fused group of "
                f"{len(fused)} (union route {union_mode}), -c volcano solo; "
                f"catch-up {catch_up:.3f} s; during the appends {wakes[0]} "
                f"group wakes and {wakes[1]} solo wakes, launches {got}: "
                f"{got[union_key] / wakes[0]:.2f} {union_key} a group wake, "
                f"{got['shift_and'] / wakes[1]:.2f} shift_and a solo wake; "
                f"latency from an append to its record on the stream min "
                f"{latency[0]:.3f}, median {latency[len(latency) // 2]:.3f}, "
                f"max {latency[-1]:.3f} s; streams "
                f"{ {k: size_of(k, v) for k, v in streams.items()} } equal "
                f"to the one-shot scan and GNU grep; wall {wall:.3f} s; "
                f"follow view {{'follow_wakes': {status.get('follow_wakes')}, "
                f"'follow_fused_wakes': {status.get('follow_fused_wakes')}, "
                f"'follow_suffix_bytes_saved': "
                f"{status.get('follow_suffix_bytes_saved')}, "
                f"'stream_dropped_records': "
                f"{status.get('stream_dropped_records')}}}")
    finally:
        stop.set()
        for jid in jids.values():
            svc.cancel(jid)
        if saved is None:
            os.environ.pop("DGREP_DEVICE_MIN_BYTES", None)
        else:
            os.environ["DGREP_DEVICE_MIN_BYTES"] = saved
        shutil.rmtree(work, ignore_errors=True)


def service_pool(words: list[Path]) -> str:
    """Phase 3f (g): a daemon with 1 local worker and the pool's ceiling at
    3 (``serve``'s own pool thread), 4 jobs of 50 small files each
    (batching and fusion off: 200 map tasks): the advice says grow and the
    pool grows; idle, it drains back to 1; ``top --once`` prints the
    daemon's view and ``trace-export --fleet`` renders its daemon.jsonl
    with the scale events."""
    from distributed_grep_tpu_torch import __main__ as cli
    from distributed_grep_tpu_torch.runtime.daemon_log import DaemonLog
    from distributed_grep_tpu_torch.runtime.service import (
        GrepService,
        ServiceServer,
    )
    from distributed_grep_tpu_torch.utils.config import JobConfig

    root = WORK / "service-g"
    tree = WORK / "service-g-files"
    data = words[2].read_bytes()[: 8 << 20]
    paths, pos = [], 0
    tree.mkdir(parents=True, exist_ok=True)
    for i in range(50):
        end = data.find(b"\n", pos + (64 << 10)) + 1
        p = tree / f"f{i:03d}.txt"
        p.write_bytes(data[pos:end])
        paths.append(str(p))
        pos = end
    saved = {k: os.environ.get(k) for k in ("DGREP_BATCH_BYTES",
                                             "DGREP_SERVICE_FUSE")}
    os.environ.update({"DGREP_BATCH_BYTES": "0", "DGREP_SERVICE_FUSE": "0"})
    stop = threading.Event()
    svc = GrepService(work_root=root, daemon_log=DaemonLog(root), spans=True,
                      task_timeout_s=SERVICE_TIMEOUT_S)
    server = ServiceServer(svc)
    server.start()
    scaler = None
    try:
        t0 = time.perf_counter()
        scaler = cli._start_worker_pool(
            argparse.Namespace(workers=1, max_workers=3), svc, stop)
        jids = [svc.submit(JobConfig(input_files=paths,
                                     app_options={"pattern": pat},
                                     n_reduce=2, journal=False,
                                     durable=False))
                for pat in ("volcano", "the new", "being it", "ash")]
        advice = svc.scale_advice()["advice"]
        peak = 1
        deadline = time.monotonic() + 120
        while any(svc.job_status(j)["state"] != "done" for j in jids):
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 3f (g): jobs "
                                     f"{[svc.job_status(j) for j in jids]}")
            peak = max(peak, svc.local_pool_size())
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        deadline = time.monotonic() + 30
        while svc.local_pool_size() > 1:
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 3f (g): the pool did not "
                                     f"drain: {svc.local_pool_size()}")
            time.sleep(0.05)
        drained = time.perf_counter() - t0
        rc, top, _err, _w = port_cli_in_process(
            ["top", "--once", "--addr", f"127.0.0.1:{server.port}"])
        svc._flush_daemon_log()
        rc2, trace, _err2, _w2 = port_cli_in_process(
            ["trace-export", "--fleet", str(root)])
        events = DaemonLog.read(root)
        actions = [(e["payload"]["action"], e["payload"]["workers"])
                   for e in events if e["kind"] == "scale_action"]
        advices = [e["payload"]["advice"] for e in events
                   if e["kind"] == "scale_advice"]
        doc = json.loads(trace)
        fleet = {e["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "i" and e.get("pid") == 1}
        top_text = top.decode()
        if (advice != "grow" or "grow" not in advices
                or not any(a == "grow" for a, _n in actions)
                or not any(a == "drain" for a, _n in actions) or peak < 2
                or rc != 0 or "[ACTIVE]" not in top_text
                or "scale:" not in top_text or rc2 != 0
                or not {"scale_advice", "scale_action"} <= fleet):
            raise AssertionError(f"phase 3f (g): advice {advice}, advices "
                                 f"{advices}, actions {actions}, peak {peak},"
                                 f" top {rc} {top_text[:300]!r}, fleet "
                                 f"{rc2} {sorted(fleet)}")
        return (f"elastic pool: 1 local worker, ceiling 3, 4 jobs of 50 "
                f"files (200 map tasks): advice {advice} at submit, the pool "
                f"peaked at {peak} loops, jobs done in {wall:.3f} s, drained "
                f"back to 1 at {drained:.3f} s; scale actions {actions}, "
                f"advice changes {advices}; top --once {len(top_text)} "
                f"bytes ({top_text.splitlines()[0]}); trace-export --fleet "
                f"{len(doc['traceEvents'])} trace events, the daemon rows' "
                f"instants {sorted(fleet)}")
    finally:
        stop.set()
        if scaler is not None:
            scaler.join(timeout=5)
        svc.stop()
        server.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(tree, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--file-mb", type=int, default=128)
    ap.add_argument("--n-files", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build + kernel checks); "
                         "prints no result lines")
    ap.add_argument("--warm-only", action="store_true",
                    help="phase 1, then phase 3b over the word corpus alone "
                         "(no phase 2, 3 or 4); prints no result lines")
    ap.add_argument("--control-only", action="store_true",
                    help="phase 1, then phase 3's two in-process jobs that "
                         "phase 3c repeats, and phase 3c; prints no result "
                         "lines")
    ap.add_argument("--telemetry-only", action="store_true",
                    help="phase 1, then phase 3's two in-process jobs that "
                         "phase 3d compares with, and phase 3d; prints no "
                         "result lines")
    ap.add_argument("--tiers-only", action="store_true",
                    help="phase 1, then phase 3e over the word corpus alone; "
                         "prints no result lines")
    ap.add_argument("--multi-only", action="store_true",
                    help="phase 1, then phase 3h over one word file; prints "
                         "no result lines")
    ap.add_argument("--service-only", action="store_true",
                    help="phase 1, then phase 3's in-process jobs of the "
                         "four tenants phase 3f compares with, and phases 3f "
                         "and 3g; prints no result lines")
    # phase 3h (d) starts this script twice as the ranks of a gloo group
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default="", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-file", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from distributed_grep_tpu_torch.apps import grep_cuda
        from distributed_grep_tpu_torch.apps.loader import from_module
        from distributed_grep_tpu_torch.benchmarks.substripe_sweep import (
            graph_ms,
        )
        from distributed_grep_tpu_torch.models import aho as aho_mod
        from distributed_grep_tpu_torch.models import approx as ax_mod
        from distributed_grep_tpu_torch.models import dfa as dfa_mod
        from distributed_grep_tpu_torch.models import fdr as fdr_mod
        from distributed_grep_tpu_torch.models import nfa as nfa_mod
        from distributed_grep_tpu_torch.models import pairset as ps_mod
        from distributed_grep_tpu_torch.models import shift_and as sa_mod
        from distributed_grep_tpu_torch.ops import engine as engine_mod
        from distributed_grep_tpu_torch.ops import (
            _build,
            approx_scan,
            cuda_scan,
            device_scan,
            dfa_scan,
            fdr_scan,
            mxu_probe,
            narrow_probe,
            nfa_scan,
            pairset_scan,
            swar_scan,
        )
        from distributed_grep_tpu_torch.ops.confirm_set import (
            ConfirmSet,
            ConfirmSetNumpy,
        )
        from distributed_grep_tpu_torch.ops.layout import (
            choose_layout,
            padded_stripes,
            to_device_array,
        )
        from distributed_grep_tpu_torch.ops.scan_torch import sparse_nonzero
        from distributed_grep_tpu_torch.ops.sparse import (
            offsets_from_sparse_words,
        )
        from distributed_grep_tpu_torch.runtime.job import run_job
        from distributed_grep_tpu_torch.utils import native
        from distributed_grep_tpu_torch.utils.config import JobConfig
    except ImportError as e:
        print(f"error: distributed_grep_tpu_torch is not importable beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    import numpy as np

    if args.mesh_rank is not None:
        return mesh_rank_main(args)

    # ---------------------------------------------------------- phase 0
    from distributed_grep_tpu_torch.analysis import run_analysis

    log("== phase 0: the invariant checker (every rule, no baseline)")
    t0 = time.perf_counter()
    violations = run_analysis()
    log(f"analysis: {len(violations)} violations in "
        f"{time.perf_counter() - t0:.2f} s")
    if violations:
        raise RuntimeError("the invariant checker failed:\n" + "\n".join(
            v.render() for v in violations))

    counters = {"shift_and": cuda_scan, "nfa": nfa_scan, "fdr": fdr_scan,
                "pairset": pairset_scan, "approx": approx_scan,
                "shift_and_swar": swar_scan, "narrow_probe": narrow_probe,
                "mxu_dot": mxu_probe, "dfa": dfa_scan,
                "dfa_stride": dfa_scan.stride}
    t_all = time.perf_counter()
    # ---------------------------------------------------------- phase 1
    card = card_line()
    log("== phase 1: environment")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    # a CLI run on an empty _build/ builds its route's library (the NFA
    # kernel's, the longest build) inside its map task, beside the build
    # of the others
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    cold = WORK / "cold" / "words.txt"
    cold.parent.mkdir(parents=True, exist_ok=True)
    cold.write_bytes(b"".join(b"line %d of the volcano\nash %d\n" % (i, i)
                              for i in range(20000)))
    cold_cli = cold_build_cli(cold)
    try:
        _build.build_all(tuple(n for n in _build.SOURCES if n != "nfa"))
        cold_line = check_cold_build(cold_cli, cold)
    finally:
        if cold_cli.poll() is None:
            cold_cli.kill()
            cold_cli.wait()
        shutil.rmtree(cold.parent, ignore_errors=True)
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(_build.SOURCES)}, one nvcc each, in parallel)")
    log(cold_line)
    # the host library, built by g++ for this CPU, against its plain legs
    t0 = time.perf_counter()
    native_line = phase_native(np)
    log(f"native: {json.dumps(native_line)} "
        f"({time.perf_counter() - t0:.1f} s)")
    for name in _build.SOURCES:
        for func, usage in ptxas_usage(_build.saved_log(name)):
            log(f"  ptxas {name} {template_label(func)}: {usage}")
    # steps unrolled in a kernel's loop body: the ring kernels step a whole
    # box (128 bytes; SWAR kBoxBytes packed steps of four bytes), the
    # others one 32-byte word
    swar_box = int(re.search(r"constexpr int kBoxBytes = (\d+);", (
        _build.CSRC / "shift_and_swar.cu").read_text()).group(1))
    body = {"shift_and": (128, 1), "pairset": (128, 1),
            "shift_and_swar": (swar_box, 4)}
    for name in ("shift_and", "pairset", "approx", "shift_and_swar", "nfa",
                 "fdr"):
        steps, per = body.get(name, (32, 1))
        for func, n in sass_counts(_build, name).items():
            log(f"  sass {name} {template_label(func)}: {n} instructions "
                f"({n / steps:.1f} per step of {steps}, "
                f"{n / steps / per:.1f} a byte)")
    # the table DFA's walkers: the instructions of each word loop (32
    # bytes), apart from the fix-up and the set-up around it
    from distributed_grep_tpu_torch.benchmarks.substripe_sweep import (
        sass_word_loops,
    )
    for func, loop in sass_word_loops(_build._target("dfa")).items():
        log(f"  sass dfa {template_label(func)}: word loop of "
            f"{loop['loop_instructions']} instructions, "
            f"{loop['per_byte']:.2f} a byte; most used: "
            + ", ".join(f"{o} {n}" for o, n in loop["top"]))
    # the narrow probe: one word of 32 steps and a warm-up of WARM steps
    # unrolled, each over LANES_PER_THREAD lanes
    n_lanes, n_warm = narrow_probe.LANES_PER_THREAD, narrow_probe.WARM
    per_width = {}
    for func, ops in sass_opcodes(_build, "probe_narrow").items():
        top = sorted({o: ops.count(o) for o in ops}.items(),
                     key=lambda kv: -kv[1])[:8]
        per_width[narrow_label(func)] = len(ops) / ((32 + n_warm) * n_lanes)
        log(f"  sass probe_narrow {narrow_label(func)}: {len(ops)} "
            f"instructions, {per_width[narrow_label(func)]:.1f} a lane and "
            f"byte ({32 + n_warm} steps of {n_lanes} lanes); most used: "
            + ", ".join(f"{o} {n}" for o, n in top))
    # the one-hot product runs on wgmma (IGMMA), not mma.sync (IMMA), and
    # ptxas did not serialize its wgmma: read from nvcc's output kept beside
    # the library, whichever run built it
    if "serialized" in _build.saved_log("mxu_dot"):
        raise AssertionError("mxu_dot: ptxas serialized its wgmma:\n"
                             + _build.saved_log("mxu_dot"))
    mxu_sass = sass_opcodes(_build, "mxu_dot")
    if not mxu_sass:
        raise AssertionError("mxu_dot: no SASS read (cuobjdump beside nvcc "
                             "is missing or found no kernel)")
    for func, ops in mxu_sass.items():
        igmma = [o for o in ops if o.startswith("IGMMA")]
        imma = [o for o in ops if o.startswith(("IMMA", "HMMA"))]
        if not igmma or imma:
            raise AssertionError(f"mxu_dot: {len(igmma)} IGMMA and "
                                 f"{len(imma)} IMMA/HMMA in {func}")
        log(f"  sass mxu_dot: {func}: {len(ops)} instructions, {len(igmma)} "
            f"warpgroup MMA ({', '.join(sorted(set(igmma)))}), no IMMA")

    if args.control_only or args.telemetry_only:
        if WORK.exists():
            shutil.rmtree(WORK)
        try:
            words = make_corpus(args.seed, args.n_files, args.file_mb << 20)
            set3 = config3_set()
            inproc = {}
            for label, opts in (("volcano", {"pattern": "volcano",
                                             "ignore_case": False}),
                                ("config3 -f", {"patterns": set3})):
                res = run_job(JobConfig(
                    input_files=[str(p) for p in words],
                    app_options=opts, n_reduce=10, task_timeout_s=60.0,
                    work_dir=str(WORK / f"inproc-{label.split()[0]}"),
                    journal=False, durable=False),
                    n_workers=args.workers, device="cuda")
                inproc[label] = mr_out_hashes(res.output_files)
            if args.control_only:
                phase_control_plane(words, set3, inproc, card)
            if args.telemetry_only:
                phase_telemetry(args, words, set3, inproc, card, counters)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        log(f"total {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.multi_only:
        if WORK.exists():
            shutil.rmtree(WORK)
        try:
            words = make_corpus(args.seed, 1, args.file_mb << 20)
            phase_multi_gpu(words[0], config3_set(), card, counters)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        log(f"total {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.service_only:
        if WORK.exists():
            shutil.rmtree(WORK)
        try:
            words = make_corpus(args.seed, args.n_files, args.file_mb << 20)
            half = words[:max(1, args.n_files // 2)]
            set3 = config3_set()
            inproc, solo_walls = {}, {}
            for label, opts in service_options(set3).items():
                engine_mod.model_cache_clear()
                t0 = time.perf_counter()
                res = run_job(JobConfig(
                    input_files=[str(p) for p in half],
                    app_options=opts, n_reduce=10, task_timeout_s=60.0,
                    work_dir=str(WORK / f"inproc-{len(inproc)}"),
                    journal=False, durable=False),
                    n_workers=args.workers, device="cuda",
                    app=from_module(grep_cuda))
                solo_walls[label] = time.perf_counter() - t0
                inproc[label] = mr_out_hashes(res.output_files)
                log(f"in-process job {label!r}: {solo_walls[label]:.3f} s")
            phase_service(half, set3, inproc, solo_walls, card, counters)
            phase_failover(half, set3, inproc, card)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        log(f"total {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.tiers_only:
        if WORK.exists():
            shutil.rmtree(WORK)
        try:
            words = make_corpus(args.seed, args.n_files, args.file_mb << 20)
            phase_tiers(args, words, card, counters)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        log(f"total {time.perf_counter() - t_all:.1f} s")
        return 0

    if args.warm_only:
        if WORK.exists():
            shutil.rmtree(WORK)
        try:
            words = make_corpus(args.seed, args.n_files, args.file_mb << 20)
            pats3 = WORK / "config3.pats"
            pats3.write_bytes(b"\n".join(config3_set()) + b"\n")
            make_small_tree(words[1], WORK / "tree")
            phase_warm_tiers(args, words, pats3, counters, card, torch)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        log(f"total {time.perf_counter() - t_all:.1f} s")
        return 0

    # ---------------------------------------------------------- phase 2
    log("== phase 2: kernels vs plain versions (tolerance 0: integer words)")
    t0 = time.perf_counter()
    max_err = phase_kernels(torch, np, cuda_scan, sa_mod)
    log(f"shift_and checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    nfa_err = phase_nfa_kernels(torch, np, nfa_scan, nfa_mod)
    log(f"nfa checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _n, sweep_err = phase_nfa_sweep(torch, np, nfa_scan, nfa_mod, 4242)
    nfa_err = max(nfa_err, sweep_err)
    log(f"nfa sweep: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fdr_err, ps_err = phase_set_kernels(torch, np, fdr_scan, pairset_scan,
                                        fdr_mod, ps_mod)
    log(f"fdr and pairset checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _n, sweep_err = phase_fdr_sweep(torch, np, fdr_scan, fdr_mod, 4343)
    fdr_err = max(fdr_err, sweep_err)
    log(f"fdr sweep: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _n, sweep_err = phase_shift_and_sweep(torch, np, cuda_scan, sa_mod, 4444)
    max_err = max(max_err, sweep_err)
    log(f"shift_and sweep: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    approx_err = phase_approx_kernels(torch, np, approx_scan, ax_mod)
    log(f"approx checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _n, sweep_err = phase_approx_sweep(torch, np, approx_scan, ax_mod, 4545)
    approx_err = max(approx_err, sweep_err)
    log(f"approx sweep: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _n, sweep_err = phase_pairset_sweep(torch, np, pairset_scan, ps_mod, 4646)
    ps_err = max(ps_err, sweep_err)
    log(f"pairset sweep: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    swar_err = phase_swar_kernels(torch, np, swar_scan, sa_mod)
    log(f"swar checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _n, sweep_err = phase_swar_sweep(torch, np, swar_scan, sa_mod, 4747)
    swar_err = max(swar_err, sweep_err)
    log(f"swar sweep: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    narrow_err = phase_narrow_kernels(torch, np, narrow_probe)
    log(f"narrow probe checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mxu_err = phase_mxu_kernels(torch, np, mxu_probe)
    log(f"mxu_dot checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _n, dfa_err, _n, stride_err = phase_dfa_kernels(
        torch, np, dfa_scan, dfa_mod, aho_mod, 4848)
    log(f"dfa checks and sweep: {time.perf_counter() - t0:.1f} s")
    log("phase 2 launches (comparisons, not counted): "
        + ", ".join(f"{k} {m.launches}" for k, m in counters.items()))
    if args.kernels_only:
        return 0

    # ---------------------------------------------------------- phase 3
    log(f"== phase 3: main path, {args.n_files} x {args.file_mb} MB per "
        f"corpus, seed {args.seed}, card: {card}")
    if WORK.exists():
        shutil.rmtree(WORK)
    try:
        t0 = time.perf_counter()
        words = make_corpus(args.seed, args.n_files, args.file_mb << 20)
        # the queries run on half the word files, and the log and pcap
        # corpora hold half as many, for the smoke's time; phases 3b and
        # 3e take all eight
        n_half = max(1, args.n_files // 2)
        half = words[:n_half]
        # the log and pcap corpora one file fewer still, for the smoke's time
        n_other = max(1, n_half - 1)
        logs = make_log_corpus(args.seed, n_other, args.file_mb << 20)
        pcap = make_pcap_corpus(args.seed, n_other, args.file_mb << 20)
        defeat = [make_defeat_file(args.seed, args.file_mb << 20)]
        set3, set5 = config3_set(), config5_set()
        pats = {}
        for name, members in (("config3", set3), ("config5", set5),
                              ("pairs", PAIR_SET), ("mixed", set3 + [b"#"])):
            pats[name] = WORK / f"{name}.pats"
            pats[name].write_bytes(b"\n".join(members) + b"\n")
        log(f"corpora: {len(words)} word files, {len(logs)} log files, "
            f"{len(pcap)} pcap files, 1 defeat file, "
            f"{time.perf_counter() - t0:.1f} s")

        def single(pattern: str, ic: bool = False) -> dict:
            return {"pattern": pattern, "ignore_case": ic}

        def fixed(pattern: str, ic: bool = False) -> list[str]:
            return ["-F", *(["-i"] if ic else []), "-e", pattern]

        def ere(pattern: str, ic: bool = False) -> list[str]:
            return ["-E", *(["-i"] if ic else []), "-e", pattern]

        def members(name: str) -> list[str]:
            return ["-F", "-f", str(pats[name])]

        # (label, app options, files, oracle, kernels the query must
        # launch); the oracle is grep's arguments, {"count": grep's
        # arguments} (a count per file), {"approx": ...} (Sellers' DP over
        # grep's prefilter) or {"approx_count": ...}
        queries = [
            ("volcano", single("volcano"), half, fixed("volcano"),
             ["shift_and"]),
            ("-i Volcano", single("Volcano", True), half,
             fixed("Volcano", True), ["shift_and"]),
            ("the", single("the"), half, fixed("the"), ["shift_and"]),
            ("being it", single("being it"), half, fixed("being it"),
             ["shift_and"]),
            ("config2", single(CONFIG2), half, ere(CONFIG2), ["fdr"]),
            ("config4 -i", single(CONFIG4, True), logs, ere(CONFIG4, True),
             ["nfa"]),
            ("^the (old|new) ", single("^the (old|new) "), half,
             ere("^the (old|new) "), ["nfa"]),
            ("volcano$", single("volcano$"), half, ere("volcano$"), ["nfa"]),
            (r"\bvolcano\b", single(r"\bvolcano\b"), half,
             ere(r"\bvolcano\b"), ["nfa"]),
            ("x[ab]{2,40}y", single("x[ab]{2,40}y"), defeat,
             ere("x[ab]{2,40}y"), ["nfa"]),
            ("config3 -f", {"patterns": set3}, half, members("config3"),
             ["fdr"]),
            ("config5 -f", {"patterns": set5}, pcap, members("config5"),
             ["fdr"]),
            ("2-byte set", {"patterns": PAIR_SET}, pcap, members("pairs"),
             ["pairset"]),
            ("config3 + '#'", {"patterns": set3 + [b"#"]}, half,
             members("mixed"), ["fdr", "pairset"]),
            # approx: the oracle is Sellers' DP over grep's prefilter lines
            *[(f"--max-errors {k}{' -i' if ic else ''} {p}",
               {**single(p, ic), "max_errors": k}, half,
               {"approx": (p, k, ic, pieces)}, ["approx"])
              for p, k, ic, pieces in APPROX_QUERIES],
            # the selection and count options: -w and -x confirm the
            # kernel's candidate lines on the host, -v takes the complement,
            # -c counts per file
            ("-w volcano", {**single("volcano"), "word_regexp": True}, half,
             ["-w", *fixed("volcano")], ["shift_and"]),
            ("-w -F -f config3", {"patterns": set3, "word_regexp": True},
             half, ["-w", *members("config3")], ["fdr"]),
            ("-c the", {**single("the"), "count_only": True}, half,
             {"count": fixed("the")}, ["shift_and"]),
            ("-v volcano", {**single("volcano"), "invert": True}, words[:1],
             ["-v", *fixed("volcano")], ["shift_and"]),
            ("-x -E logs", {**single(LOG_LINE_X), "line_regexp": True}, logs,
             ["-x", *ere(LOG_LINE_X)], ["nfa"]),
            ("-c --max-errors 2 -i volcano",
             {**single("volcano", True), "max_errors": 2, "count_only": True},
             half, {"approx_count": APPROX_QUERIES[1]}, ["approx"]),
            # SWAR (DGREP_SWAR=1 for these three only): the Shift-And
            # queries again, on the packed kernel
            ("SWAR volcano", single("volcano"), half, fixed("volcano"),
             ["shift_and_swar"]),
            ("SWAR -i Volcano", single("Volcano", True), half,
             fixed("Volcano", True), ["shift_and_swar"]),
            ("SWAR being it", single("being it"), half, fixed("being it"),
             ["shift_and_swar"]),
        ]

        def n_segments(files) -> int:
            return sum(-(-p.stat().st_size // (64 << 20)) for p in files)

        per_query = []
        for m in counters.values():
            m.reset_launches()
        device_scan.reset_transposes()
        for label, opts, files, _oracle, _k in queries:
            before = {k: m.launches for k, m in counters.items()}
            trans_before = device_scan.transposes
            os.environ.pop("DGREP_SWAR", None)
            if label.startswith("SWAR "):
                os.environ["DGREP_SWAR"] = "1"
            # a throwaway work dir, as the CLI's: no journal, no fsync
            cfg = JobConfig(
                input_files=[str(p) for p in files],
                app_options=dict(opts), n_reduce=10, task_timeout_s=60.0,
                work_dir=str(WORK / f"job-{len(per_query)}"),
                journal=False, durable=False,
            )
            # a fresh engine a query (the cross-job engine cache would
            # hand "-w volcano" the engine of "volcano", whose totals are
            # read below)
            engine_mod.model_cache_clear()
            t0 = time.perf_counter()
            try:
                # the app module itself: its engine is read below
                res = run_job(cfg, n_workers=args.workers, device="cuda",
                              app=from_module(grep_cuda))
            finally:
                os.environ.pop("DGREP_SWAR", None)
            wall = time.perf_counter() - t0
            totals = dict(grep_cuda._engine.totals)
            totals.update(res.metrics["seconds"])
            launched = {k: m.launches - before[k]
                        for k, m in counters.items()}
            per_query.append((res, wall, launched, totals,
                              grep_cuda._engine.route,
                              device_scan.transposes - trans_before))
        main_launches = {k: m.launches for k, m in counters.items()}
        log(f"main path launches: {main_launches}; on-card layout "
            f"transposes {device_scan.transposes}")
        if main_launches["dfa"]:  # no engine route runs the table DFA
            raise AssertionError(f"dfa launched on the main path: "
                                 f"{main_launches['dfa']}")

        approx_seen: dict = {}  # the DP's lines, shared by -c and print
        inproc: dict = {}  # mr-out hashes of the CONTROL_QUERIES and 3f's
        solo_walls: dict = {}  # job walls of SERVICE_QUERIES (phase 3f)
        for (label, opts, files, oracle, kernels), (
                res, wall, launched, totals, route, transposed) in zip(
                    queries, per_query):
            t0 = time.perf_counter()
            kind = next(iter(oracle)) if isinstance(oracle, dict) else "lines"
            if kind in ("count", "approx_count"):
                got = {k: int(v) for k, v in res.iter_results()}
            else:
                got = job_lines(res)
            n_rec = 0

            def want_of(p: Path):
                if kind == "count":
                    return grep_oracle_count(p, oracle["count"])
                if kind in ("approx", "approx_count"):
                    key = (str(p), *oracle[kind][:3])
                    if key not in approx_seen:
                        approx_seen[key] = approx_oracle_lines(p,
                                                               *oracle[kind])
                    lines = approx_seen[key]
                    return len(lines) if kind == "approx_count" else lines
                return grep_oracle_lines(p, oracle)

            # the oracles of a query's files run side by side (grep is a
            # subprocess each)
            with ThreadPoolExecutor(len(files)) as pool:
                wants = list(pool.map(want_of, files))
            for p, want in zip(files, wants):
                counted = isinstance(want, int)
                have = got.get(str(p), 0 if counted else [])
                if have != want:
                    raise AssertionError(
                        f"query {label}: job output for {p.name} differs "
                        f"from the oracle ({have if counted else len(have)} "
                        f"vs {want if counted else len(want)})")
                n_rec += want if counted else len(want)
            segs = n_segments(files)
            for k in kernels:
                if launched[k] < segs:
                    raise AssertionError(
                        f"query {label}: {launched[k]} {k} launches for "
                        f"{segs} segments")
            checks = {
                "being it": totals.get("dense_confirms", 0)
                and totals.get("filter_defeated", 0),
                "config2": route == "fdr_literal_set",
                "config4 -i": totals.get("dense_confirms", 0)
                and launched["nfa"] > segs,
                "^the (old|new) ": totals.get("stitch_removed", 0) > 0,
                "volcano$": route == "dfa_filter",
                r"\bvolcano\b": route == "re_filter",
                "x[ab]{2,40}y": totals.get("dense_confirms", 0)
                and totals.get("nfa_filter_defeated", 0),
                "config3 -f": route == "fdr"
                and totals.get("stitch_added", 0) > 0,
                "config5 -f": route == "fdr" and totals.get("candidates", 0),
                "2-byte set": route == "pairset"
                and totals.get("stitch_added", 0) > 0,
                "config3 + '#'": route == "fdr",
                "SWAR volcano": totals.get("swar", 0),
                "SWAR -i Volcano": totals.get("swar", 0),
                "SWAR being it": totals.get("swar", 0)
                and totals.get("dense_confirms", 0)
                and totals.get("filter_defeated", 0),
            }
            if kind == "approx":  # the window stitch added lines
                checks[label] = (route == "approx"
                                 and totals.get("stitch_added", 0) > 0)
            if not checks.get(label, True):
                raise AssertionError(
                    f"query {label}: route {route}, launches {launched}, "
                    f"engine totals {totals}")
            # the Shift-And, approx, pairset and SWAR kernels read the
            # uploaded stripes; the NFA and FDR kernels a transpose of them
            # (a mixed set's FDR banks too, beside its pairset sidecar)
            stripe_route = set(kernels) <= {"shift_and", "approx", "pairset",
                                            "shift_and_swar"}
            if transposed != (0 if stripe_route else totals["segments"]):
                raise AssertionError(
                    f"query {label}: {transposed} layout transposes for "
                    f"{totals['segments']} segments on route {route}")
            # no segment of a few bytes at a chunk edge: a file of k
            # chunks scans as at most k segments
            if totals.get("segments", 0) > segs:
                raise AssertionError(
                    f"query {label}: {totals['segments']} segments where "
                    f"its files hold {segs} chunks")
            total_bytes = sum(p.stat().st_size for p in files)
            log(f"query {label!r} ({route}): {n_rec} lines identical to the "
                f"oracle (checked in {time.perf_counter() - t0:.1f} s); job "
                f"wall {wall:.3f} s = {total_bytes / wall / 1e9:.3f} GB/s end "
                f"to end over {total_bytes} bytes; launches {launched}; "
                f"on-card layout transposes {transposed} for "
                f"{totals['segments']} segments [{card}]")
            job_counts = res.metrics["counters"]
            log(f"  records {job_counts.get('map_records', 0)} in "
                f"{job_counts.get('map_batches', 0)} batches, reduce spills "
                f"{job_counts.get('reduce_spills', 0)}, read wait "
                f"{totals.get('read_wait_seconds', 0.0):.3f} s")
            log("  engine totals (seconds summed over worker threads): "
                + json.dumps(totals, sort_keys=True))
            if label in CONTROL_QUERIES or label in SERVICE_QUERIES:
                # phases 3c, 3d and 3f's reference bytes
                inproc[label] = mr_out_hashes(res.output_files)
                solo_walls[label] = wall
            shutil.rmtree(res.metrics["work_dir"], ignore_errors=True)

        # the CLI on one file, against the same oracle's display lines,
        # side by side with the five runs of cli_runs
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            five = pool.submit(cli_runs, [*words[:2], defeat[0]],
                               WORK / "cli")
            cli = subprocess.run(
                [sys.executable, "-m", "distributed_grep_tpu_torch", "grep",
                 "volcano", str(words[0]), "--work-dir",
                 str(WORK / "cli-one")],
                cwd=ROOT, capture_output=True, check=True, timeout=600,
            )
            five_lines = five.result()
        want_lines = grep_oracle_lines(words[0], fixed("volcano"))
        want = "".join(f"{words[0].resolve()} (line number #{n}) {v}\n"
                       for n, v in want_lines)
        if cli.stdout != want.encode("utf-8", "surrogateescape"):
            raise AssertionError("CLI output differs from the oracle")
        log(f"CLI grep volcano {words[0].name}: {len(want_lines)} lines "
            f"identical to the oracle ({time.perf_counter() - t0:.1f} s, "
            f"beside the five below)")
        for line in five_lines:
            log(line)
        t0 = time.perf_counter()
        tree_bytes = make_small_tree(words[1], WORK / "tree")
        log(f"small-file tree: 2000 files, {tree_bytes} bytes "
            f"({time.perf_counter() - t0:.1f} s)")
        for line in cli_display_runs(words, words[0]):
            log(f"{line} [{card}]")
        # the host routes through the CLI, in this process: one file of
        # word lines with empty and space-only lines, no final '\n'
        t0 = time.perf_counter()
        host_file = WORK / "host" / "lines.txt"
        host_file.parent.mkdir(parents=True, exist_ok=True)
        host_file.write_bytes(host_block(
            np.random.default_rng(args.seed + 13),
            min(args.file_mb, HOST_FILE_MB) << 20).tobytes())
        for line in host_query_runs(host_file, WORK / "host", counters):
            log(f"{line} [{card}]")
        log(f"host queries: {time.perf_counter() - t0:.1f} s")

        phase_warm_tiers(args, words, pats["config3"], counters, card, torch)
        # 3c and 3d repeat phase 3's jobs of their CONTROL_QUERIES
        phase_control_plane(half, set3, inproc, card)
        phase_telemetry(args, half, set3, inproc, card, counters)
        phase_tiers(args, words, card, counters)
        phase_service(half, set3, inproc, solo_walls, card, counters)
        phase_failover(half, set3, inproc, card)
        phase_multi_gpu(words[0], set3, card, counters)

        # ------------------------------------------- timings (not counted)
        log(f"== the timing block, card: {card}")
        # the match-dense receipt: 64 MiB, the CLI's wall and the host
        # stages of the same job in its own process, its output held to
        # the reference-format oracle
        receipt = subprocess.run(
            [sys.executable, "-m",
             "distributed_grep_tpu_torch.benchmarks.dense_receipt", "--check"],
            cwd=ROOT, capture_output=True, check=True, timeout=900)
        receipt_line = receipt.stdout.decode().strip().splitlines()[-1]
        if json.loads(receipt_line).get("check") != "ok":
            raise AssertionError(f"dense receipt: {receipt_line}")
        log(f"dense receipt [{card}]: {receipt_line}")
        rl = json.loads(receipt_line)
        log(f"dense receipt: CLI wall - job wall "
            f"{rl['cli_wall_s'] - rl['job_s']:.3f} s; in the CLI, its job "
            f"{rl['cli_job_s']:.3f} s and its print {rl['cli_print_s']:.3f} "
            f"s; the same CLI over an empty file {rl['cli_floor_s']:.3f} s "
            f"[{card}]")

        def segment(path: Path):
            data = path.read_bytes()[: 64 << 20]
            lay = choose_layout(len(data), **grep_cuda._engine.layout_kwargs())
            return data, lay, torch.from_numpy(to_device_array(data, lay)).cuda()

        seg, lay, dev = segment(words[0])
        # the same segment as uploaded: the stripes the Shift-And, approx,
        # pairset and SWAR kernels read, and the source of the NFA and FDR
        # routes' transpose
        dev_st = torch.from_numpy(padded_stripes(seg, lay)).cuda()
        _log_seg, lay_log, dev_log = segment(logs[0])
        pc_seg, lay_pc, dev_pc = segment(pcap[0])
        dev_pc_st = torch.from_numpy(padded_stripes(pc_seg, lay_pc)).cuda()
        assert {(x.chunk, x.lanes) for x in (lay, lay_log, lay_pc)} == {
            (lay.chunk, lay.lanes)}
        n_in = lay.chunk * lay.lanes
        n_out = (lay.chunk // 32) * lay.lanes * 4
        bytes_ms = (n_in + n_out) / H100_BYTES_PER_S * 1e3

        full = sa_mod.try_compile_shift_and("volcano")
        filt = sa_mod.filtered_for_device(full)
        ms = cuda_ms(torch, lambda: cuda_scan.shift_and_scan_words(
            dev_st, filt, True), 20)
        ms_full = cuda_ms(torch, lambda: cuda_scan.shift_and_scan_words(
            dev_st, full, True), 20)
        ms_exact = cuda_ms(torch, lambda: cuda_scan.shift_and_scan_words(
            dev_st, full, False), 20)
        plain_ms = cuda_ms(torch, lambda: cuda_scan.shift_and_scan_words_plain(
            dev_st, filt, True), 2)
        # the layout transpose the NFA and FDR routes run
        transpose_ms = cuda_ms(torch, lambda: dev_st.t().contiguous(), 20)
        sa_words = cuda_scan.shift_and_scan_words(dev_st, filt, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            idx, _v = sparse_nonzero(sa_words)
        fetch_ms = (time.perf_counter() - t0) * 100
        ops_ms = SHIFT_AND_OPS_PER_BYTE * n_in / H100_ALU_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        gbs = len(seg) / (ms / 1e3) / 1e9
        log(f"kernel shift_and coarse, volcano filter, stripes lanes="
            f"{lay.lanes} chunk={lay.chunk} (one 64 MB segment): {ms:.4f} ms = "
            f"{gbs:.1f} GB/s; full model {ms_full:.4f} ms; exact mode "
            f"{ms_exact:.4f} ms; plain version on the card {plain_ms:.2f} ms; "
            f"layout transpose on the card (NFA and FDR routes) "
            f"{transpose_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms (bytes {bytes_ms:.4f}, ops "
            f"{ops_ms:.4f}); sparse fetch of {idx.size} words "
            f"{fetch_ms:.3f} ms [{card}]")

        # the NFA kernel on each model's own corpus segment; the many-
        # specials model also on lines 'a' + 30..100 of [bc] + 'd', where
        # its specials are live
        models = nfa_models(nfa_mod)
        models["a[bc]{40,90}d on bc lines"] = models["a[bc]{40,90}d"]
        on_logs = {"config4 filter -i", "config4 exact -i"}
        dev_bc = torch.from_numpy(to_device_array(
            bc_block(np.random.default_rng(args.seed + 9), n_in), lay)).cuda()
        nfa_rows = {}
        for name, model in models.items():
            arr = (dev_log if name in on_logs
                   else dev_bc if name.endswith("bc lines") else dev)
            k_ms = cuda_ms(torch, lambda: nfa_scan.nfa_scan_words(arr, model),
                           20)
            # the plain version timed on the kernels line's model only
            # (the others' took about 25 s of the smoke)
            p_ms = (cuda_ms(torch, lambda: nfa_scan.nfa_scan_words_plain(
                arr, model), 1) if name == "config2 alternation" else None)
            live = [0] * model.n_words
            if model.n_specials:  # a second plain pass counts live steps
                nfa_scan.nfa_scan_words_plain(arr, model, live=live)
            spec_per_word = [0] * model.n_words
            for wp, _j, _f in model.specials:
                spec_per_word[wp] += 1
            ops = n_in * (NFA_OPS_PER_BYTE + NFA_OPS_PER_WORD * model.n_words)
            ops += sum(lv * k * (2 + model.n_words)
                       for lv, k in zip(live, spec_per_word))
            o_ms = ops / H100_ALU_OPS_PER_S * 1e3
            nfa_rows[name] = (k_ms, p_ms, max(bytes_ms, o_ms), o_ms)
            log(f"kernel nfa {name}: words={model.n_words} "
                f"specials={model.n_specials} (live special-word steps "
                f"{sum(live)} of {n_in * model.n_words}), chunk={lay.chunk} "
                f"lanes={lay.lanes}: {k_ms:.4f} ms = "
                f"{n_in / (k_ms / 1e3) / 1e9:.1f} GB/s; plain version on the "
                f"card {'not timed' if p_ms is None else f'{p_ms:.1f} ms'}; "
                f"bound {max(bytes_ms, o_ms):.4f} ms "
                f"(bytes {bytes_ms:.4f}, ops {o_ms:.4f}) [{card}]")
        del dev_bc, dev_log

        # the set kernels on their queries' corpora: the FDR banks of
        # configs 2 and 3 on words, config 5's on the pcap records (FDR on
        # the columns), the 2-byte set on the pcap stripes
        banks, pairsets = set_models(fdr_mod, ps_mod)
        set_rows = {}
        runs = [("fdr", "config2", banks["config2"], dev),
                ("fdr", "config3", banks["config3"], dev),
                ("fdr", "config5", banks["config5"], dev_pc),
                ("pairset", "2-byte set", pairsets["2-byte set"], dev_pc_st)]
        for kernel, name, model, arr in runs:
            if kernel == "fdr":
                k_ms = cuda_ms(torch, lambda: fdr_scan.fdr_scan_words(
                    arr, model), 20)
                p_ms = cuda_ms(torch, lambda: fdr_scan.fdr_scan_words_plain(
                    arr, model), 2)
                per_byte = (FDR_OPS_PER_BYTE
                            + FDR_OPS_PER_FAMILY * len(model.families)
                            + FDR_OPS_PER_CHECK * model.n_checks
                            + FDR_OPS_PER_SLOT * model.m)
                lookups = model.n_checks
            else:
                k_ms = cuda_ms(torch, lambda: pairset_scan.pairset_scan_words(
                    arr, model), 20)
                ps_graph_ms = graph_ms(lambda: pairset_scan.pairset_scan_words(
                    arr, model))
                p_ms = cuda_ms(torch, lambda: (
                    pairset_scan.pairset_scan_words_plain(arr, model)), 2)
                per_byte, lookups = PAIRSET_OPS_PER_BYTE, 2
            o_ms = per_byte * n_in / H100_ALU_OPS_PER_S * 1e3
            s_ms = lookups * n_in / H100_SMEM_LOOKUPS_PER_S * 1e3
            b_ms = max(bytes_ms, o_ms, s_ms)
            set_rows[name] = (k_ms, p_ms, b_ms,
                              "bytes" if b_ms == bytes_ms else "operations")
            log(f"kernel {kernel} {name}: "
                + (f"m={model.m} checks={model.checks} "
                   if kernel == "fdr" else "")
                + ("stripes " if kernel == "pairset" else "")
                + f"chunk={lay.chunk} lanes={lay.lanes}: {k_ms:.4f} ms = "
                f"{n_in / (k_ms / 1e3) / 1e9:.1f} GB/s"
                + (f" ({ps_graph_ms:.4f} ms on the card's clock, in a CUDA "
                   f"graph)" if kernel == "pairset" else "")
                + f"; plain version on the "
                f"card {p_ms:.1f} ms; bound {b_ms:.4f} ms (bytes "
                f"{bytes_ms:.4f}, ops {o_ms:.4f} at {per_byte} per byte, "
                f"shared-memory lookups {s_ms:.4f} at {lookups} per byte) "
                f"[{card}]")

        # the approx kernel on the words segment, one model per k
        n_smem_ms = n_in / H100_SMEM_LOOKUPS_PER_S * 1e3  # one lookup a byte
        approx_rows = {}
        for name, model in approx_models(ax_mod).items():
            if name.startswith("Volcano"):
                continue  # phase 2's extra -i model: the queries' three
            k_ms = cuda_ms(torch, lambda: approx_scan.approx_scan_words(
                dev_st, model), 20)
            p_ms = cuda_ms(torch, lambda: approx_scan.approx_scan_words_plain(
                dev_st, model), 1)
            per_byte = APPROX_OPS_PER_BYTE + APPROX_OPS_PER_ROW * model.k
            o_ms = per_byte * n_in / H100_ALU_OPS_PER_S * 1e3
            b_ms = max(bytes_ms, o_ms, n_smem_ms)
            approx_rows[model.k] = (k_ms, p_ms, b_ms,
                                    "bytes" if b_ms == bytes_ms
                                    else "operations")
            log(f"kernel approx {name}: stripes lanes={lay.lanes} "
                f"chunk={lay.chunk}: "
                f"{k_ms:.4f} ms = {n_in / (k_ms / 1e3) / 1e9:.1f} GB/s; plain "
                f"version on the card {p_ms:.1f} ms; bound {b_ms:.4f} ms "
                f"(bytes {bytes_ms:.4f}, ops {o_ms:.4f} at {per_byte} per "
                f"byte, shared-memory lookups {n_smem_ms:.4f}) [{card}]")

        # the SWAR kernel beside the Shift-And kernel on the same stripes
        # and model (the volcano filter), in turns: unpacked, packed,
        # packed, unpacked -- eagerly (the yardstick since run P) and on
        # the card's clock (CUDA graphs)
        sw_out = n_in // 32  # (chunk / 32) x (lanes / 4) uint32
        sw_bytes_ms = (n_in + sw_out) / H100_BYTES_PER_S * 1e3
        sw_ops_ms = SWAR_OPS_PER_BYTE * n_in / H100_ALU_OPS_PER_S * 1e3
        sw_bound_ms = max(sw_bytes_ms, sw_ops_ms, n_smem_ms)
        turns, g_turns = [], []
        for packed in (False, True, True, False):
            def fn(packed=packed):
                if packed:
                    return swar_scan.swar_scan_words(dev_st, filt)
                return cuda_scan.shift_and_scan_words(dev_st, filt, True)
            turns.append(cuda_ms(torch, fn, 20))
            g_turns.append(graph_ms(fn))
        sw_ms = (turns[1] + turns[2]) / 2
        sa_turn_ms = (turns[0] + turns[3]) / 2
        sw_g_ms = (g_turns[1] + g_turns[2]) / 2
        sa_g_ms = (g_turns[0] + g_turns[3]) / 2
        sw_full_ms = cuda_ms(torch, lambda: swar_scan.swar_scan_words(
            dev_st, full), 20)
        sw_plain_ms = cuda_ms(torch, lambda: swar_scan.swar_scan_words_plain(
            dev_st, filt), 2)
        log(f"kernel shift_and_swar, volcano filter, stripes chunk="
            f"{lay.chunk} lanes={lay.lanes}: {sw_ms:.4f} ms = "
            f"{n_in / (sw_ms / 1e3) / 1e9:.1f} GB/s (turns "
            f"{turns[1]:.4f}, {turns[2]:.4f}) vs csrc/shift_and.cu on the "
            f"same stripes {sa_turn_ms:.4f} ms (turns {turns[0]:.4f}, "
            f"{turns[3]:.4f}): SWAR {sa_turn_ms / sw_ms:.3f}x; on the card's "
            f"clock (CUDA graphs) {sw_g_ms:.4f} ms vs {sa_g_ms:.4f} ms (turns "
            + ", ".join(f"{t:.4f}" for t in g_turns)
            + f"): SWAR {sa_g_ms / sw_g_ms:.3f}x; full model "
            f"{sw_full_ms:.4f} ms; plain version on the card "
            f"{sw_plain_ms:.2f} ms; bound {sw_bound_ms:.4f} ms (bytes "
            f"{sw_bytes_ms:.4f}, ops {sw_ops_ms:.4f}, shared-memory lookups "
            f"{n_smem_ms:.4f}) [{card}]")

        # the table-DFA kernel, on no engine route (kernel_compare's dfa and
        # aho engines run it): 'nee(dle|t)' (its table in shared memory)
        # and config 3's Aho-Corasick bank (0.8 MB, through the L2) on the
        # words stripes, config 5's first bank (57 MB, past the L2) on the
        # pcap stripes; eagerly and on the card's clock (CUDA graphs)
        dfa_rows = {}
        for name, table, arr in (
                ("nee(dle|t)", dfa_mod.compile_dfa("nee(dle|t)"), dev_st),
                ("config 3 bank", aho_mod.compile_aho_corasick(set3), dev_st),
                ("config 5 bank 0", aho_mod.compile_aho_corasick_banks(
                    set5)[0], dev_pc_st)):
            k_ms = cuda_ms(torch, lambda: dfa_scan.dfa_scan_words(arr, table),
                           20)
            g_ms = graph_ms(lambda: dfa_scan.dfa_scan_words(arr, table))
            p_ms = cuda_ms(torch, lambda: dfa_scan.dfa_scan_words_plain(
                arr, table), 1)
            plan = dfa_scan.launch_plan(table, lay.lanes, lay.chunk)
            fx = torch.zeros(2, dtype=torch.int64, device=arr.device)
            dfa_scan.dfa_scan_words(arr, table, fixups=fx)
            shared = plan[1] != "global"
            table_bytes = 4 * table.n_states * table.n_classes + 256
            b_ms = (n_in + n_out + table_bytes) / H100_BYTES_PER_S * 1e3
            l_ms = DFA_LOOKUPS_PER_BYTE * n_in / H100_SMEM_LOOKUPS_PER_S * 1e3
            l2_ms = n_in / H100_L2_SECTORS_PER_S * 1e3
            dfa_rows[name] = (k_ms, p_ms, max(b_ms, l_ms),
                              "bytes" if b_ms >= l_ms else "operations")
            log(f"kernel dfa {name}: states={table.n_states} classes="
                f"{table.n_classes} table {table_bytes} bytes in "
                f"{'shared memory' if shared else 'global memory'}, plan "
                f"n_sub={plan[0]} branch={plan[1]}, fix-ups "
                f"{int(fx[0])} bytes re-walked in {int(fx[1])} rounds, "
                f"stripes chunk={lay.chunk} lanes={lay.lanes}: {k_ms:.4f} "
                f"ms = {n_in / (k_ms / 1e3) / 1e9:.1f} GB/s ({g_ms:.4f} ms "
                f"on the card's clock, in a CUDA graph; first design: "
                f"{FIRST_DFA_MS[('dfa', name)]} ms); plain version on the card "
                f"{p_ms:.1f} ms; bound {max(b_ms, l_ms):.4f} ms (bytes "
                f"{b_ms:.4f} with the table, table reads {l_ms:.4f} at the "
                f"shared-memory / L1 lookup rate), bound by "
                f"{dfa_rows[name][3]}; every entry read from the L2 would "
                f"take {l2_ms:.4f} [{card}]")

        # K2, the k-byte-stride walk (kernel_compare's stride<k> engines
        # run it): 'nee(dle|t)' and config 3's bank on the words stripes,
        # at k = 2 and 4 where the composed table fits choose_stride's
        # caps; eagerly and on the card's clock.  Its bound: the bytes
        # (with the composed table), or a class lookup a byte and a table
        # read a stride at the shared-memory / L1 lookup rate
        stride_rows = {}
        for name, table in (("nee(dle|t)", dfa_mod.compile_dfa("nee(dle|t)")),
                            ("config 3 bank",
                             aho_mod.compile_aho_corasick(set3))):
            for k in (2, 4):
                cols = table.n_classes ** k
                if cols > 1 << 13 or table.n_states * cols > 1 << 23:
                    log(f"kernel dfa_stride {name} k={k}: composed table of "
                        f"{table.n_states} x {cols} past choose_stride's "
                        f"caps, not run")
                    continue
                stt = dfa_mod.build_stride_table(table, k)
                k_ms = cuda_ms(torch, lambda: dfa_scan.dfa_stride_words(
                    dev_st, stt), 20)
                g_ms = graph_ms(lambda: dfa_scan.dfa_stride_words(dev_st,
                                                                  stt))
                p_ms = cuda_ms(torch, lambda: dfa_scan.dfa_stride_words_plain(
                    dev_st, stt), 1)
                plan = dfa_scan.stride_launch_plan(stt, lay.lanes, lay.chunk)
                fx = torch.zeros(2, dtype=torch.int64, device=dev_st.device)
                dfa_scan.dfa_stride_words(dev_st, stt, fixups=fx)
                table_bytes = 4 * stt.trans_k.size + 256
                b_ms = (n_in + n_out + table_bytes) / H100_BYTES_PER_S * 1e3
                l_ms = ((1 + 1 / k) * n_in / H100_SMEM_LOOKUPS_PER_S * 1e3)
                stride_rows[(name, k)] = (k_ms, p_ms, max(b_ms, l_ms),
                                          "bytes" if b_ms >= l_ms
                                          else "operations")
                k1_ms = dfa_rows[name][0] if name in dfa_rows else None
                log(f"kernel dfa_stride {name} k={k}: states={stt.n_states} "
                    f"columns={cols} table {table_bytes} bytes in "
                    f"{'global memory' if plan[1] == 'global' else 'shared memory'}"
                    f", plan n_sub={plan[0]} branch={plan[1]}, fix-ups "
                    f"{int(fx[0])} bytes re-walked in {int(fx[1])} rounds, "
                    f"stripes chunk={lay.chunk} lanes={lay.lanes}: "
                    f"{k_ms:.4f} ms = {n_in / (k_ms / 1e3) / 1e9:.1f} GB/s "
                    f"({g_ms:.4f} ms on the card's clock, in a CUDA graph; "
                    f"first design: "
                    f"{FIRST_DFA_MS[('dfa_stride', name, k)]} ms); "
                    f"K1 on the same table {k1_ms:.4f} ms; plain version on "
                    f"the card {p_ms:.1f} ms; bound {max(b_ms, l_ms):.4f} ms "
                    f"(bytes {b_ms:.4f} with the table, lookups {l_ms:.4f}), "
                    f"bound by {stride_rows[(name, k)][3]} [{card}]")
        if ("nee(dle|t)", 4) not in stride_rows:
            raise AssertionError("dfa_stride: 'nee(dle|t)' at k = 4 not timed")

        # the confirm set on config 5's real candidates of one segment
        words5 = fdr_scan.fdr_scan_words(dev_pc, banks["config5"])
        c_idx, c_vals = sparse_nonzero(words5)
        cands = offsets_from_sparse_words(c_idx, c_vals, lay_pc)
        confirm = ConfirmSet(set5)
        t0 = time.perf_counter()
        keep = confirm.confirm(pc_seg, cands)
        c_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        keep_np = ConfirmSetNumpy(set5).confirm(pc_seg, cands)
        c_np_s = time.perf_counter() - t0
        if not np.array_equal(keep, keep_np):
            raise AssertionError("confirm set: the library and numpy differ "
                                 "on config 5's candidates")
        log(f"confirm set, config 5 (10,000 members) on one 64 MB pcap "
            f"segment: {cands.size} candidates ({cands.size / len(pc_seg):.4f}"
            f" per byte, analytic {banks['config5'].fp_per_byte:.4f}), "
            f"{int(keep.sum())} confirmed, {c_s:.3f} s = "
            f"{c_s / max(cands.size, 1) * 1e9:.1f} ns per candidate (host "
            f"library, {native.THREADS} threads); numpy plain version "
            f"{c_np_s:.3f} s = {c_np_s / max(cands.size, 1) * 1e9:.1f} ns "
            f"(one thread)")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    # ---------------------------------------------------------- phase 4
    log(f"== phase 4: the measuring path, card: {card}")
    t0 = time.perf_counter()
    measured = phase_measuring(counters)
    log(f"phase 4: {time.perf_counter() - t0:.1f} s")

    # ------------------------------- the probe kernels' timings (not counted)
    from distributed_grep_tpu_torch.benchmarks import kernel_compare as kc_mod
    from distributed_grep_tpu_torch.benchmarks import probe_narrow as pn_mod
    from distributed_grep_tpu_torch.utils.slope import device_setup

    probe_layout = dict(lane_multiple=4096, chunk_multiple=512, min_chunk=512)
    dev_kc, lay_kc, _ = device_setup(kc_mod.make_corpus(64 << 20), "cuda",
                                     **probe_layout)
    x = dev_kc[: lay_kc.chunk]
    n_x = x.numel()
    member = torch.from_numpy(mxu_probe.probe_member()).cuda()
    mxu_ms = cuda_ms(torch, lambda: mxu_probe.mxu_dot(x, member), 10)
    mxu_graph_ms = graph_ms(lambda: mxu_probe.mxu_dot(x, member), 10, 3)
    mxu_mhz, mxu_max_mhz, mxu_busy = sm_clock_under(
        torch, lambda: mxu_probe.mxu_dot(x, member))
    mxu_clock_ms = (MXU_MACS_PER_BYTE * n_x / (
        torch.cuda.get_device_properties(0).multi_processor_count
        * H100_INT8_MACS_PER_SM_CLOCK * mxu_mhz * 1e6) * 1e3)
    mxu_plain_ms = cuda_ms(torch, lambda: mxu_probe.mxu_dot_plain(x, member), 2)
    mxu_ops_ms = 2 * MXU_MACS_PER_BYTE * n_x / H100_INT8_OPS_PER_S * 1e3
    mxu_bytes_ms = (n_x + x.shape[1] // 4096 * 128 * 128 * 4) / H100_BYTES_PER_S * 1e3
    # the library yardstick: one cuBLAS int8 GEMM of the same one-hot
    # product, over a 1 MiB window's materialized one-hot, scaled to n_x
    win = x.reshape(-1)[: 1 << 20].to(torch.int64)
    onehot = torch.zeros((win.numel(), 256), dtype=torch.int8,
                         device=x.device).scatter_(1, win[:, None], 1)
    lib_1mib_ms = cuda_ms(torch, lambda: torch._int_mm(onehot, member), 10)
    lib_sum = torch._int_mm(onehot, member).sum(0, dtype=torch.int64)
    want_sum = (torch.bincount(win, minlength=256).to(torch.float64)
                @ member.to(torch.float64)).to(torch.int64)
    if not torch.equal(lib_sum, want_sum):
        raise AssertionError("torch._int_mm one-hot product != byte counts @ member")
    mxu_lib_ms = lib_1mib_ms * n_x / win.numel()
    del onehot, dev_kc, x
    log(f"kernel mxu_dot, chunk={lay_kc.chunk} lanes={lay_kc.lanes} ({n_x} bytes, "
        f"{lay_kc.lanes // 4096} lane blocks, "
        f"{mxu_probe.default_blocks(member.device)} blocks): {mxu_ms:.4f} ms = "
        f"{n_x / (mxu_ms / 1e3) / 1e9:.2f} GB/s = "
        f"{MXU_MACS_PER_BYTE * n_x / (mxu_ms / 1e3) / 1e12:.1f} TMAC/s "
        f"({mxu_graph_ms:.4f} ms on the card's clock, in a CUDA graph: "
        f"{mxu_ops_ms / mxu_graph_ms:.3f} of the int8 bound); SM clock "
        f"{mxu_mhz} MHz (max {mxu_max_mhz}; read "
        f"{'under' if mxu_busy else 'after'} load): int8 bound at that clock "
        f"{mxu_clock_ms:.4f} ms, {mxu_clock_ms / mxu_graph_ms:.3f} of it; plain "
        f"version on the card {mxu_plain_ms:.2f} ms; bound {mxu_ops_ms:.4f} ms "
        f"(int8 operations; bytes {mxu_bytes_ms:.4f}); torch._int_mm over a "
        f"1 MiB one-hot {lib_1mib_ms:.4f} ms, scaled to {n_x} bytes {mxu_lib_ms:.3f}"
        f" ms [{card}]")

    dev_pn, lay_pn, _ = device_setup(pn_mod._corpus(64 << 20), "cuda",
                                     **probe_layout)
    y = dev_pn[: lay_pn.chunk]
    n_y = y.numel()
    # the three widths in turns: i32 i16 i8 i8 i16 i32, eagerly (the
    # yardstick since run P) and on the card's clock (CUDA graphs)
    order = ["i32", "i16", "i8"]
    turns: dict[str, list[float]] = {w: [] for w in order}
    g_turns: dict[str, list[float]] = {w: [] for w in order}
    for w in order + order[::-1]:
        def fn(w=w):
            return narrow_probe.narrow_probe_words(y, w)
        turns[w].append(cuda_ms(torch, fn, 20))
        g_turns[w].append(graph_ms(fn))
    narrow_ms = {w: sum(t) / len(t) for w, t in turns.items()}
    narrow_g_ms = {w: sum(t) / len(t) for w, t in g_turns.items()}
    narrow_plain_ms = cuda_ms(
        torch, lambda: narrow_probe.narrow_probe_words_plain(y, "i32"), 2)
    nb_ms = (n_y + n_y // 8) / H100_BYTES_PER_S * 1e3  # 1 byte in, 1/8 out
    nops_ms = NARROW_OPS_PER_BYTE * n_y / H100_ALU_OPS_PER_S * 1e3
    narrow_bound_ms = max(nb_ms, nops_ms)
    del dev_pn, y
    log(f"kernel narrow_probe, chunk={lay_pn.chunk} lanes={lay_pn.lanes} "
        f"({n_y} bytes): " + ", ".join(
            f"{w} {narrow_ms[w]:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in turns[w])}; "
            f"{narrow_ms['i32'] / narrow_ms[w]:.3f}x the speed of i32)"
            for w in order)
        + "; on the card's clock (CUDA graphs) " + ", ".join(
            f"{w} {narrow_g_ms[w]:.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in g_turns[w])}; "
            f"{narrow_g_ms['i32'] / narrow_g_ms[w]:.3f}x)" for w in order)
        + f"; plain version (i32) on the card {narrow_plain_ms:.2f} ms; bound "
        f"{narrow_bound_ms:.4f} ms (bytes {nb_ms:.4f}, ops {nops_ms:.4f} at "
        f"{NARROW_OPS_PER_BYTE} per byte) [{card}]")

    log(f"total {time.perf_counter() - t_all:.1f} s")
    nfa_ms, nfa_plain_ms, nfa_bound_ms, nfa_ops_ms = nfa_rows[
        "config2 alternation"]
    fdr_ms, fdr_plain_ms, fdr_bound_ms, fdr_by = set_rows["config5"]
    ps_ms, ps_plain_ms, ps_bound_ms, ps_by = set_rows["2-byte set"]
    print(json.dumps(native_line))
    print(json.dumps({"kernels": [{
        "name": "shift_and",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/shift_and.cu",
        "replaces": "distributed_grep_tpu/ops/pallas_scan.py:91",
        "launches": main_launches["shift_and"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }, {
        "name": "nfa",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/nfa.cu",
        "replaces": "distributed_grep_tpu/ops/pallas_nfa.py:120",
        "launches": main_launches["nfa"],
        "max_abs_err": nfa_err,
        "ms": nfa_ms,
        "plain_ms": nfa_plain_ms,
        "bound_ms": nfa_bound_ms,
        "bound_by": "bytes" if bytes_ms >= nfa_ops_ms else "operations",
        "library_ms": None,
    }, {
        "name": "fdr",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/fdr.cu",
        "replaces": "distributed_grep_tpu/ops/pallas_fdr.py:109",
        "launches": main_launches["fdr"],
        "max_abs_err": fdr_err,
        "ms": fdr_ms,
        "plain_ms": fdr_plain_ms,
        "bound_ms": fdr_bound_ms,
        "bound_by": fdr_by,
        "library_ms": None,
    }, {
        "name": "approx",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/approx.cu",
        "replaces": "distributed_grep_tpu/ops/pallas_approx.py:43",
        "launches": main_launches["approx"],
        "max_abs_err": approx_err,
        "ms": approx_rows[1][0],
        "plain_ms": approx_rows[1][1],
        "bound_ms": approx_rows[1][2],
        "bound_by": approx_rows[1][3],
        "library_ms": None,
    }, {
        "name": "shift_and_swar",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/shift_and_swar.cu",
        "replaces": "distributed_grep_tpu/ops/pallas_scan.py:319",
        "launches": main_launches["shift_and_swar"],
        "max_abs_err": swar_err,
        "ms": sw_ms,
        "plain_ms": sw_plain_ms,
        "bound_ms": sw_bound_ms,
        "bound_by": ("bytes" if sw_bound_ms == sw_bytes_ms
                     else "operations"),
        "library_ms": None,
    }, {
        "name": "pairset",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/pairset.cu",
        "replaces": "distributed_grep_tpu/ops/pallas_pairset.py:66",
        "launches": main_launches["pairset"],
        "max_abs_err": ps_err,
        "ms": ps_ms,
        "plain_ms": ps_plain_ms,
        "bound_ms": ps_bound_ms,
        "bound_by": ps_by,
        "library_ms": None,
    }, {
        "name": "narrow_probe",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/probe_narrow.cu",
        "replaces": "benchmarks/probe_narrow.py:39",
        "launches": measured["launches"]["narrow_probe"],
        "max_abs_err": narrow_err,
        "ms": narrow_ms["i32"],
        "plain_ms": narrow_plain_ms,
        "bound_ms": narrow_bound_ms,
        "bound_by": "bytes" if narrow_bound_ms == nb_ms else "operations",
        "library_ms": None,
    }, {
        "name": "mxu_dot",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/mxu_dot.cu",
        "replaces": "benchmarks/kernel_compare.py:193",
        "launches": measured["launches"]["mxu_dot"],
        "max_abs_err": mxu_err,
        "ms": mxu_ms,
        "plain_ms": mxu_plain_ms,
        "bound_ms": max(mxu_ops_ms, mxu_bytes_ms),
        "bound_by": "operations" if mxu_ops_ms >= mxu_bytes_ms else "bytes",
        "library_ms": mxu_lib_ms,
    }, {
        "name": "dfa",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/dfa.cu",
        "replaces": "distributed_grep_tpu/ops/scan_jnp.py:81",
        "launches": measured["launches"]["dfa"],
        "max_abs_err": dfa_err,
        "ms": dfa_rows["nee(dle|t)"][0],
        "plain_ms": dfa_rows["nee(dle|t)"][1],
        "bound_ms": dfa_rows["nee(dle|t)"][2],
        "bound_by": dfa_rows["nee(dle|t)"][3],
        "library_ms": None,
    }, {
        "name": "dfa_stride",
        "route": "cuda",
        "source": "distributed_grep_tpu_torch/csrc/dfa.cu",
        "replaces": "distributed_grep_tpu/ops/scan_jnp.py:99",
        "launches": measured["launches"]["dfa_stride"],
        "max_abs_err": stride_err,
        "ms": stride_rows[("nee(dle|t)", 4)][0],
        "plain_ms": stride_rows[("nee(dle|t)", 4)][1],
        "bound_ms": stride_rows[("nee(dle|t)", 4)][2],
        "bound_by": stride_rows[("nee(dle|t)", 4)][3],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
