"""Job walls of chip_smoke.py's phase-3 queries on one checkout, so that two
checkouts (a change and its parent) compare within one call.

    python3 distributed_grep_tpu_torch/benchmarks/host_walls.py corpus DIR \\
        [--seed 0] [--file-mb 128] [--n-files 8]
    python3 distributed_grep_tpu_torch/benchmarks/host_walls.py run DIR \\
        --tree ROOT --label NAME [--only LABEL,...] [--workers 2]
        [--device cuda|cpu] [--receipt-mb 64]

``corpus`` writes chip_smoke.py's corpora under DIR once, from its recipes
and seed: word lines with injected needles, access-log lines, PCAP-like
records and the defeat file; two dense files, the first 32 MiB (to a
line end) of the first two word files; and chip_smoke.py's small-file
tree (2,000 files of 4-64 KiB cut from the second word file, one in ten
``.log``) with config 3's members as a pattern file.

``run`` imports ``distributed_grep_tpu_torch`` from ROOT (any checkout
beside this one: run it as a file, not with -m, so that ROOT's package is
the one imported) and runs each query of chip_smoke.py's section-5 table
through ROOT's ``runtime.job.run_job`` on the card (its kernels built
first), a new engine a query, two workers, ``n_reduce`` 10.  One JSON line a query: the job wall, the
job's seconds and counters, the engine's totals, and the sha256 of its
``mr-out-*`` bytes (checkouts that agree print the same hash).  Then, in
processes of their own with ROOT as the working directory: ROOT's dense
receipt (``benchmarks/dense_receipt.py --check``), and the CLI on ``the``
over the two dense files with ``--metrics`` (the display of a job of two
files, about 580k lines, inside ``JobResult.DISPLAY_VECTOR_CAP``), and
the CLI on ``-r --include '*.txt' -F -f`` config 3 over the tree with
``--metrics`` (``cli -r``: the wall, the job's seconds, its map tasks, the
engine's batch counters and the FDR/pairset launches), each a JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def smoke_module():
    """chip_smoke.py of this checkout: the corpus recipes and constants."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_corpora(out: Path, seed: int, n_files: int, file_mb: int) -> None:
    smoke = smoke_module()
    out = out.resolve()  # the runs' working directories differ
    smoke.WORK = out
    size = file_mb << 20
    files = {"words": smoke.make_corpus(seed, n_files, size),
             "logs": smoke.make_log_corpus(seed, n_files, size),
             "pcap": smoke.make_pcap_corpus(seed, n_files, size),
             "defeat": [smoke.make_defeat_file(seed, size)]}
    files["dense"] = []
    for i, src in enumerate(files["words"][:2]):
        head = src.read_bytes()[: 32 << 20]
        files["dense"].append(out / f"dense-{i}.txt")
        files["dense"][-1].write_bytes(head[: head.rindex(b"\n") + 1])
    smoke.make_small_tree(files["words"][1], out / "tree")
    pats3 = out / "config3.pats"
    pats3.write_bytes(b"\n".join(smoke.config3_set()) + b"\n")
    files["tree"], files["pats3"] = [out / "tree"], [pats3]
    (out / "files.json").write_text(json.dumps(
        {k: [str(p) for p in v] for k, v in files.items()}))


def queries(smoke) -> list[tuple[str, dict, str]]:
    """(label, app options, corpus) of chip_smoke.py's phase-3 queries."""
    set3, set5 = smoke.config3_set(), smoke.config5_set()

    def one(pattern: str, ic: bool = False, **kw) -> dict:
        return {"pattern": pattern, "ignore_case": ic, **kw}

    return [
        ("volcano", one("volcano"), "words"),
        ("-i Volcano", one("Volcano", True), "words"),
        ("the", one("the"), "words"),
        ("being it", one("being it"), "words"),
        ("config2", one(smoke.CONFIG2), "words"),
        ("config4 -i", one(smoke.CONFIG4, True), "logs"),
        ("^the (old|new) ", one("^the (old|new) "), "words"),
        ("volcano$", one("volcano$"), "words"),
        (r"\bvolcano\b", one(r"\bvolcano\b"), "words"),
        ("x[ab]{2,40}y", one("x[ab]{2,40}y"), "defeat"),
        ("config3 -f", {"patterns": set3}, "words"),
        ("config5 -f", {"patterns": set5}, "pcap"),
        ("2-byte set", {"patterns": smoke.PAIR_SET}, "pcap"),
        ("config3 + '#'", {"patterns": set3 + [b"#"]}, "words"),
        *[(f"--max-errors {k}{' -i' if ic else ''} {p}",
           one(p, ic, max_errors=k), "words")
          for p, k, ic, _pieces in smoke.APPROX_QUERIES],
        ("-w volcano", one("volcano", word_regexp=True), "words"),
        ("-w -F -f config3", {"patterns": set3, "word_regexp": True},
         "words"),
        ("-c the", one("the", count_only=True), "words"),
        ("-v volcano", one("volcano", invert=True), "words:1"),
        ("-x -E logs", one(smoke.LOG_LINE_X, line_regexp=True), "logs"),
        ("-c --max-errors 2 -i volcano",
         one("volcano", True, max_errors=2, count_only=True), "words"),
        ("SWAR volcano", one("volcano"), "words"),
        ("SWAR -i Volcano", one("Volcano", True), "words"),
        ("SWAR being it", one("being it"), "words"),
    ]


def outputs_hash(files) -> str:
    """sha256 of the files' names and bytes, in name order."""
    h = hashlib.sha256()
    for p in sorted(files, key=lambda p: p.name):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:16]


def run(corpus: Path, tree: Path, label: str, only: set | None,
        workers: int, device: str, receipt_mb: int) -> None:
    sys.path.insert(0, str(tree))
    from distributed_grep_tpu_torch.apps import grep_cuda
    from distributed_grep_tpu_torch.ops import _build
    from distributed_grep_tpu_torch.runtime.job import run_job
    from distributed_grep_tpu_torch.utils.config import JobConfig

    import distributed_grep_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parents[1] != tree.resolve():
        raise SystemExit(f"imported {pkg.__file__}, not ROOT's package")
    smoke = smoke_module()
    corpus = corpus.resolve()
    files = {k: [Path(p) for p in v] for k, v in json.loads(
        (corpus / "files.json").read_text()).items()}
    work = corpus / f"jobs-{label}"
    if device == "cuda":  # no query's wall holds a kernel build
        _build.build_all()
    # a tree whose run_job loads a fresh app instance takes the module
    # itself (its engine is read below), and runs as the CLI does: no
    # journal, no fsync (a tree before them had neither)
    job_kw, cfg_kw = {}, {}
    if "app" in inspect.signature(run_job).parameters:
        from distributed_grep_tpu_torch.apps.loader import from_module

        job_kw["app"] = from_module(grep_cuda)
    if "durable" in JobConfig.__dataclass_fields__:
        cfg_kw = {"journal": False, "durable": False}
    for name, opts, which in queries(smoke):
        if only and name not in only:
            continue
        kind, _, count = which.partition(":")
        inputs = files[kind][: int(count)] if count else files[kind]
        os.environ.pop("DGREP_SWAR", None)
        if name.startswith("SWAR "):
            os.environ["DGREP_SWAR"] = "1"
        # a new engine: its own totals (a tree with the cross-job engine
        # cache would hand a repeated query its earlier engine)
        grep_cuda._configured_with = None
        engine_mod = sys.modules.get("distributed_grep_tpu_torch.ops.engine")
        if engine_mod is not None:
            engine_mod.model_cache_clear()
        cfg = JobConfig(input_files=[str(p) for p in inputs],
                        app_options=dict(opts), n_reduce=10,
                        task_timeout_s=60.0, work_dir=str(work), **cfg_kw)
        t0 = time.perf_counter()
        res = run_job(cfg, n_workers=workers, device=device, **job_kw)
        wall = time.perf_counter() - t0
        os.environ.pop("DGREP_SWAR", None)
        totals = {k: v for k, v in grep_cuda._engine.totals.items()
                  if isinstance(v, (int, float))}
        print(json.dumps({
            "tree": label, "query": name, "route": grep_cuda._engine.route,
            "wall_s": wall, "seconds": res.metrics["seconds"],
            "counters": res.metrics["counters"], "totals": totals,
            "bytes": sum(p.stat().st_size for p in inputs),
            "out_sha": outputs_hash(res.output_files)}), flush=True)
    env = {**os.environ, "PYTHONPATH": str(tree)}
    if not only or "receipt" in only:
        r = subprocess.run([sys.executable, "-m",
                            "distributed_grep_tpu_torch.benchmarks."
                            "dense_receipt", "--check", "--device", device,
                            "--mb", str(receipt_mb)], cwd=tree, env=env,
                           capture_output=True, check=True, timeout=900)
        print(json.dumps({"tree": label, "query": "dense receipt",
                          **json.loads(r.stdout.decode().splitlines()[-1])}),
              flush=True)
    if not only or "cli the" in only:
        out = corpus / f"cli-{label}.out"
        t0 = time.perf_counter()
        with open(out, "wb") as f:
            r = subprocess.run(
                [sys.executable, "-m", "distributed_grep_tpu_torch", "grep",
                 "the", *map(str, files["dense"]), "--metrics",
                 "--device", device,
                 "--work-dir", str(corpus / f"cli-job-{label}")],
                cwd=tree, env=env, stdout=f, stderr=subprocess.PIPE,
                timeout=900)
        wall = time.perf_counter() - t0
        metrics = smoke.cli_metrics("the", r.returncode, r.stderr)
        print(json.dumps({"tree": label, "query": "cli the (2 dense files)",
                          "wall_s": wall, "rc": r.returncode,
                          "cli_job_s": metrics["seconds"].get("cli_job"),
                          "cli_print_s": metrics["seconds"].get("cli_print"),
                          "stdout_bytes": out.stat().st_size,
                          "out_sha": hashlib.sha256(
                              out.read_bytes()).hexdigest()[:16]}),
              flush=True)
        out.unlink()
    if (not only or "cli -r" in only) and "tree" in files:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "distributed_grep_tpu_torch", "grep", "-r",
             "--include", "*.txt", "-F", "-f", str(files["pats3"][0]),
             str(files["tree"][0]), "--metrics", "--device", device,
             "--work-dir", str(corpus / f"cli-tree-{label}")],
            cwd=tree, env=env, capture_output=True, timeout=900)
        wall = time.perf_counter() - t0
        metrics = smoke.cli_metrics("-r", r.returncode, r.stderr)
        eng = metrics.get("engine", {})
        print(json.dumps({
            "tree": label, "query": "cli -r --include '*.txt' -F -f config3",
            "wall_s": wall, "rc": r.returncode,
            "cli_job_s": metrics["seconds"].get("cli_job"),
            "cli_print_s": metrics["seconds"].get("cli_print"),
            "map_tasks": metrics["counters"].get("map_completed"),
            "segments": eng.get("segments"),
            **{k: eng.get(k) for k in ("batch_dispatches", "solo_dispatches",
                                       "batched_files", "batch_fill_ratio",
                                       "small_host_scan")},
            "launches": {k: metrics["launches"][k] for k in ("fdr",
                                                             "pairset")},
            "out_sha": hashlib.sha256(r.stdout).hexdigest()[:16]}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("corpus", "run"))
    ap.add_argument("dir", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--file-mb", type=int, default=128)
    ap.add_argument("--n-files", type=int, default=8)
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", default="")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--receipt-mb", type=int, default=64)
    args = ap.parse_args()
    if args.mode == "corpus":
        make_corpora(args.dir, args.seed, args.n_files, args.file_mb)
        return 0
    only = {s for s in args.only.split(",") if s} or None
    run(args.dir, args.tree, args.label, only, args.workers, args.device,
        args.receipt_mb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
