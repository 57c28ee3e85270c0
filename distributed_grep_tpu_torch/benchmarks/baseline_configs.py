"""BASELINE.json config suite on the port: the 5 headline scan scenarios.

The port's counterpart of ``benchmarks/baseline_configs.py``.  Each config
synthesizes the reference's corpus (same recipes, same seeds, so the same
bytes) and measures ``GrepEngine.scan`` end to end -- the segment pipeline
on the card, the sparse fetch and the host confirm and stitch -- or, with
``--timing slope``, the config's kernels alone on a device-resident copy
(``utils/slope.py``).

    python -m distributed_grep_tpu_torch.benchmarks.baseline_configs \\
        [--size-mb 64] [--configs 1,3] [--device cuda|cpu] [--check] \\
        [--timing e2e|slope]

Prints one JSON line per config:
    {"config": N, "name": "...", "value": GB/s, "unit": "GB/s",
     "matched_lines": M, "mode": "...", ...}

The configs route to the port's kernels: 1 Shift-And (the rare-class
filter), 2 FDR (literal decomposition of the alternation), 3 FDR, 4 the
relaxed NFA filter with the exact model's dense confirm, 5 FDR.  ``banks``
is the number of kernel launches per segment (FDR banks, plus the pairset
sidecar where a set has one).

--check also greps every split with an independent oracle -- ``grep -naF
-f`` (LC_ALL=C) for pattern sets, Python ``re`` per line otherwise -- and
asserts the engine's matched lines agree exactly.  Without a card and
without --device cpu the script exits 2 and prints nothing on stdout.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np

WORDS = (
    "the of and to in a is that for it as was with be by on not he this are "
    "at from or have an they which one you were all her she there would their "
    "we him been has when who will no more if out so up said what its about "
    "than into them can only other time new some could these two may first "
    "then do any like my now over such our man me even most made after also "
    "did many fff needle volcano anarchism philosophy wikipedia"
).split()


def _words_text(size: int, seed: int, line_words=12) -> bytes:
    """English-like filler (enwik/WET-like: words, spaces, newlines)."""
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < size:
        k = int(rng.integers(3, line_words * 2))
        line = b" ".join(WORDS[i].encode() for i in rng.integers(0, len(WORDS), k))
        out.append(line)
        n += len(line) + 1
    return b"\n".join(out)[:size]


def _log_text(size: int, seed: int) -> bytes:
    """NASA-HTTP-style access log lines."""
    rng = np.random.default_rng(seed)
    hosts = [f"host{i}.example.com".encode() for i in range(100)]
    paths = [b"/images/logo", b"/shuttle/missions", b"/cgi-bin/query",
             b"/images/KSC-small.gif", b"/history/apollo", b"/icons/menu.gif"]
    out, n = [], 0
    while n < size:
        h = hosts[int(rng.integers(0, len(hosts)))]
        p = paths[int(rng.integers(0, len(paths)))]
        code = int(rng.integers(200, 505))
        sz = int(rng.integers(0, 100000))
        line = b'%s - - [01/Jul/1995:00:00:%02d -0400] "GET %s HTTP/1.0" %d %d' % (
            h, int(rng.integers(0, 60)), p, code, sz)
        out.append(line)
        n += len(line) + 1
    return b"\n".join(out)[:size]


def _binary_payload(size: int, seed: int) -> bytes:
    """PCAP-payload-like bytes: mixed binary with ~120-byte 'packets' split
    by '\\n' records."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=size, dtype=np.uint8)
    data[data == 0x0A] = 0x0B  # strip accidental newlines...
    data[rng.integers(0, size, size=size // 120)] = 0x0A  # ...then add records
    return data.tobytes()


def _rand_literals(n: int, lo: int, hi: int, seed: int, alphabet=None) -> list[str]:
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


def _inject(data: bytes, needles: list[bytes], count: int, seed: int) -> bytes:
    """Overwrite `count` random positions with needles (away from edges)."""
    arr = np.frombuffer(data, dtype=np.uint8).copy()
    rng = np.random.default_rng(seed)
    for pos in rng.integers(0, len(arr) - 64, size=count):
        nd = needles[int(rng.integers(0, len(needles)))]
        arr[pos : pos + len(nd)] = np.frombuffer(nd, dtype=np.uint8)
    return arr.tobytes()


# --------------------------------------------------------------- the configs

def config_1(size: int):
    """literal substring grep on enwik8 (single file)."""
    data = _words_text(size, seed=1)
    return dict(name="enwik8_literal", pattern="volcano", data=[data],
                engine_kw={})


def config_2(size: int):
    """single PCRE alternation regex on enwik9, 8 input splits."""
    split = max(size // 8, 1 << 16)
    datas = [_words_text(split, seed=20 + i) for i in range(8)]
    return dict(name="enwik9_alternation_8splits",
                pattern="(volcano|anarchism|philosophy|needle|wikipedia"
                        "|quantum|zeppelin|obsidian)",
                data=datas, engine_kw={})


def config_3(size: int):
    """1k-literal multi-pattern set (Aho-Corasick) on Common Crawl WET."""
    pats = _rand_literals(1000, 6, 12, seed=3)
    data = _inject(_words_text(size, seed=30),
                   [p.encode() for p in pats[:50]], count=max(size // 65536, 4),
                   seed=31)
    return dict(name="wet_1k_aho_corasick", patterns=pats, data=[data],
                engine_kw={})


def config_4(size: int):
    """case-insensitive + bounded-repeat regex on NASA-HTTP access logs."""
    data = _log_text(size, seed=4)
    return dict(name="nasa_logs_ci_bounded_repeat",
                pattern=r"get /[a-z0-9/.-]{4,24}\.gif",
                data=[data], engine_kw={"ignore_case": True})


def config_5(size: int, n_patterns: int = 10_000):
    """10k-pattern Snort/Suricata ruleset scan on PCAP payloads."""
    alphabet = np.arange(1, 256)
    alphabet = alphabet[alphabet != 0x0A]
    pats = _rand_literals(n_patterns, 5, 9, seed=5, alphabet=alphabet)
    data = _inject(_binary_payload(size, seed=50),
                   [p.encode("latin-1") for p in pats[:100]],
                   count=max(size // 65536, 4), seed=51)
    return dict(name="pcap_10k_ruleset",
                patterns=[p.encode("latin-1") for p in pats],
                data=[data], engine_kw={})


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5}


def launches_per_segment(eng) -> int:
    """Kernel launches per segment of the engine's first pass."""
    if eng.fdr is not None:
        return len(eng.fdr.banks) + (eng.fdr_pairset is not None)
    return 1


# -------------------------------------------------------- slope-mode timing

def slope_gbps(eng, data: bytes) -> tuple[float, str] | None:
    """Device-resident kernel throughput via the slope method: the config's
    first-pass kernels over a resident copy of ``data``, no transfer, no
    fetch and no host work.  Returns (GB/s, engine_label), or None when the
    engine's mode has no slope setup."""
    from distributed_grep_tpu_torch.utils import slope

    if eng.mode == "shift_and":
        sa_model = eng._sa_filtered or eng.shift_and
        n_checked = sum(1 for r in sa_model.sym_ranges if r)
        label = ("shift_and" if sa_model is eng.shift_and
                 else f"shift_and_filt{n_checked}")
        dev, chunk, pad_rows, scan = slope.shift_and_setup(
            data, sa_model, device=eng.device)
    elif eng.mode == "nfa":
        label = "nfa_filt" if eng._nfa_filter else "nfa"
        dev, chunk, pad_rows, scan = slope.nfa_setup(data, eng.glushkov,
                                                     device=eng.device)
    elif eng.mode == "fdr":
        label = f"fdr_x{len(eng.fdr.banks)}"
        dev, chunk, pad_rows, scan = slope.fdr_setup(
            data, eng.fdr, device=eng.device, fold_case=eng.ignore_case)
    else:
        return None
    # Scale the chain so it covers >~1.5 GB whatever the split size.
    r2 = min(256, max(40, int(1.5e9 / max(len(data), 1))))
    r2 += r2 % 2
    r1 = max(8, r2 // 5 + (r2 // 5) % 2)
    r1, r2 = slope.reps(dev.device, r1, r2)
    per_pass, _ = slope.slope_per_pass(dev, chunk, pad_rows, scan, r1=r1,
                                       r2=r2, measurements=3)
    return slope.pass_bytes(dev, chunk) / 1e9 / per_pass, label


# ---------------------------------------------------------------- the suite

def _oracle_lines(spec, data: bytes) -> set[int]:
    pats = spec.get("patterns")
    if pats is not None:
        # system grep -nF -f: an independent oracle that stays fast at 10k
        # patterns (a Python re alternation is O(set) per position)
        import os
        import subprocess
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".pats", delete=False) as pf, \
             tempfile.NamedTemporaryFile(suffix=".dat", delete=False) as df:
            pf.write(b"\n".join(
                p if isinstance(p, bytes) else p.encode() for p in pats) + b"\n")
            df.write(data)
            pnames = (pf.name, df.name)
        try:
            args = ["grep", "-naF"]
            if spec["engine_kw"].get("ignore_case"):
                args.append("-i")
            # LC_ALL=C: byte semantics -- a UTF-8 locale makes grep skip
            # matches starting mid-multibyte-sequence in binary corpora
            out = subprocess.run(
                [*args, "-f", pnames[0], pnames[1]],
                capture_output=True,
                check=False,
                env={**os.environ, "LC_ALL": "C"},
            )
            if out.returncode > 1:  # 0 = matches, 1 = none, >1 = error
                raise RuntimeError(f"grep oracle failed: {out.stderr[:200]!r}")
        finally:
            for n in pnames:
                os.unlink(n)
        # split on '\n' only: bytes.splitlines also splits on '\r', which
        # binary corpora contain mid-line
        return {
            int(line.split(b":", 1)[0]) for line in out.stdout.split(b"\n") if line
        }
    from distributed_grep_tpu_torch.models.dfa import expand_posix_classes

    flags = re.IGNORECASE if spec["engine_kw"].get("ignore_case") else 0
    rx = re.compile(expand_posix_classes(spec["pattern"].encode()), flags)
    return {i for i, line in enumerate(data.split(b"\n"), 1) if rx.search(line)}


def run_config(
    num: int,
    size: int,
    device: str = "cuda",
    check: bool = False,
    timing: str = "e2e",
    **config_kwargs,
) -> dict:
    from distributed_grep_tpu_torch.ops.engine import GrepEngine

    spec = CONFIGS[num](size, **config_kwargs)
    t0 = time.perf_counter()
    eng = GrepEngine(
        spec.get("pattern"),
        patterns=spec.get("patterns"),
        device=device,
        **spec["engine_kw"],
    )
    compile_s = time.perf_counter() - t0
    datas = spec["data"]

    if timing == "slope":
        got = slope_gbps(eng, datas[0])
        if got is None:
            return {"config": num, "name": spec["name"],
                    "error": f"no slope setup for mode {eng.mode}"}
        gbps, label = got
        out = {
            "config": num,
            "name": spec["name"],
            "value": gbps,
            "unit": "GB/s",
            "timing": "slope(device-resident)",
            "engine": label,
            "mode": eng.mode,
            "banks": launches_per_segment(eng),
            "compile_s": round(compile_s, 2),
            "bytes": len(datas[0]),
        }
    else:
        eng.scan(datas[0])  # warm: builds and loads the kernels
        total_bytes = sum(len(d) for d in datas)
        matched = 0
        t0 = time.perf_counter()
        for d in datas:
            res = eng.scan(d)
            matched += int(res.matched_lines.size)
        dt = time.perf_counter() - t0

        out = {
            "config": num,
            "name": spec["name"],
            "value": total_bytes / 1e9 / dt,
            "unit": "GB/s",
            "timing": "e2e",
            "matched_lines": matched,
            "mode": eng.mode,
            "banks": launches_per_segment(eng),
            "compile_s": round(compile_s, 2),
            "bytes": total_bytes,
        }
    if check:
        # every split against the independent oracle
        mism = []
        for i, d in enumerate(datas):
            got = set(eng.scan(d).matched_lines.tolist())
            want = _oracle_lines(spec, d)
            if got != want:
                mism.append(f"split{i}:+{len(got - want)}-{len(want - got)}")
        out["check"] = "ok" if not mism else "MISMATCH " + ",".join(mism)
        out["check_bytes"] = sum(len(d) for d in datas)
        if mism:
            out["value"] = 0.0
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size-mb", type=float, default=64)
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timing", default="e2e", choices=["e2e", "slope"],
                    help="e2e: GrepEngine.scan wall time, transfers and host "
                         "work included; slope: the kernels alone on a "
                         "device-resident copy")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--patterns-5", type=int, default=10_000,
                    help="pattern count for config 5")
    args = ap.parse_args(argv)

    from distributed_grep_tpu_torch.utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    size = int(args.size_mb * 1e6)
    rc = 0
    for num in (int(x) for x in args.configs.split(",")):
        kw = {"n_patterns": args.patterns_5} if num == 5 else {}
        try:
            result = run_config(num, size, args.device, args.check,
                                args.timing, **kw)
        except Exception as e:  # noqa: BLE001 -- one line per config
            result = {"config": num, "error": f"{type(e).__name__}: {e}"}
            rc = 1
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
