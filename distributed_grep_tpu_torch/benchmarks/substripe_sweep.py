"""Sub-stripe sweep of the four stripe kernels and the table DFA, on the card.

    python -m distributed_grep_tpu_torch.benchmarks.substripe_sweep \\
        [--sizes-mb 64,8,4] [--n-sub 1,2,4,8] \\
        [--kernels shift_and,approx,pairset,shift_and_swar,dfa,dfa_stride]
        [--dfa-variants FILE]

csrc/shift_and.cu, csrc/approx.cu, csrc/pairset.cu and
csrc/shift_and_swar.cu cut each stripe into sub-stripes, one thread
(block row) each, and their launchers choose how many.  This script times
each kernel as its launcher chooses, beside copies of the same source
built with that count forced (the launcher's one line that sets it
replaced, ``variant_source``), on segments in the engine's layout (64 MiB:
65536 lanes x 1024 bytes; 8 MiB: 32768 x 256; 4 MiB: 16384 x 256): English
-word lines for Shift-And, approx and SWAR, random bytes with a newline
every ~120 for pairset (the PCAP-like corpus its query runs on) and words
for its transposed set.  Every output is held to the plain version bit
for bit before it is timed; the variants of one model are timed in turns
(forward, then backward), each as 20 calls captured in a CUDA graph, so
the times are the card's and not the host's (the launcher is also timed
eagerly, host included, as chip_smoke.py times the kernels).  One JSON
line per segment and model, then one with torch's int64 sum of the largest
segment, the card's practical floor for reading it once; each line names
the card and its power limit.  Without a card it prints nothing and exits
2.

``dfa`` and ``dfa_stride`` (csrc/dfa.cu, K1 and K2) take their sub-stripe
count and table branch as launch arguments, so no variant is built: on
one 64 MiB segment (65536 x 1024) each of six tables -- K1 on
'nee(dle|t)' and config 3's 1,000-member Aho-Corasick bank over English
words with the members planted, K1 on config 5's first bank over
PCAP-like bytes with its members planted, K2 on 'nee(dle|t)' at k = 2 and
4 and on config 3's bank at k = 2 -- runs as the launcher chooses, at
each forced count of ``--n-sub`` and on each other branch the table
fits, each held to the plain version bit for bit (K1's exit states too)
and then timed in turns as above; its line gives the launcher's plan,
each variant's fix-up steps and rounds, the eager call's time on 32
stripes of 32 bytes (the host's issue time, an eager call's floor), and
the card.  A first line gives
each kernel instance's registers, shared memory and spills (ptxas) and
the instructions of its word loop (cuobjdump, ``sass_word_loops``).
``--dfa-variants benchmarks/dfa_variants.json`` also builds copies of
csrc/dfa.cu with the file's text replacements (the shared-memory head's
budget on the global branch; probes that drop the data loads or the
chain of dependent reads) and times each beside the launcher, in the
same turns.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

# Per kernel: the launcher's line that sets the sub-stripe count, and the
# same line with the count forced to {n} (still capped at the words).
_SUB = "const int n_want = max(1, min(n_words, sms / lane_blocks));"
_FORCED = "const int n_want = max(1, min(n_words, {n}));"
LAUNCH_LINE = {
    "shift_and": (_SUB, _FORCED), "approx": (_SUB, _FORCED),
    "pairset": (_SUB, _FORCED),
    "shift_and_swar": ("const int n_want = max(1, min(n_words, 2 * sms / "
                       "lane_blocks));", _FORCED)}
ENTRY = {"shift_and": "dgrep_shift_and_scan", "approx": "dgrep_approx_scan",
         "pairset": "dgrep_pairset_scan", "shift_and_swar": "dgrep_swar_scan"}
PAIR_SET = [b"zq", b"9!", b"Q#", b"~~"]  # chip_smoke.py's 2-byte set
VOCAB = (b"the of and to in is was for on as with by he at from his that it "
         b"an were are which this be or had not first one their its new "
         b"after who they have her she two been other when there all during "
         b"into school time may years more most only over city some world "
         b"would where later up such used many can state about national out "
         b"known university united then made").split()


def words_text(n: int, seed: int = 0) -> bytes:
    """n bytes of words from VOCAB, about 12 a line, with 'volcano' and
    some misspellings of the approx models' patterns among them."""
    rng = np.random.default_rng(seed)
    vocab = list(VOCAB) + [b"volcano", b"Volcano", b"volcxno", b"Schwarzena"]
    p = np.full(len(vocab), 1.0)
    p[-4:] = 0.02
    tokens = [w + b" " for w in vocab] + [w + b"\n" for w in vocab]
    idx = rng.choice(len(vocab), size=n // 4, p=p / p.sum())
    idx += len(vocab) * (rng.random(idx.size) < 1 / 12)
    return b"".join(tokens[i] for i in idx.tolist())[:n]


def variant_source(kernel: str, n_sub: int, launch_line=None) -> str:
    """csrc/<kernel>.cu with the launcher's sub-stripe count forced to
    n_sub: ``launch_line`` (line, forced line), by default
    ``LAUNCH_LINE[kernel]``.  Raises if the line is not there exactly
    once."""
    from distributed_grep_tpu_torch.ops import _build

    text = (_build.CSRC / f"{kernel}.cu").read_text()
    line, forced = launch_line or LAUNCH_LINE[kernel]
    if text.count(line) != 1:
        raise ValueError(f"csrc/{kernel}.cu: the sub-stripe line "
                         f"{line!r} is not there exactly once")
    return text.replace(line, forced.format(n=n_sub))


def build_variants(kernel: str, counts, launch_line=None) -> dict:
    """One library per forced count, keyed "n_sub=N", nvcc processes
    started together, built under the package's git-ignored _build
    directory."""
    from distributed_grep_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in counts:
        name = f"n_sub={n}"
        src = variant_source(kernel, n, launch_line)
        h = _build.source_hash(src.encode())
        cu = _build.BUILD_DIR / f"{kernel}_nsub{n}-{h}.cu"
        so = cu.with_suffix(".so")
        if not so.exists():
            cu.write_text(src)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            jobs[name] = (n, so, tmp, subprocess.Popen(
                _build.nvcc_command(cu, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        else:
            jobs[name] = (n, so, None, None)
    libs = {}
    for name, (n, so, tmp, proc) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
            os.replace(tmp, so)
        libs[name] = (n, ctypes.CDLL(str(so)))
    return libs


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Eager: back-to-back calls between CUDA events, host time included
    where a call takes longer to issue than to run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time: `reps` calls captured in one CUDA graph, replayed
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def random_text(n: int, seed: int = 0) -> bytes:
    """n random bytes with a newline every ~120 and the 2-byte set's
    members planted, the PCAP-like corpus of chip_smoke.py's set query."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 256, size=n, dtype=np.uint8)
    text[rng.integers(0, n, size=n // 120)] = 0x0A
    at = rng.integers(0, n - 2, size=n // 3000)
    for i, p in enumerate(at.tolist()):
        text[p : p + 2] = np.frombuffer(PAIR_SET[i % len(PAIR_SET)], np.uint8)
    return text.tobytes()


def _call(lib, kernel: str, dev, model, mode):
    """The wrapper's call (ops/cuda_scan.py, approx_scan.py, pairset_scan.py,
    swar_scan.py) on a variant library: mode is `coarse` for Shift-And, k
    for approx, unused otherwise."""
    from distributed_grep_tpu_torch.ops import approx_scan, cuda_scan, swar_scan

    fn = getattr(lib, ENTRY[kernel])
    lanes, chunk = dev.shape
    stream = torch.cuda.current_stream(dev.device).cuda_stream
    out = torch.empty((chunk // 32, lanes // 4 if kernel == "shift_and_swar"
                       else lanes), dtype=torch.uint32, device=dev.device)
    p = ctypes.c_void_p
    i, ll, u = ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    if kernel == "pairset":
        fn.argtypes = [p, p, p, p, i, i, ll, i, i, i, p]
        rowcls = np.ascontiguousarray(model.rowcls, dtype=np.uint32)
        words = np.ascontiguousarray(model.words, dtype=np.uint32)
        args = (rowcls.ctypes.data, words.ctypes.data, chunk, lanes,
                dev.stride(0), int(model.transposed), int(model.ignore_case),
                0)
    elif kernel == "shift_and_swar":
        fn.argtypes = [p, p, p, i, i, ll, u, i, p]
        masks = np.ascontiguousarray(model.b_table & 0xFF, dtype=np.uint8)
        args = (masks.ctypes.data, chunk, lanes, dev.stride(0),
                int(model.match_bit), swar_scan.warmup_words(model))
    else:
        fn.argtypes = [p, p, p, i, i, ll, u, i, i, p]
        table = np.ascontiguousarray(
            model.b_table if kernel == "shift_and" else model.base.b_table,
            dtype=np.uint32)
        warm = (cuda_scan.warmup_words(model) if kernel == "shift_and"
                else approx_scan.warmup_words(model))
        args = (table.ctypes.data, chunk, lanes, dev.stride(0),
                int(model.match_bit), mode, warm)
    fn.restype = ctypes.c_int
    err = fn(dev.data_ptr(), out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} variant launch failed: cudaError {err}")
    return out


def _runs():
    """(kernel, label, model, mode, corpus) of each timed model."""
    from distributed_grep_tpu_torch.models import approx as ax_mod
    from distributed_grep_tpu_torch.models import pairset as ps_mod
    from distributed_grep_tpu_torch.models import shift_and as sa_mod

    full = sa_mod.try_compile_shift_and("volcano")
    filt = sa_mod.filtered_for_device(full)
    runs = [("shift_and", "volcano filter, coarse", filt, 1, "words"),
            ("shift_and", "volcano, exact", full, 0, "words")]
    runs += [("approx", f"{p} k={k}{' -i' if ic else ''}",
              ax_mod.try_compile_approx(p, k, ignore_case=ic), k, "words")
             for p, k, ic in (("volcano", 1, False), ("volcano", 2, True),
                              ("[Ss]chwarzen[ae]", 3, False))]
    runs += [("pairset", "2-byte set", ps_mod.compile_pairset(PAIR_SET), 0,
              "random"),
             ("pairset", "transposed -i", ps_mod.compile_pairset(
                 [bytes([100 + i, b"uvwxyz"[j]]) for i in range(40)
                  for j in range(6) if (i + 1) >> j & 1], ignore_case=True),
              0, "words")]
    runs += [("shift_and_swar", "volcano filter", filt, 0, "words"),
             ("shift_and_swar", "volcano", full, 0, "words")]
    return runs


DFA_KERNELS = ("dfa", "dfa_stride")


def sass_word_loops(lib_path) -> dict[str, dict]:
    """Each kernel function's word loop in ``cuobjdump -sass`` of a built
    library: the innermost loop (a backward branch with no other inside
    it) of the most instructions, its instruction count and its most used
    opcodes; {} where cuobjdump is missing."""
    import re
    from pathlib import Path

    from distributed_grep_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        return {}
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120).stdout
    funcs: dict[str, list] = {}
    func = None
    labels: dict[str, int] = {}
    for line in text.splitlines():
        t = line.strip()
        if t.startswith("Function : "):
            func = t[len("Function : "):]
            funcs[func] = []
            labels = {}
            funcs[func].append(labels)
        elif func is None:
            continue
        elif re.match(r"^\.L_x_\d+:$", t):
            labels[t[:-1]] = len(funcs[func]) - 1  # the next instruction's
        else:
            m = re.match(r"^/\*([0-9a-f]+)\*/\s+(.*?);", t)
            if m:
                words = m.group(2).split()
                if words and words[0].startswith("@"):
                    words = words[1:]
                target = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b",
                                   m.group(2))
                funcs[func].append((int(m.group(1), 16),
                                    words[0] if words else "?", target))
    out = {}
    for func, items in funcs.items():
        labels, ins = items[0], items[1:]
        addr = [a for a, _op, _t in ins]
        loops = []  # (first index, branch index)
        for i, (a, op, target) in enumerate(ins):
            if not op.startswith("BRA") or target is None:
                continue
            if target.group(1):
                j = labels.get(target.group(1))
            else:
                dest = int(target.group(2), 16)
                j = addr.index(dest) if dest in addr else None
            if j is not None and j <= i:
                loops.append((j, i))
        inner = [(j, i) for j, i in loops
                 if not any(j <= j2 and i2 <= i and (j2, i2) != (j, i)
                            for j2, i2 in loops)]
        if not inner:
            continue
        j, i = max(inner, key=lambda ji: ji[1] - ji[0])
        ops = [op for _a, op, _t in ins[j:i + 1]]
        top = sorted({o: ops.count(o) for o in ops}.items(),
                     key=lambda kv: -kv[1])[:6]
        out[func] = {"loop_instructions": len(ops),
                     "per_byte": len(ops) / 32, "top": top}
    return out


def dfa_tables(n: int):
    """(kernel, label, table, corpus) of the six timed tables and the two
    corpora of n bytes: English words with config 3's members planted, and
    PCAP-like bytes with config 5's (benchmarks/baseline_configs.py's
    sets and payload)."""
    from distributed_grep_tpu_torch.benchmarks import baseline_configs as bc
    from distributed_grep_tpu_torch.models import aho as aho_mod
    from distributed_grep_tpu_torch.models import dfa as dfa_mod

    alphabet = np.arange(1, 256)
    alphabet = alphabet[alphabet != 0x0A]
    set3 = [p.encode() for p in bc._rand_literals(1000, 6, 12, seed=3)]
    set5 = [p.encode("latin-1")
            for p in bc._rand_literals(10_000, 5, 9, seed=5,
                                       alphabet=alphabet)]
    texts = {
        "words": bc._inject(words_text(n), set3[:200] + [b"needle", b"net"],
                            n // 2000, 31),
        "pcap": bc._inject(bc._binary_payload(n, 50), set5[:100],
                           n // 65536, 51),
    }
    nee = dfa_mod.compile_dfa("nee(dle|t)")
    bank3 = aho_mod.compile_aho_corasick(set3)
    bank5 = aho_mod.compile_aho_corasick_banks(set5)[0]
    runs = [("dfa", "nee(dle|t)", nee, "words"),
            ("dfa", "config 3 bank", bank3, "words"),
            ("dfa", "config 5 bank 0", bank5, "pcap"),
            ("dfa_stride", "nee(dle|t) k=2",
             dfa_mod.build_stride_table(nee, 2), "words"),
            ("dfa_stride", "nee(dle|t) k=4",
             dfa_mod.build_stride_table(nee, 4), "words"),
            ("dfa_stride", "config 3 bank k=2",
             dfa_mod.build_stride_table(bank3, 2), "words")]
    return runs, texts


def build_dfa_variants(variants: dict) -> dict:
    """One library per variant of csrc/dfa.cu (``variants`` maps a name to
    [old, new] text replacements, each old text present), nvcc processes
    started together, built under the package's git-ignored _build
    directory: name -> (K1 entry, K2 entry), argtypes set."""
    from distributed_grep_tpu_torch.ops import _build, dfa_scan

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "dfa.cu").read_text()
    jobs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"dfa variant {name}: {old!r} not in "
                                 f"csrc/dfa.cu")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"dfa_{name}-{_build.source_hash(text.encode())}.cu"
        so = cu.with_suffix(".so")
        proc = None
        if not so.exists():
            cu.write_text(text)
            proc = subprocess.Popen(_build.nvcc_command(cu, so),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        jobs[name] = (so, proc)
    libs = {}
    for name, (so, proc) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for dfa {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        k1, k2 = lib.dgrep_dfa_scan, lib.dgrep_dfa_stride_scan
        k1.argtypes, k2.argtypes = dfa_scan.K1_ARGTYPES, dfa_scan.K2_ARGTYPES
        k1.restype = k2.restype = ctypes.c_int
        libs[name] = (k1, k2)
    return libs


def dfa_sweep(kernels, counts, card: str, variants: dict | None = None
              ) -> None:
    """K1 and K2 on the six tables (``dfa_tables``) at each forced count
    and branch beside the launcher's plan, and each variant of the source
    (``build_dfa_variants``) at its launcher's plan, all in turns; one
    JSON line a table.  A variant named probe_* may change the words (a
    probe of where the time goes, such as a walk without its data loads)
    and is not held to the plain version."""
    from distributed_grep_tpu_torch.ops import _build, dfa_scan
    from distributed_grep_tpu_torch.ops.layout import Layout, padded_stripes

    variant_libs = build_dfa_variants(variants or {})

    _build.load(dfa_scan.LIBRARY)
    usage = [line.strip() for line in
             _build.saved_log(dfa_scan.LIBRARY).splitlines()
             if "registers" in line or "Compiling entry" in line
             or "spill" in line]
    print(json.dumps({"kernel": "dfa", "ptxas": usage,
                      "sass_word_loops": sass_word_loops(
                          _build._target(dfa_scan.LIBRARY)),
                      "card": card}), flush=True)
    lanes, chunk = 65536, 1024
    runs, texts = dfa_tables(lanes * chunk)
    lay = Layout(lanes=lanes, chunk=chunk, n_real=lanes * chunk)
    devs = {k: torch.from_numpy(padded_stripes(t, lay)).cuda()
            for k, t in texts.items()}
    for kernel, label, table, corpus in runs:
        if kernel not in kernels:
            continue
        dev = devs[corpus]
        k1 = kernel == "dfa"
        plan_fn = dfa_scan.launch_plan if k1 else dfa_scan.stride_launch_plan
        plan = plan_fn(table, lanes, chunk)

        def call(n_sub=0, branch=None, fixups=None, t=table, d=dev, k1=k1):
            if k1:
                return dfa_scan.dfa_scan_words(d, t, True, n_sub=n_sub,
                                               branch=branch, fixups=fixups)
            return dfa_scan.dfa_stride_words(d, t, n_sub=n_sub,
                                             branch=branch, fixups=fixups)

        variants_sb = {"launcher": (0, None)}
        for s in counts:
            variants_sb[f"n_sub={s}"] = (s, None)
        for b in dfa_scan.BRANCHES:
            if b != plan[1]:
                variants_sb[f"branch={b}"] = (0, b)
        want = (dfa_scan.dfa_scan_words_plain(dev, table, True) if k1
                else dfa_scan.dfa_stride_words_plain(dev, table))
        fns, fixups = {}, {}
        for name, (k1_fn, k2_fn) in variant_libs.items():
            def run(k1_fn=k1_fn, k2_fn=k2_fn, t=table, d=dev, k1=k1,
                    plan=plan):
                stream = torch.cuda.current_stream().cuda_stream
                if k1:
                    return dfa_scan.launch_k1(k1_fn, d, t, True, 0, None,
                                              None, plan, stream)
                return dfa_scan.launch_k2(k2_fn, d, t, 0, None, None, plan,
                                          stream)
            got = run()
            torch.cuda.synchronize()
            same = (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])
                    if k1 else torch.equal(got, want))
            if not same and not name.startswith("probe_"):
                raise AssertionError(f"{kernel} {label}: variant {name} != "
                                     f"plain")
            fns[f"variant {name}"] = run
        for name, (s, b) in variants_sb.items():
            try:
                plan_fn(table, lanes, chunk, n_sub=s, branch=b)
            except ValueError:
                continue  # the kernel refuses it: not run
            fx = torch.zeros(2, dtype=torch.int64, device=dev.device)
            got = call(s, b, fx)
            torch.cuda.synchronize()
            same = (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])
                    if k1 else torch.equal(got, want))
            if not same:
                raise AssertionError(f"{kernel} {label}: {name} != plain")
            fixups[name] = fx.tolist()
            fns[name] = (lambda s=s, b=b: call(s, b))
        turns: dict[str, list[float]] = {k: [] for k in fns}
        for name in list(fns) + list(fns)[::-1]:
            turns[name].append(graph_ms(fns[name]))
        # an eager call's floor: the same call on 32 stripes of 32 bytes,
        # where the card's work is nothing and the host's issue is all
        tiny = dev[:32, :32]
        print(json.dumps({
            "kernel": kernel, "table": label, "corpus": corpus,
            "states": table.n_states, "lanes": lanes, "chunk": chunk,
            "plan": list(plan),
            "ms": {k: sum(v) / len(v) for k, v in turns.items()},
            "turns": turns, "fixups": fixups,
            "launcher_eager_ms": cuda_ms(fns["launcher"]),
            "tiny_eager_ms": cuda_ms(lambda: call(d=tiny), 200),
            "card": card}), flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes-mb", default="64,8,4")
    ap.add_argument("--n-sub", default="1,2,4,8")
    ap.add_argument("--kernels",
                    default="shift_and,approx,pairset,shift_and_swar",
                    help="any of " + ",".join([*LAUNCH_LINE, *DFA_KERNELS]))
    ap.add_argument("--dfa-variants", default=None,
                    help="a JSON file of csrc/dfa.cu variants to time beside "
                         "the launcher: {name: [[old, new], ...]} "
                         "(benchmarks/dfa_variants.json)")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    unknown = set(kernels) - {*LAUNCH_LINE, *DFA_KERNELS}
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False: the sweep needs "
              "an NVIDIA card", file=sys.stderr)
        return 2

    from distributed_grep_tpu_torch.ops import (
        approx_scan,
        cuda_scan,
        pairset_scan,
        swar_scan,
    )
    from distributed_grep_tpu_torch.ops.engine import DEFAULT_TARGET_LANES
    from distributed_grep_tpu_torch.ops.layout import (
        choose_layout,
        padded_stripes,
    )

    wrappers = {
        "shift_and": (lambda d, m, mode: cuda_scan.shift_and_scan_words(
            d, m, bool(mode)), lambda d, m, mode:
            cuda_scan.shift_and_scan_words_plain(d, m, bool(mode))),
        "approx": (lambda d, m, mode: approx_scan.approx_scan_words(d, m),
                   lambda d, m, mode:
                   approx_scan.approx_scan_words_plain(d, m)),
        "pairset": (lambda d, m, mode: pairset_scan.pairset_scan_words(d, m),
                    lambda d, m, mode:
                    pairset_scan.pairset_scan_words_plain(d, m)),
        "shift_and_swar": (lambda d, m, mode: swar_scan.swar_scan_words(d, m),
                           lambda d, m, mode:
                           swar_scan.swar_scan_words_plain(d, m)),
    }
    card = card_line()
    counts = [int(x) for x in args.n_sub.split(",")]
    stripe_kernels = [k for k in LAUNCH_LINE if k in kernels]
    libs = {k: build_variants(k, counts) for k in stripe_kernels}
    runs = [r for r in _runs() if r[0] in stripe_kernels]
    largest = None
    for size_mb in (float(x) for x in args.sizes_mb.split(",")):
        if not runs:
            break
        n = int(size_mb * (1 << 20))
        texts = {"words": words_text(n), "random": random_text(n)}
        lay = choose_layout(n, target_lanes=DEFAULT_TARGET_LANES,
                            min_chunk=256, lane_multiple=32,
                            chunk_multiple=32)
        devs = {k: torch.from_numpy(padded_stripes(t, lay)).cuda()
                for k, t in texts.items()}
        if largest is None or devs["words"].numel() > largest.numel():
            largest = devs["words"]
        n_words = lay.chunk // 32
        for kernel, label, model, mode, corpus in runs:
            dev = devs[corpus]
            kernel_fn, plain_fn = wrappers[kernel]

            def kept(m=model, f=kernel_fn, mo=mode, d=dev):
                return f(d, m, mo)

            plain = plain_fn(dev, model, mode)
            fns = {"launcher": kept}
            for name, (n, lib) in libs[kernel].items():
                if n <= n_words:
                    fns[name] = (lambda lib=lib, k=kernel, d=dev, m=model,
                                 mo=mode: _call(lib, k, d, m, mo))
            for name, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, plain):
                    raise AssertionError(f"{kernel} {label}: {name} != plain")
            turns: dict[str, list[float]] = {k: [] for k in fns}
            for name in list(fns) + list(fns)[::-1]:
                turns[name].append(graph_ms(fns[name]))
            print(json.dumps({
                "kernel": kernel, "model": label, "corpus": corpus,
                "lanes": lay.lanes, "chunk": lay.chunk,
                "ms": {k: sum(v) / len(v) for k, v in turns.items()},
                "turns": turns, "launcher_eager_ms": cuda_ms(kept),
                "card": card}), flush=True)
    if set(kernels) & set(DFA_KERNELS):
        variants = None
        if args.dfa_variants:
            with open(args.dfa_variants) as f:
                variants = json.load(f)
        dfa_sweep(kernels, counts, card, variants)
        if largest is None:
            largest = torch.from_numpy(np.frombuffer(
                words_text(64 << 20), np.uint8).copy()).cuda()
    flat = largest.view(torch.int64)
    print(json.dumps({"read_floor": "torch int64 sum of the segment",
                      "bytes": largest.numel(),
                      "ms": cuda_ms(lambda: flat.sum()), "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
