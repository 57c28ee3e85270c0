"""Probe: what does the width of a Shift-And step's state (32, 16 or 8 bits)
do to the compiled step on the card, and to its speed?

The port's counterpart of ``benchmarks/probe_narrow.py``, on the narrow
probe kernel (csrc/probe_narrow.cu, ``ops/narrow_probe.py``):

    python -m distributed_grep_tpu_torch.benchmarks.probe_narrow compile16
    python -m distributed_grep_tpu_torch.benchmarks.probe_narrow compile8
    python -m distributed_grep_tpu_torch.benchmarks.probe_narrow slope
    (each with --device cpu for the plain version)

``compile16`` / ``compile8`` run the i16 / i8 kernel once on a 1 MiB
'volcano' corpus and report its nonzero words; ``slope`` reports the
kernel's GB/s at i32 and at i16 on a 64 MiB corpus (the slope harness,
``utils/slope.py``).  Each probe prints one JSON line.  Without a card and
without --device cpu the script exits 2 and prints nothing on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _corpus(n: int) -> bytes:
    """Printable random bytes, a newline every ~80 bytes, and 1000
    'volcano's (the reference probe's corpus)."""
    rng = np.random.default_rng(0)
    data = rng.integers(32, 127, size=n, dtype=np.uint8)
    data[rng.integers(0, n, size=n // 80)] = 0x0A
    needle = np.frombuffer(b"volcano", np.uint8)
    for p in rng.integers(0, n - 16, size=1000):
        data[p : p + len(needle)] = needle
    return data.tobytes()


def _setup(data: bytes, device):
    from distributed_grep_tpu_torch.utils.slope import device_setup

    return device_setup(data, device, lane_multiple=4096, chunk_multiple=512,
                        min_chunk=512)


def probe_compile(width: str, device) -> dict:
    import torch

    from distributed_grep_tpu_torch.ops.narrow_probe import narrow_probe_words

    dev, lay, _ = _setup(_corpus(1 << 20), device)
    out = narrow_probe_words(dev[: lay.chunk], width)
    n = int(torch.count_nonzero(out.view(torch.int32)))
    return {"probe": f"compile_{width}", "ok": True, "nonzero_words": n}


def probe_slope(device) -> list[dict]:
    from distributed_grep_tpu_torch.ops.narrow_probe import narrow_probe_words
    from distributed_grep_tpu_torch.utils import slope

    dev, lay, pad_rows = _setup(_corpus(64 << 20), device)
    r1, r2 = slope.reps(dev.device, 2, 10)
    lines = []
    for width in ("i32", "i16"):
        def scan(win, width=width):
            return narrow_probe_words(win, width)

        per_pass, cnt = slope.slope_per_pass(dev, lay.chunk, pad_rows, scan,
                                             r1=r1, r2=r2, measurements=3)
        gbs = slope.pass_bytes(dev, lay.chunk) / per_pass / 1e9
        lines.append({"probe": f"slope_{width}", "gbs": gbs,
                      "per_pass_ms": per_pass * 1e3, "count": int(cnt)})
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", nargs="?", default="compile16",
                    choices=["compile16", "compile8", "slope"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from distributed_grep_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.probe == "slope":
        lines = probe_slope(device)
    else:
        lines = [probe_compile("i16" if args.probe == "compile16" else "i8",
                               device)]
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
