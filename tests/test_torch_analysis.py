"""The port's invariant checker (distributed_grep_tpu_torch/analysis/)
against its fixtures and against the reference's checker.

Three groups:

* the counterparts of the reference's tests/test_analysis.py (all but
  the six of ``mosaic-ceilings`` and ``shard-map-rep``, which have no
  source to check in the port): each rule fires on a known-bad fixture
  and stays silent on a good one, the package analyzes clean with an
  empty baseline, and the checker's CLI keeps its contract;
* differential checks: on the same fixture trees the port's eight
  reference rules that this package did not translate give the same
  (rule, path, line) list as the reference's, and the same violations
  render to the same SARIF; the knob registries agree;
* the port's own rules (``own-copy``, ``no-fallback``, ``cuda-abi``)
  and the helper cases of ``env-knobs`` and ``event-registry``.

Standalone-runnable:  python -m pytest tests/test_torch_analysis.py -q
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_grep_tpu.analysis import run_analysis as ref_run_analysis
from distributed_grep_tpu.analysis.checker import to_sarif as ref_to_sarif
from distributed_grep_tpu.analysis.knobs import KNOBS as REF_KNOBS
from distributed_grep_tpu_torch.analysis import RULES, Project, run_analysis
from distributed_grep_tpu_torch.analysis.checker import PACKAGE_ROOT
from distributed_grep_tpu_torch.analysis.checker import main as analyze_main
from distributed_grep_tpu_torch.analysis.checker import to_sarif
from distributed_grep_tpu_torch.analysis.knobs import (
    KNOBS,
    NOT_PORTED,
    knob_docs,
)
from distributed_grep_tpu_torch.analysis.rules import extern_c_functions

pytestmark = pytest.mark.lint

REPO = Path(__file__).resolve().parents[1]


def _mk(root: Path, rel: str, src: str) -> None:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src, encoding="utf-8")


def _tree(root: Path, files: dict[str, str]) -> Path:
    for rel, src in files.items():
        _mk(root, rel, src)
    return root


def _hits(root: Path, rule: str) -> list:
    return list(run_analysis(root=root, rules=[rule]))


# ------------------------------------------------------ the fixture trees
# Shared by the counterpart tests and the differential test: each entry is
# (rule, {path: source}).

FIXTURES: dict[str, tuple[str, dict[str, str]]] = {
    "posix_raw_user_pattern": ("posix-expand", {
        "apps/x.py":
            "import re\n"
            "def f(user_pattern):\n"
            "    return re.compile(user_pattern)\n"}),
    "posix_alias_and_search": ("posix-expand", {
        "ops/x.py":
            "import re as _re\n"
            "def f(p, data):\n"
            "    return _re.search(p, data)\n"}),
    "posix_hoisted_literal": ("posix-expand", {
        "apps/w.py":
            "import re\n"
            "_WORD = rb'[A-Za-z0-9]+'\n"
            "def f(text):\n"
            "    return re.findall(_WORD, text)\n"}),
    "posix_sanitized_and_literal": ("posix-expand", {
        "apps/ok.py":
            "import re\n"
            "from distributed_grep_tpu_torch.models.dfa import "
            "expand_posix_classes\n"
            "WORD = re.compile(rb'[A-Za-z]+')\n"
            "def f(p):\n"
            "    return re.compile(expand_posix_classes(p))\n"
            "def g(p, mode):\n"
            "    base = wrap(expand_posix_classes(p), mode)\n"
            "    return re.compile(base)\n"
            "def h(lits):\n"
            "    return re.compile(b'|'.join(re.escape(x) for x in lits))\n"}),
    "store_raw_glob_and_open": ("store-resolve", {
        "runtime/x.py":
            "import glob\n"
            "def f(d):\n"
            "    a = glob.glob(d + '/mr-out-*')\n"
            "    b = open(f'{d}/mr-0-1')\n"
            "    return a, b\n"}),
    "store_exempt": ("store-resolve", {
        "runtime/store.py":
            "from pathlib import Path\n"
            "def resolve(d):\n"
            "    return sorted(Path(d).glob('mr-out-*'))\n",
        "runtime/ok.py":
            "def f(p):\n"
            "    return open(p)\n"}),
    "surrogate_bare": ("surrogateescape", {
        "runtime/x.py":
            "def f(p):\n"
            "    return p.encode('utf-8'), p.encode(), "
            "b'x'.decode('utf-8')\n"}),
    "surrogate_exempt": ("surrogateescape", {
        "apps/ok.py":
            "import json\n"
            "def f(p, obj):\n"
            "    a = p.encode('utf-8', 'surrogateescape')\n"
            "    b = p.encode('utf-8', errors='surrogateescape')\n"
            "    c = b'x'.decode('utf-8', errors='replace')\n"
            "    d = json.dumps(obj).encode('utf-8')\n"
            "    e = b'ff'.decode('ascii')\n"
            "    return a, b, c, d, e\n",
        "models/out_of_scope.py":
            "def f(p):\n"
            "    return p.encode('utf-8')\n"}),
    "rpc_missing_drift_dead": ("rpc-elide", {
        "runtime/rpc.py":
            "from dataclasses import dataclass, field\n"
            "from typing import Any\n"
            "@dataclass\n"
            "class A:\n"
            "    x: int = 1\n"
            "    m: dict | None = None\n"
            "    spans: list = field(default_factory=list)\n"
            "_ELIDE_DEFAULTS: dict[str, Any] = "
            "{'spans': [], 'gone': None, 'x': 5}\n"}),
    "rpc_consistent": ("rpc-elide", {
        "runtime/rpc.py":
            "from dataclasses import dataclass, field\n"
            "from typing import Any\n"
            "@dataclass\n"
            "class A:\n"
            "    x: int = 1\n"
            "    m: dict | None = None\n"
            "    spans: list = field(default_factory=list)\n"
            "_ELIDE_DEFAULTS: dict[str, Any] = {'spans': [], 'm': None}\n"}),
    "rpc_reply_unregistered_truthy": ("rpc-elide", {
        "runtime/rpc.py":
            "from dataclasses import dataclass\n"
            "from typing import Any\n"
            "_ELIDE_DEFAULTS: dict[str, Any] = {}\n"
            "_REPLY_BASE = ('ok',)\n"
            "_REPLY_ELIDE = ('retries', 'gone')\n"
            "@dataclass\n"
            "class PollReply:\n"
            "    ok: bool = False\n"
            "    retries: int = 3\n"
            "    orphan: str = ''\n"}),
    "rpc_reply_missing_registries": ("rpc-elide", {
        "runtime/rpc.py":
            "from dataclasses import dataclass\n"
            "from typing import Any\n"
            "_ELIDE_DEFAULTS: dict[str, Any] = {}\n"
            "@dataclass\n"
            "class PollReply:\n"
            "    ok: bool = False\n"}),
    "rpc_reply_both_sides": ("rpc-elide", {
        "runtime/rpc.py":
            "from dataclasses import dataclass\n"
            "from typing import Any\n"
            "_ELIDE_DEFAULTS: dict[str, Any] = {}\n"
            "_REPLY_BASE = ('ok',)\n"
            "_REPLY_ELIDE = ('ok',)\n"
            "@dataclass\n"
            "class PollReply:\n"
            "    ok: bool = False\n"}),
    "rpc_reply_partitioned": ("rpc-elide", {
        "runtime/rpc.py":
            "from dataclasses import dataclass\n"
            "from typing import Any\n"
            "_ELIDE_DEFAULTS: dict[str, Any] = {}\n"
            "_REPLY_BASE = ('ok',)\n"
            "_REPLY_ELIDE = ('extra',)\n"
            "@dataclass\n"
            "class PollReply:\n"
            "    ok: bool = False\n"
            "    extra: str = ''\n"}),
    "logging_print_and_root": ("logging", {
        "parallel/x.py":
            "import logging\n"
            "log = logging.getLogger('x')\n"
            "def f():\n"
            "    print('hi')\n"}),
    "logging_exempt": ("logging", {
        "utils/y.py":
            "from distributed_grep_tpu_torch.utils.logging import "
            "get_logger\n"
            "log = get_logger('y')\n",
        "apps/z.py": "print('cli output is fine here')\n"}),
    "net_raw_urlopen_socket": ("net-retry", {
        "runtime/x.py":
            "import socket\n"
            "import urllib.request\n"
            "def f(url, host):\n"
            "    with urllib.request.urlopen(url, timeout=5) as r:\n"
            "        body = r.read()\n"
            "    c = socket.create_connection((host, 80))\n"
            "    return body, c\n",
        "__main__.py":
            "import urllib.request\n"
            "def poll(url):\n"
            "    return urllib.request.urlopen(url).read()\n"}),
    "net_exempt": ("net-retry", {
        "runtime/http_transport.py":
            "import urllib.request\n"
            "def _request(url):\n"
            "    return urllib.request.urlopen(url).read()\n",
        "apps/y.py":
            "import urllib.request\n"
            "def fetch(url):\n"
            "    return urllib.request.urlopen(url).read()\n",
        "runtime/server.py":
            "from http.server import ThreadingHTTPServer\n"
            "def serve(handler):\n"
            "    return ThreadingHTTPServer(('127.0.0.1', 0), handler)\n"}),
    "net_addr_split": ("net-retry", {
        "runtime/x.py":
            "def pick(addr):\n"
            "    return addr.split(',')[0]\n",
        "__main__.py":
            "def first(args):\n"
            "    return args.addr.split(',')[0]\n"}),
    "net_other_splits": ("net-retry", {
        "runtime/http_transport.py":
            "def split_addrs(addr):\n"
            "    return [a for a in addr.split(',') if a]\n",
        "runtime/y.py":
            "def parse_range(rng):\n"
            "    return rng.split(',')[0]\n"
            "def split_other(addr):\n"
            "    return addr.split(';')\n"}),
    "blocking_with_and_locked": ("locked-blocking", {
        "runtime/x.py":
            "import os\n"
            "import threading\n"
            "class S:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def f(self, p):\n"
            "        with self._lock:\n"
            "            open(p)\n"
            "    def _push_locked(self, f):\n"
            "        os.fsync(f.fileno())\n"
            "    def g(self):\n"
            "        with self._lock:\n"
            "            self.journal.map_completed(1, 'f', [])\n"}),
    "blocking_sleep_engine_socket": ("locked-blocking", {
        "ops/x.py":
            "import time\n"
            "import threading\n"
            "from urllib.request import urlopen\n"
            "_l = threading.Lock()\n"
            "def f(url, pat):\n"
            "    with _l:\n"
            "        time.sleep(1)\n"
            "        urlopen(url)\n"
            "        eng = GrepEngine(pat)\n"
            "    return eng\n"}),
    "blocking_nested_compound": ("locked-blocking", {
        "runtime/x.py":
            "import threading\n"
            "_l = threading.Lock()\n"
            "def f(p, cond):\n"
            "    with _l:\n"
            "        if cond:\n"
            "            try:\n"
            "                open(p)\n"
            "            except OSError:\n"
            "                pass\n"
            "def g(p):\n"
            "    with _l, open(p) as fh:\n"
            "        return fh\n"}),
    "blocking_nested_def": ("locked-blocking", {
        "runtime/x.py":
            "import threading\n"
            "_l = threading.Lock()\n"
            "def f(p):\n"
            "    with _l:\n"
            "        def cb():\n"
            "            return open(p)\n"
            "        return cb\n"}),
    "blocking_io_ok_and_staged": ("locked-blocking", {
        "runtime/ok.py":
            "import os\n"
            "import threading\n"
            "from distributed_grep_tpu_torch.utils.lockdep import make_lock\n"
            "class S:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._flush_lock = make_lock('flush', io_ok=True)\n"
            "        self._pending = []\n"
            "    def commit(self, entry, f):\n"
            "        with self._lock:\n"
            "            self._pending.append(entry)\n"
            "        self._flush(f)\n"
            "    def _flush(self, f):\n"
            "        with self._flush_lock:\n"
            "            with self._lock:\n"
            "                pending, self._pending = self._pending, []\n"
            "            os.fsync(f.fileno())\n"
            "    def teardown(self, p):\n"
            "        open(p)\n"
            "    def h(self, s):\n"
            "        with self._lock:\n"
            "            return s.replace('a', 'b')\n"}),
    "blocking_out_of_scope": ("locked-blocking", {
        "utils/spans_like.py":
            "import threading\n"
            "class L:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def write(self, f):\n"
            "        with self._lock:\n"
            "            open(f)\n"}),
    "order_cross_function": ("lock-order", {
        "runtime/y.py":
            "import threading\n"
            "a = threading.Lock()\n"
            "b = threading.Lock()\n"
            "def f():\n"
            "    with a:\n"
            "        g()\n"
            "def g():\n"
            "    with b:\n"
            "        pass\n"
            "def h():\n"
            "    with b:\n"
            "        with a:\n"
            "            pass\n"}),
    "order_three_lock": ("lock-order", {
        "runtime/tri.py":
            "import threading\n"
            "a = threading.Lock()\n"
            "b = threading.Lock()\n"
            "c = threading.Lock()\n"
            "def f():\n"
            "    with a:\n"
            "        with b:\n"
            "            pass\n"
            "def g():\n"
            "    with b:\n"
            "        with c:\n"
            "            pass\n"
            "def h():\n"
            "    with c:\n"
            "        with a:\n"
            "            pass\n"}),
    "order_self_reacquire": ("lock-order", {
        "ops/z.py":
            "import threading\n"
            "l = threading.Lock()\n"
            "def f():\n"
            "    with l:\n"
            "        with l:\n"
            "            pass\n"}),
    "order_cross_module_acyclic": ("lock-order", {
        "runtime/sched.py":
            "import threading\n"
            "class Sched:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def stop(self):\n"
            "        with self._lock:\n"
            "            helper()\n"
            "def helper():\n"
            "    pass\n",
        "runtime/svc.py":
            "import threading\n"
            "from runtime.sched import Sched\n"
            "class Rec:\n"
            "    scheduler: Sched | None = None\n"
            "class Svc:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def close(self, rec):\n"
            "        with self._lock:\n"
            "            rec.scheduler.stop()\n"}),
    "order_cross_module_cycle": ("lock-order", {
        "runtime/sched.py":
            "import threading\n"
            "from runtime.svc import Svc\n"
            "class Sched:\n"
            "    svc: Svc | None = None\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def stop(self):\n"
            "        with self._lock:\n"
            "            self.svc.close(None)\n",
        "runtime/svc.py":
            "import threading\n"
            "from runtime.sched import Sched\n"
            "class Rec:\n"
            "    scheduler: Sched | None = None\n"
            "class Svc:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def close(self, rec):\n"
            "        with self._lock:\n"
            "            rec.scheduler.stop()\n"}),
    "order_conditional_acquire": ("lock-order", {
        "runtime/adm.py":
            "import threading\n"
            "class S:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def check(self, locked=False):\n"
            "        if not locked:\n"
            "            with self._lock:\n"
            "                return self.check(locked=True)\n"
            "        return True\n"
            "    def submit(self):\n"
            "        with self._lock:\n"
            "            self.check(locked=True)\n"}),
    "order_make_lock_condition": ("lock-order", {
        "runtime/named.py":
            "import threading\n"
            "from distributed_grep_tpu_torch.utils.lockdep import make_lock\n"
            "class S:\n"
            "    def __init__(self):\n"
            "        self._lock = make_lock('svc')\n"
            "        self._cond = threading.Condition(self._lock)\n"
            "    def wake(self):\n"
            "        with self._cond:\n"
            "            pass\n"
            "    def wait_then(self):\n"
            "        with self._lock:\n"
            "            self.wake()\n"}),
}

# the rules the port keeps as the reference wrote them: on the same tree
# both checkers must report the same (rule, path, line) list
DIFFERENTIAL_RULES = ("posix-expand", "store-resolve", "surrogateescape",
                      "rpc-elide", "logging", "net-retry", "locked-blocking",
                      "lock-order")


def _fixture(tmp_path: Path, name: str) -> Path:
    return _tree(tmp_path, FIXTURES[name][1])


# ------------------------------------------------------------ the tier-1 gate

@pytest.fixture(scope="module")
def port_violations() -> list:
    """Every rule over the port with no baseline, run once for the file."""
    return run_analysis()


def test_repo_is_clean_with_empty_baseline(port_violations):
    """The acceptance invariant: the port analyzes clean with NO baseline;
    any new violation fails here with its file:line diagnostics."""
    assert not port_violations, "\n" + "\n".join(
        v.render() for v in port_violations)


def test_cli_analyze_subcommand_green(capsys):
    from distributed_grep_tpu_torch.__main__ import main

    assert main(["analyze", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["count"] == 0 and doc["violations"] == []


# ------------------------------------------------------------------ R1 posix

def test_posix_expand_fires_on_raw_user_pattern(tmp_path):
    (v,) = _hits(_fixture(tmp_path, "posix_raw_user_pattern"),
                 "posix-expand")
    assert v.path == "apps/x.py" and v.line == 3
    assert "expand_posix_classes" in v.message


def test_posix_expand_fires_through_alias_and_search(tmp_path):
    (v,) = _hits(_fixture(tmp_path, "posix_alias_and_search"),
                 "posix-expand")
    assert v.line == 3


def test_posix_expand_exempts_hoisted_literal_constant(tmp_path):
    assert not _hits(_fixture(tmp_path, "posix_hoisted_literal"),
                     "posix-expand")


def test_posix_expand_silent_on_sanitized_and_literal(tmp_path):
    assert not _hits(_fixture(tmp_path, "posix_sanitized_and_literal"),
                     "posix-expand")


# ------------------------------------------------------------------ R2 store

def test_store_resolve_fires_on_raw_glob_and_open(tmp_path):
    got = _hits(_fixture(tmp_path, "store_raw_glob_and_open"),
                "store-resolve")
    assert [v.line for v in got] == [3, 4]
    assert all("unit of truth" in v.message for v in got)


def test_store_resolve_exempts_store_py_and_plain_paths(tmp_path):
    assert not _hits(_fixture(tmp_path, "store_exempt"), "store-resolve")


# ---------------------------------------------------------------- R3 unicode

def test_surrogateescape_fires_on_bare_utf8_conversions(tmp_path):
    got = _hits(_fixture(tmp_path, "surrogate_bare"), "surrogateescape")
    assert len(got) == 3 and all(v.line == 2 for v in got)


def test_surrogateescape_exemptions(tmp_path):
    assert not _hits(_fixture(tmp_path, "surrogate_exempt"),
                     "surrogateescape")


# ------------------------------------------------------------------ R4 knobs

def test_env_knobs_fires_on_unregistered_and_wrong_owner(tmp_path):
    _mk(tmp_path, "ops/x.py",
        "import os\n"
        "A = os.environ.get('DGREP_BOGUS', '1')\n"
        "B = os.environ.get('DGREP_LOG')\n"
        "C = os.environ.get('DGREP_NO_CALIBRATE')\n")
    msgs = "\n".join(v.message for v in _hits(tmp_path, "env-knobs"))
    assert "unregistered env knob DGREP_BOGUS" in msgs
    assert "DGREP_LOG read outside its owner" in msgs
    assert "DGREP_NO_CALIBRATE is listed in analysis/knobs.py NOT_PORTED" \
        in msgs


def test_env_knobs_fires_on_stale_registry_entry(tmp_path):
    _mk(tmp_path, "utils/logging.py", "x = 1\n")  # owner exists, no read
    got = _hits(tmp_path, "env-knobs")
    assert any("DGREP_LOG is never read" in v.message for v in got)


def test_env_knobs_resolves_module_constant_keys(tmp_path):
    _mk(tmp_path, "utils/spans.py",
        "import os\n"
        "_ENV_VAR = 'DGREP_SPANS'\n"
        "def enabled():\n"
        "    return os.environ.get(_ENV_VAR, '') not in ('', '0')\n")
    assert not _hits(tmp_path, "env-knobs")
    _mk(tmp_path, "runtime/x.py",
        "import os\n"
        "_V = 'DGREP_SPANS'\n"
        "y = os.environ.get(_V)\n")
    got = _hits(tmp_path, "env-knobs")
    assert any("DGREP_SPANS read outside its owner" in v.message
               for v in got)


def test_env_knobs_resolves_function_local_keys(tmp_path):
    _mk(tmp_path, "runtime/x.py",
        "import os\n"
        "def f():\n"
        "    var = 'DGREP_TOTALLY_BOGUS'\n"
        "    return os.environ.get(var)\n")
    got = _hits(tmp_path, "env-knobs")
    assert any("DGREP_TOTALLY_BOGUS" in v.message for v in got)


def test_knob_registry_docs_cover_every_knob():
    docs = knob_docs()
    for name, knob in KNOBS.items():
        assert name in docs and knob.owner in docs
    not_ported = docs.split("## Not ported", 1)[1]
    for name in NOT_PORTED:
        assert f"`{name}`" in not_ported
    assert not set(KNOBS) & set(NOT_PORTED)


# ------------------------------------------------------------------- R5 rpc

def test_rpc_elide_fires_on_missing_drift_and_dead_keys(tmp_path):
    msgs = "\n".join(v.message for v in _hits(
        _fixture(tmp_path, "rpc_missing_drift_dead"), "rpc-elide"))
    assert "Optional-default field A.m missing" in msgs
    assert "_ELIDE_DEFAULTS['x'] == 5 but A.x defaults to 1" in msgs
    assert "key 'gone' is not a field" in msgs


def test_rpc_elide_silent_on_consistent_schema(tmp_path):
    assert not _hits(_fixture(tmp_path, "rpc_consistent"), "rpc-elide")


def test_rpc_elide_reply_side_fires_on_unregistered_and_truthy(tmp_path):
    msgs = "\n".join(v.message for v in _hits(
        _fixture(tmp_path, "rpc_reply_unregistered_truthy"), "rpc-elide"))
    assert ("reply field PollReply.orphan is in neither _REPLY_BASE nor "
            "_REPLY_ELIDE") in msgs
    assert ("_REPLY_ELIDE field PollReply.retries defaults to 3 (truthy)"
            ) in msgs
    assert "reply registry key 'gone' is not a field" in msgs


def test_rpc_elide_reply_side_fires_on_missing_registries_and_both(
        tmp_path):
    msgs = "\n".join(v.message for v in _hits(
        _fixture(tmp_path, "rpc_reply_missing_registries"), "rpc-elide"))
    assert ("reply dataclasses present but _REPLY_BASE/_REPLY_ELIDE "
            "tuple literals missing") in msgs
    msgs = "\n".join(v.message for v in _hits(
        _fixture(tmp_path, "rpc_reply_both_sides"), "rpc-elide"))
    assert "registered in BOTH _REPLY_BASE and _REPLY_ELIDE" in msgs


def test_rpc_elide_reply_side_silent_on_partitioned_schema(tmp_path):
    assert not _hits(_fixture(tmp_path, "rpc_reply_partitioned"),
                     "rpc-elide")


# --------------------------------------------------------------- R7 logging

def test_logging_fires_on_print_and_root_logger(tmp_path):
    msgs = "\n".join(v.message for v in _hits(
        _fixture(tmp_path, "logging_print_and_root"), "logging"))
    assert "bare print()" in msgs and "root-logger" in msgs \
        and "without get_logger" in msgs


def test_logging_scope_and_get_logger_exemptions(tmp_path):
    assert not _hits(_fixture(tmp_path, "logging_exempt"), "logging")


# -------------------------------------------------------------- R8 net-retry

def test_net_retry_fires_on_raw_urlopen_and_socket(tmp_path):
    got = _hits(_fixture(tmp_path, "net_raw_urlopen_socket"), "net-retry")
    assert [(v.path, v.line) for v in got] == [
        ("__main__.py", 3), ("runtime/x.py", 4), ("runtime/x.py", 6),
    ]
    assert all("retry-wrapped transport helpers" in v.message for v in got)


def test_net_retry_silent_on_transport_module_and_out_of_scope(tmp_path):
    assert not _hits(_fixture(tmp_path, "net_exempt"), "net-retry")


def test_net_retry_fires_on_addr_comma_split_outside_transport(tmp_path):
    got = _hits(_fixture(tmp_path, "net_addr_split"), "net-retry")
    assert [(v.path, v.line) for v in got] == [
        ("__main__.py", 2), ("runtime/x.py", 2),
    ]
    assert all("split_addrs" in v.message for v in got)


def test_net_retry_silent_on_non_addr_splits_and_transport_split(tmp_path):
    assert not _hits(_fixture(tmp_path, "net_other_splits"), "net-retry")


# ------------------------------------------------------ R9 locked-blocking

def test_locked_blocking_fires_in_with_block_and_locked_method(tmp_path):
    got = _hits(_fixture(tmp_path, "blocking_with_and_locked"),
                "locked-blocking")
    assert [v.line for v in got] == [8, 10, 13]
    msgs = "\n".join(v.message for v in got)
    assert "open()" in msgs and "os.fsync()" in msgs
    assert "journal.map_completed() [I/O object]" in msgs
    assert "_locked convention" in got[1].message


def test_locked_blocking_fires_on_sleep_engine_and_socket(tmp_path):
    got = _hits(_fixture(tmp_path, "blocking_sleep_engine_socket"),
                "locked-blocking")
    assert [v.line for v in got] == [7, 8, 9]


def test_locked_blocking_nested_compound_reports_once(tmp_path):
    got = _hits(_fixture(tmp_path, "blocking_nested_compound"),
                "locked-blocking")
    assert [v.line for v in got] == [7, 11]


def test_locked_blocking_nested_def_under_lock_is_not_flagged(tmp_path):
    assert not _hits(_fixture(tmp_path, "blocking_nested_def"),
                     "locked-blocking")


def test_locked_blocking_io_ok_and_staged_flush_stay_silent(tmp_path):
    assert not _hits(_fixture(tmp_path, "blocking_io_ok_and_staged"),
                     "locked-blocking")


def test_locked_blocking_out_of_scope_dirs_are_exempt(tmp_path):
    assert not _hits(_fixture(tmp_path, "blocking_out_of_scope"),
                     "locked-blocking")


# ----------------------------------------------------------- R10 lock-order

def test_lock_order_fires_on_cross_function_cycle(tmp_path):
    got = _hits(_fixture(tmp_path, "order_cross_function"), "lock-order")
    assert len(got) == 1
    assert "lock-order cycle" in got[0].message


def test_lock_order_three_lock_cycle_reports_once(tmp_path):
    got = _hits(_fixture(tmp_path, "order_three_lock"), "lock-order")
    assert len(got) == 1 and "cycle" in got[0].message


def test_lock_order_fires_on_lexical_self_reacquire(tmp_path):
    (v,) = _hits(_fixture(tmp_path, "order_self_reacquire"), "lock-order")
    assert "re-acquired while already held" in v.message


def test_lock_order_cross_module_edge_via_annotation(tmp_path):
    assert not _hits(_fixture(tmp_path, "order_cross_module_acyclic"),
                     "lock-order")
    got = _hits(_fixture(tmp_path, "order_cross_module_cycle"),
                "lock-order")
    assert len(got) == 1 and "cycle" in got[0].message


def test_lock_order_conditional_acquire_helper_is_not_a_self_cycle(tmp_path):
    assert not _hits(_fixture(tmp_path, "order_conditional_acquire"),
                     "lock-order")


def test_lock_order_make_lock_names_and_condition_alias(tmp_path):
    assert not _hits(_fixture(tmp_path, "order_make_lock_condition"),
                     "lock-order")


# ------------------------------------------------------ R12 metrics-registry

def test_metrics_registry_fires_on_undeclared_and_mismatch(tmp_path):
    _mk(tmp_path, "runtime/x.py",
        "from distributed_grep_tpu_torch.utils import metrics as m\n"
        "c = m.counter('dgrep_bogus_total')\n"
        "g = m.gauge('dgrep_jobs_submitted_total')\n")
    msgs = "\n".join(v.message for v in _hits(tmp_path, "metrics-registry"))
    assert "undeclared metrics series dgrep_bogus_total" in msgs
    assert ("dgrep_jobs_submitted_total created as a gauge but declared "
            "counter") in msgs


def test_metrics_registry_fires_on_stale_declaration(tmp_path):
    _mk(tmp_path, "utils/metrics.py", "x = 1\n")
    msgs = "\n".join(v.message for v in _hits(tmp_path, "metrics-registry"))
    assert "declared metrics series dgrep_queue_wait_seconds is never " \
           "created" in msgs


def test_metrics_registry_silent_on_declared_and_mini_trees(tmp_path):
    _mk(tmp_path, "runtime/ok.py",
        "from distributed_grep_tpu_torch.utils import metrics as m\n"
        "h = m.histogram('dgrep_queue_wait_seconds')\n"
        "c = m.counter('dgrep_jobs_done_total')\n")
    _mk(tmp_path, "apps/other.py",
        "def counter(name):\n"
        "    return name\n"
        "x = counter('not_a_series')\n")
    assert not _hits(tmp_path, "metrics-registry")


# ------------------------------------------------------- R13 event-registry

def test_event_registry_fires_on_undeclared_name_and_kind(tmp_path):
    _mk(tmp_path, "runtime/x.py",
        "from distributed_grep_tpu_torch.utils import spans\n"
        "spans.instant('totally_bogus', cat='engine')\n"
        "with spans.span('resume', cat='service'):\n"
        "    pass\n")
    msgs = "\n".join(v.message for v in _hits(tmp_path, "event-registry"))
    assert "undeclared event name 'totally_bogus'" in msgs
    assert "'resume' emitted as a span but declared instant/daemon" in msgs


def test_event_registry_fires_on_cat_mismatch_and_dict_literal(tmp_path):
    _mk(tmp_path, "runtime/x.py",
        "buf.add({'t': 'instant', 'name': 'index:prune', 'cat': 'map'})\n"
        "buf.add({'t': 'span', 'name': 'nobody:declared'})\n")
    msgs = "\n".join(v.message for v in _hits(tmp_path, "event-registry"))
    assert ("'index:prune' emitted with cat 'map' but declared cat "
            "'engine'") in msgs
    assert "undeclared event name 'nobody:declared'" in msgs


def test_event_registry_fires_on_undeclared_family_fstring(tmp_path):
    _mk(tmp_path, "apps/x.py",
        "from distributed_grep_tpu_torch.utils import spans\n"
        "def f(verdict):\n"
        "    spans.instant(f'bogus:{verdict}', cat='engine')\n")
    msgs = "\n".join(v.message for v in _hits(tmp_path, "event-registry"))
    assert "undeclared event family 'bogus:*'" in msgs


def test_event_registry_fires_on_consumer_side_drift(tmp_path):
    _mk(tmp_path, "runtime/explain.py",
        "def view(events):\n"
        "    return [e for e in events if e.get('name') is not None\n"
        "            and (name := e['name']) and name == 'scan_old_name']\n")
    msgs = "\n".join(v.message for v in _hits(tmp_path, "event-registry"))
    assert "consumer matches undeclared event name 'scan_old_name'" in msgs


def test_event_registry_fires_on_stale_declaration(tmp_path):
    _mk(tmp_path, "utils/spans.py", "x = 1\n")
    msgs = "\n".join(v.message for v in _hits(tmp_path, "event-registry"))
    assert "declared event 'scan:*' has no surviving emit site" in msgs


def test_event_registry_silent_on_declared_and_daemon_emitters(tmp_path):
    _mk(tmp_path, "runtime/ok.py",
        "from distributed_grep_tpu_torch.utils import spans\n"
        "def f(mode, verdict, daemon_log, anything):\n"
        "    spans.instant(f'cache:{verdict}', cat='engine')\n"
        "    with spans.span('map:read', cat='map'):\n"
        "        pass\n"
        "    daemon_log.stage('lease_steal', prev_epoch=1)\n"
        "    spans.instant(anything)\n")
    assert not _hits(tmp_path, "event-registry")


# ----------------------------------------------------------- SARIF output

def test_sarif_output_shape_and_stability(tmp_path, capsys):
    _mk(tmp_path, "parallel/x.py", "def f():\n    print('x')\n")
    assert analyze_main(["--root", str(tmp_path), "--sarif"]) == 1
    first = capsys.readouterr().out
    doc = json.loads(first)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "distributed-grep-torch-analyze"
    rule_ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert rule_ids == sorted(RULES)
    (res,) = [r for r in run["results"] if r["ruleId"] == "logging"]
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "parallel/x.py"
    assert loc["region"]["startLine"] == 2
    assert analyze_main(["--root", str(tmp_path), "--sarif"]) == 1
    assert capsys.readouterr().out == first
    assert analyze_main(["--root", str(tmp_path), "--json"]) == 1
    j1 = capsys.readouterr().out
    assert analyze_main(["--root", str(tmp_path), "--json"]) == 1
    assert capsys.readouterr().out == j1


def test_sarif_clean_tree_is_green_with_empty_results(tmp_path, capsys):
    _mk(tmp_path, "apps/ok.py", "x = 1\n")
    assert analyze_main(["--root", str(tmp_path), "--sarif"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["runs"][0]["results"] == []


# --------------------------------------------- suppression + CLI plumbing

def test_pragma_suppresses_named_rule_only(tmp_path):
    _mk(tmp_path, "parallel/x.py",
        "def f():\n"
        "    print('deliberate')  # analyze-ok: logging\n")
    assert not _hits(tmp_path, "logging")
    _mk(tmp_path, "parallel/y.py",
        "def f():\n"
        "    print('deliberate')  # analyze-ok: other-rule\n")
    assert any(v.path == "parallel/y.py"
               for v in _hits(tmp_path, "logging"))


def test_baseline_roundtrip_and_exit_codes(tmp_path, capsys):
    _mk(tmp_path, "parallel/x.py", "def f():\n    print('x')\n")
    root = str(tmp_path)
    assert analyze_main(["--root", root, "--rule", "logging"]) == 1
    base = tmp_path / "baseline.txt"
    assert analyze_main(["--root", root, "--rule", "logging",
                         "--write-baseline", str(base)]) == 0
    capsys.readouterr()
    assert analyze_main(["--root", root, "--rule", "logging",
                         "--baseline", str(base)]) == 0
    assert analyze_main(["--root", root, "--rule", "no-such-rule"]) == 2
    assert analyze_main(["--root", root,
                         "--baseline", str(tmp_path / "missing.txt")]) == 2
    assert analyze_main(["--list-rules"]) == 0
    assert analyze_main(["--knobs"]) == 0
    out = capsys.readouterr().out
    assert "DGREP_BATCH_BYTES" in out
    assert analyze_main(["--events"]) == 0
    out = capsys.readouterr().out
    assert "scan:*" in out and "lease_steal" in out


def test_json_output_shape(tmp_path, capsys):
    _mk(tmp_path, "parallel/x.py", "def f():\n    print('x')\n")
    assert analyze_main(["--root", str(tmp_path), "--json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["count"] >= 1
    v = doc["violations"][0]
    assert set(v) == {"rule", "path", "line", "message"}


def test_every_rule_has_a_doc_line():
    from distributed_grep_tpu_torch.analysis.rules import RULE_DOCS

    for name in RULES:
        assert RULE_DOCS[name], name


def test_project_tolerates_unparseable_file(tmp_path):
    _mk(tmp_path, "runtime/broken.py", "def f(:\n")
    (tmp_path / "runtime" / "binary.py").write_bytes(b'print("x\xff")\n')
    assert Project(tmp_path).tree("runtime/broken.py") is None
    assert Project(tmp_path).tree("runtime/binary.py") is None
    assert run_analysis(root=tmp_path) == []


def test_write_baseline_unwritable_path_is_clean_error(tmp_path, capsys):
    _mk(tmp_path, "parallel/x.py", "def f():\n    print('x')\n")
    rc = analyze_main(["--root", str(tmp_path), "--write-baseline",
                       str(tmp_path / "no" / "such" / "dir" / "b.txt")])
    assert rc == 2
    assert "error:" in capsys.readouterr().err


# ============================================ differential vs the reference

def _key(vs) -> list[tuple[str, str, int]]:
    return [(v.rule, v.path, v.line) for v in vs]


@pytest.mark.parametrize("name", sorted(
    n for n, (rule, _) in FIXTURES.items() if rule in DIFFERENTIAL_RULES))
def test_rule_agrees_with_the_reference(tmp_path, name):
    rule, files = FIXTURES[name]
    root = _tree(tmp_path, files)
    ours = run_analysis(root=root, rules=[rule])
    theirs = ref_run_analysis(root=root, rules=[rule])
    assert _key(ours) == _key(theirs)
    assert [v.message for v in ours] == [v.message for v in theirs]


def test_differential_rules_all_have_firing_fixtures(tmp_path):
    """Every rule of the differential set is held on at least one tree
    where it fires, so agreement is not agreement on silence."""
    fired = set()
    for n, (rule, files) in FIXTURES.items():
        if rule in DIFFERENTIAL_RULES and rule not in fired:
            root = _tree(tmp_path / n, files)
            if run_analysis(root=root, rules=[rule]):
                fired.add(rule)
    assert fired == set(DIFFERENTIAL_RULES)


def test_sarif_equals_the_reference_for_one_violation_list(tmp_path):
    root = _tree(tmp_path, {**FIXTURES["logging_print_and_root"][1],
                            **FIXTURES["blocking_with_and_locked"][1],
                            **FIXTURES["net_addr_split"][1]})
    rules = ["logging", "locked-blocking", "net-retry"]
    ours = run_analysis(root=root, rules=rules)
    assert _key(ours) == _key(ref_run_analysis(root=root, rules=rules))
    mine, ref = to_sarif(ours), ref_to_sarif(ours)
    tools = (mine["runs"][0]["tool"]["driver"],
             ref["runs"][0]["tool"]["driver"])
    # the rule tables differ by the rules each checker has; every rule
    # both have carries the same description
    shared = {r["id"]: r for r in tools[1]["rules"]}
    for r in tools[0]["rules"]:
        if r["id"] in shared:
            assert r == shared[r["id"]]
    for t in tools:
        t["name"] = t["informationUri"] = t["rules"] = "<masked>"
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)


# ------------------------------------------------------ the knob registries

# knobs whose default text differs, with the reason
DEFAULT_DIFFERENCES = {
    # the port logs nothing unless DGREP_LOG names a level
    "DGREP_LOG": ("INFO", "unset (no log)"),
}
# knobs read by another module than the reference's owner
OWNER_DIFFERENCES = {
    "DGREP_SWAR": ("ops/pallas_scan.py", "ops/swar_scan.py"),
}


def test_knob_registries_agree_with_the_reference():
    assert set(KNOBS) | set(NOT_PORTED) == set(REF_KNOBS)
    for name in sorted(set(KNOBS) & set(REF_KNOBS)):
        want = DEFAULT_DIFFERENCES.get(name)
        got = (REF_KNOBS[name].default, KNOBS[name].default)
        if want is None:
            assert got[0] == got[1], name
        else:
            assert got == want, name
        owners = (REF_KNOBS[name].owner, KNOBS[name].owner)
        if owners[0] != owners[1]:
            assert OWNER_DIFFERENCES.get(name) == owners, name
    for name, (owner, why, entry) in NOT_PORTED.items():
        assert owner == REF_KNOBS[name].owner
        assert why and re.fullmatch(r"D\d+(, D\d+)*", entry), name


def test_knobs_cli_lists_every_read_knob_and_the_not_ported(capsys):
    from distributed_grep_tpu_torch.analysis.rules import (
        _env_reads,
        _env_sink,
        _helpers,
    )

    project = Project(PACKAGE_ROOT)
    helpers = _helpers(project, "env", _env_sink)
    read = {var for rel in project.files()
            if project.tree(rel) is not None
            for var, _ in _env_reads(project.tree(rel), helpers)
            if var.startswith("DGREP_")}
    assert len(read) == 36
    assert analyze_main(["--knobs"]) == 0
    out = capsys.readouterr().out
    table, not_ported = out.split("## Not ported", 1)
    for name in read:
        assert f"`{name}`" in table
    for name in NOT_PORTED:
        assert f"`{name}`" in not_ported and f"`{name}`" not in table


def test_list_rules_prints_the_ported_and_the_own_rules(capsys):
    assert analyze_main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = [ln.split(":", 1)[0] for ln in lines]
    assert names == [
        "posix-expand", "store-resolve", "surrogateescape", "env-knobs",
        "rpc-elide", "logging", "net-retry", "locked-blocking",
        "lock-order", "metrics-registry", "event-registry",
        "own-copy", "no-fallback", "cuda-abi"]
    assert all(len(ln.split(": ", 1)[1]) > 20 for ln in lines)


# ================================================== the port's own rules

@pytest.mark.parametrize("rule", ["own-copy", "no-fallback", "cuda-abi",
                                  "env-knobs", "event-registry",
                                  "locked-blocking"])
def test_port_rule_is_silent_on_the_port(port_violations, rule):
    assert rule in RULES
    assert [v for v in port_violations if v.rule == rule] == []


def test_own_copy_fires_on_jax_and_reference_imports(tmp_path):
    _mk(tmp_path, "ops/x.py",
        "import importlib\n"
        "import numpy as np\n"
        "from distributed_grep_tpu_torch.models import dfa\n"
        "def f():\n"
        "    import jax\n"
        "    return jax\n"
        "def g():\n"
        "    from distributed_grep_tpu.models import dfa as ref\n"
        "    from jax.experimental import pallas\n"
        "    import jaxlib.xla_client\n"
        "    return importlib.import_module('jax.numpy'), ref, pallas\n"
        "from . import sibling\n")
    got = _hits(tmp_path, "own-copy")
    assert [v.line for v in got] == [5, 8, 9, 10, 11]
    assert "'jax'" in got[0].message
    assert "'distributed_grep_tpu.models'" in got[1].message


def test_no_fallback_fires_on_plain_leg_behind_a_failure(tmp_path):
    _mk(tmp_path, "ops/x_scan.py",
        "import torch\n"
        "def scan(data, model):\n"
        "    try:\n"
        "        return _kernel(data, model)\n"
        "    except RuntimeError:\n"
        "        return scan_words_plain(data, model)\n"
        "def confirm(lines):\n"
        "    try:\n"
        "        out = native_confirm(lines)\n"
        "    finally:\n"
        "        out = confirm_numpy(lines)\n"
        "    return out\n"
        "DEVICE = 'cuda' if torch.cuda.is_available() else 'cpu'\n"
        "def pick():\n"
        "    if torch.cuda.device_count() == 0:\n"
        "        return 'cpu'\n"
        "    return 'cuda'\n")
    got = _hits(tmp_path, "no-fallback")
    assert [v.line for v in got] == [6, 11, 13, 15]
    assert "scan_words_plain() called in an except handler" in got[0].message
    assert "a finally block" in got[1].message


def test_no_fallback_silent_on_device_dispatch_and_declines(tmp_path):
    _mk(tmp_path, "ops/ok_scan.py",
        "import torch\n"
        "def scan(data, model):\n"
        "    if data.device.type == 'cpu':\n"
        "        return scan_words_plain(data, model)\n"
        "    return _kernel(data, model)\n"
        "def fmt(batch):\n"
        "    out = native.format_batch(batch)\n"
        "    return format_numpy(batch) if out is None else out\n"
        "def check():\n"
        "    if not torch.cuda.is_available():\n"
        "        raise RuntimeError('no card: pass --device cpu')\n"
        "def cleanup(p):\n"
        "    try:\n"
        "        return p.read()\n"
        "    except OSError:\n"
        "        return None\n")
    assert not _hits(tmp_path, "no-fallback")


_CU_GOOD = """\
// a kernel and its C interface
#include <cstdint>
__global__ void k(const uint8_t* d) {}
extern "C" int dgrep_x_scan(const void* data, void* out, int chunk,
                            long long pitch, unsigned int bit,
                            void* stream) {
  return 0;  /* "not a string" */
}
"""
_CPP_GOOD = """\
#include <cstddef>
#include <cstdint>
extern "C" {
static int helper(int a) { return a; }
size_t dgrep_count(const uint8_t* data, size_t len) {
  return len;
}
void dgrep_free(void* handle) {}
}  // extern "C"
"""
_SCAN_GOOD = """\
import ctypes
from distributed_grep_tpu_torch.ops import _build
LIBRARY = "x"
_P, _I = ctypes.c_void_p, ctypes.c_int
X_ARGTYPES = [_P, _P, _I, ctypes.c_longlong, ctypes.c_uint, _P]
def _lib():
    lib = _build.load(LIBRARY)
    fn = lib.dgrep_x_scan
    if fn.argtypes is None:
        fn.argtypes = X_ARGTYPES
        fn.restype = ctypes.c_int
    return fn
"""
_NATIVE_GOOD = """\
import ctypes
_c = ctypes
_u8p = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "dgrep_count": (_c.c_size_t, [_u8p, _c.c_size_t]),
    "dgrep_free": (None, [_c.c_void_p]),
}
"""
_BUILD_GOOD = 'SOURCES = ("x",)\nHOST_SOURCES = ("dgrep",)\n'


def _abi_tree(root: Path, over: dict[str, str] | None = None) -> Path:
    """A mini-tree whose bindings match their C signatures, with the files
    of ``over`` in place of the good ones."""
    files = {"csrc/x.cu": _CU_GOOD, "csrc/dgrep.cpp": _CPP_GOOD,
             "ops/x_scan.py": _SCAN_GOOD, "utils/native.py": _NATIVE_GOOD,
             "ops/_build.py": _BUILD_GOOD}
    return _tree(root, {**files, **(over or {})})


def test_cuda_abi_silent_on_matching_interfaces(tmp_path):
    assert not _hits(_abi_tree(tmp_path), "cuda-abi")


def test_cuda_abi_parses_extern_c_blocks_and_definitions():
    funcs = extern_c_functions(_CPP_GOOD)
    assert set(funcs) == {"dgrep_count", "dgrep_free"}
    assert funcs["dgrep_count"] == (5, (64, False), ["ptr", (64, False)])
    assert funcs["dgrep_free"][1:] == ("void", ["ptr"])
    (name,) = extern_c_functions(_CU_GOOD)
    assert extern_c_functions(_CU_GOOD)[name][2] == [
        "ptr", "ptr", (32, True), (64, True), (32, False), "ptr"]


def test_cuda_abi_fires_on_argtypes_one_short(tmp_path):
    scan = _SCAN_GOOD.replace("ctypes.c_uint, _P]", "ctypes.c_uint]")
    (v,) = _hits(_abi_tree(tmp_path, {"ops/x_scan.py": scan}), "cuda-abi")
    assert v.path == "ops/x_scan.py" and v.line == 10
    assert "bound with 5 argtypes but csrc/x.cu:4 declares 6" in v.message


def test_cuda_abi_fires_on_c_int_bound_to_int64(tmp_path):
    cpp = _CPP_GOOD.replace("size_t dgrep_count(const uint8_t* data, "
                            "size_t len)",
                            "size_t dgrep_count(const uint8_t* data, "
                            "int64_t len)")
    native = _NATIVE_GOOD.replace("[_u8p, _c.c_size_t]", "[_u8p, _c.c_int]")
    (v,) = _hits(_abi_tree(tmp_path, {"csrc/dgrep.cpp": cpp,
                                     "utils/native.py": native}), "cuda-abi")
    assert v.path == "utils/native.py" and v.line == 5
    assert ("dgrep_count argument 2 is bound as signed 32-bit but "
            "csrc/dgrep.cpp:5 declares signed 64-bit") in v.message


def test_cuda_abi_fires_on_pointer_and_restype_mismatches(tmp_path):
    scan = _SCAN_GOOD.replace("X_ARGTYPES = [_P, _P, _I",
                              "X_ARGTYPES = [_P, _I, _I").replace(
        "fn.restype = ctypes.c_int", "fn.restype = ctypes.c_int64")
    got = _hits(_abi_tree(tmp_path, {"ops/x_scan.py": scan}), "cuda-abi")
    msgs = "\n".join(v.message for v in got)
    assert "argument 2 is bound as signed 32-bit but csrc/x.cu:4 " \
           "declares a pointer" in msgs
    assert "restype is signed 64-bit but csrc/x.cu:4 returns signed " \
           "32-bit" in msgs


def test_cuda_abi_fires_on_missing_source_and_unknown_binding(tmp_path):
    root = _abi_tree(tmp_path, {"csrc/y.cu": _CU_GOOD.replace(
        "dgrep_x_scan", "dgrep_y_scan")})
    native = _NATIVE_GOOD.replace('"dgrep_free"', '"dgrep_gone"')
    _mk(root, "utils/native.py", native)
    got = _hits(root, "cuda-abi")
    msgs = "\n".join(v.render() for v in got)
    assert "ops/_build.py:1: [cuda-abi] csrc/y.cu is not in SOURCES" in msgs
    assert "dgrep_gone is bound in _SIGNATURES but no csrc/*.cpp " \
           "exports" in msgs
    _mk(root, "ops/_build.py", 'SOURCES = ("x", "y", "z")\n'
                               'HOST_SOURCES = ("dgrep",)\n')
    msgs = "\n".join(v.message for v in _hits(root, "cuda-abi"))
    assert "SOURCES names 'z' but csrc/z.cu does not exist" in msgs
    assert "csrc/y.cu is not in SOURCES" not in msgs


def test_cuda_abi_fires_on_shared_memory_budget(tmp_path):
    scan = _SCAN_GOOD + "SMEM_BYTES = 232448 + 1024\n"
    cu = _CU_GOOD + "constexpr int kSmemBytes = 232448;\n"
    got = _hits(_abi_tree(tmp_path, {"ops/x_scan.py": scan,
                                    "csrc/x.cu": cu}), "cuda-abi")
    msgs = "\n".join(v.message for v in got)
    assert "SMEM_BYTES = 233472 exceeds the card's 232448-byte" in msgs
    assert "kSmemBytes is 232448" in msgs


# the port's csrc/ sources and the modules that bind their entry points
_ABI_COPY = ("csrc", "ops", "utils", "benchmarks")


@pytest.mark.parametrize("source", sorted(
    p.name for p in (PACKAGE_ROOT / "csrc").iterdir()
    if p.suffix in (".cu", ".cpp")))
def test_cuda_abi_holds_every_port_entry_point(tmp_path, source):
    """A parameter added to each extern "C" function of one csrc/ source
    of the port (a copy) makes the rule name every one of them: every
    kernel of PERF.md rows 1-10 and the host library is checked."""
    for d in _ABI_COPY:
        shutil.copytree(PACKAGE_ROOT / d, tmp_path / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / "csrc" / source
    src = path.read_text()
    names = extern_c_functions(src)
    assert names
    for name in names:
        src = re.sub(rf"\b{name}\(", f"{name}(int extra_, ", src)
    path.write_text(src)
    got = _hits(tmp_path, "cuda-abi")
    flagged = {n for n in names for v in got
               if v.message.startswith(f"{n} is bound with")}
    assert flagged == set(names)


# ---------------------------------------------------------- helper cases

_LAYOUT = """\
import os
def _env_int(name):
    raw = os.environ.get(name)
    return None if raw is None else int(raw)
def env_device_min_bytes():
    return _env_int("DGREP_DEVICE_MIN_BYTES")
def env_batch_bytes():
    return _env_int("DGREP_BATCH_BYTES")
def env_corpus_bytes():
    return _env_int(name="DGREP_CORPUS_BYTES")
"""


def test_env_knobs_sees_through_a_helper(tmp_path):
    _mk(tmp_path, "ops/layout.py", _LAYOUT)
    assert not _hits(tmp_path, "env-knobs")  # the owner's read counts
    _mk(tmp_path, "runtime/x.py",
        "from distributed_grep_tpu_torch.ops.layout import _env_int\n"
        "def f(cached):\n"
        "    return _env_int('DGREP_LOG' if cached else 'DGREP_X')\n")
    msgs = "\n".join(v.render() for v in _hits(tmp_path, "env-knobs"))
    assert ("runtime/x.py:3: [env-knobs] DGREP_LOG read outside its "
            "owner module utils/logging.py") in msgs
    assert "runtime/x.py:3: [env-knobs] unregistered env knob DGREP_X" \
        in msgs
    _mk(tmp_path, "ops/layout.py", _LAYOUT.replace(
        '    return _env_int("DGREP_BATCH_BYTES")\n', "    return 0\n"))
    msgs = "\n".join(v.message for v in _hits(tmp_path, "env-knobs"))
    assert "DGREP_BATCH_BYTES is never read by its owner" in msgs


_FOLLOW = """\
import time
class Runner:
    def _wake_event(self, name, n_files, n_records):
        self.event_log.write({"t": "instant", "name": name,
                              "cat": "follow", "ts": time.time()})
    def wake_once(self):
        self._wake_event("follow:wake", 1, 2)
    def note_fused_wake(self, n_files, n_records, *, fused=True):
        self._wake_event("fuse:wake" if fused else "follow:wake", n_files,
                         n_records)
"""


def test_event_registry_sees_through_a_helper(tmp_path):
    _mk(tmp_path, "runtime/follow.py", _FOLLOW)
    assert not _hits(tmp_path, "event-registry")
    # with the stale check on, the helper's call sites count as emits
    _mk(tmp_path, "utils/spans.py", "x = 1\n")
    stale = {v.message.split("'")[1] for v in _hits(tmp_path,
                                                    "event-registry")}
    assert "follow:wake" not in stale and "fuse:wake" not in stale
    assert "scan:*" in stale
    _mk(tmp_path, "runtime/follow.py",
        _FOLLOW.replace('("follow:wake", 1, 2)', '("follow:wakes", 1, 2)')
        .replace('"cat": "follow"', '"cat": "map"'))
    msgs = "\n".join(v.render() for v in _hits(tmp_path, "event-registry"))
    assert ("runtime/follow.py:7: [event-registry] undeclared event name "
            "'follow:wakes'") in msgs
    assert ("runtime/follow.py:9: [event-registry] 'fuse:wake' emitted with "
            "cat 'map'") in msgs


# ------------------------------------------------------------- the version

def test_version_equals_the_reference():
    import distributed_grep_tpu
    import distributed_grep_tpu_torch

    assert distributed_grep_tpu_torch.__version__ == "0.1.0"
    assert distributed_grep_tpu_torch.__version__ == \
        distributed_grep_tpu.__version__


# ------------------------------------------------- C15: a repaired finding

def _follow_cli(pkg: str, cwd: Path,
                name: bytes) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTHONIOENCODING", "PYTHONUTF8"))}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               DGREP_LOG="WARNING", LC_ALL="C.UTF-8")
    return subprocess.run(
        [sys.executable, "-m", pkg, "grep", "--follow", "--follow-idle-s",
         "0.5", "--backend", "cpu", "volcano", os.fsdecode(name)],
        cwd=cwd, env=env, capture_output=True, timeout=120, check=False)


def test_c15_follow_prints_a_non_utf8_file_name_as_the_reference(tmp_path):
    """The surrogateescape finding at the port's ``grep --follow`` print
    (a bare ``.encode()``): a file name that is not UTF-8 made the port
    exit 2 with an encode error where the reference prints the line."""
    name = b"caf\xe9.log"
    (tmp_path / os.fsdecode(name)).write_bytes(b"hello volcano\nbye\n")
    ours = _follow_cli("distributed_grep_tpu_torch", tmp_path, name)
    ref = _follow_cli("distributed_grep_tpu", tmp_path, name)
    assert ref.returncode == 0
    assert ref.stdout.endswith(b"/" + name + b" (line number #1) hello "
                               b"volcano\n")
    assert (ours.returncode, ours.stdout) == (0, ref.stdout), ours.stderr
