"""The peer-to-peer shuffle's data plane: the worker's data server (the
reference's runtime/peer.py).

Over the relay data plane every intermediate byte passes through the
daemon twice: the producing map PUTs it, the reducer GETs it back.  With
the peer shuffle a reducer reads a map's output from the worker that
produced it, and the daemon keeps only metadata (who holds which
partition), re-running a map whose output died with its worker.

``PeerDataServer`` is the serving half: an HTTP server (the
``http_coordinator.DataPlaneHandler`` plumbing) over a local spool.  A map
commit writes ``mr-<tid>-<r>``, the exact bytes the relay would PUT
(columnar batches included), into the spool with a temp file and a rename,
and registers its size and crc32 on the commit record and the finished
RPC; a reducer fetches ``GET /shuffle/<job>/<name>`` and checks both.

The spool is process state: a dead worker takes its shuffle output with
it.  The scheduler's lost-output path (the reducer reports the fetch it
could not make, the producing map runs again, the vanished producer is
charged) is what recovers.

``DGREP_PEER_SHUFFLE`` (on by default for workers attached to a service
daemon; a one-shot coordinator never uses it): ``0`` starts no server and
keeps no spool, and every payload is the relay protocol's bytes.
"""

from __future__ import annotations

import os
import shutil
import socket
import tempfile
import threading
import time
import urllib.parse
import zlib
from collections import Counter
from http.server import ThreadingHTTPServer
from pathlib import Path

from distributed_grep_tpu_torch.runtime.http_coordinator import DataPlaneHandler
from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("peer")

# A job's spool directory untouched this long is pruned at a later put()
# (a worker never learns that a job ended); a pruned file still wanted is
# a lost-output report, and its map runs again.
_SPOOL_PRUNE_S = 3600.0


def env_peer_shuffle(default: bool = True) -> bool:
    """DGREP_PEER_SHUFFLE: the peer shuffle for service-attached workers
    (on by default); "0"/"false"/"no" is the relay data plane exactly."""
    raw = os.environ.get("DGREP_PEER_SHUFFLE")
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "no")


def env_peer_port(default: int = 0) -> int:
    """DGREP_PEER_PORT: the data server's port (0, the default, an
    ephemeral one: several worker processes on a host each bind their
    own; malformed or negative keeps the default)."""
    raw = os.environ.get("DGREP_PEER_PORT")
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except ValueError:
        return default
    return v if v >= 0 else default


def env_peer_host(default: str = "") -> str:
    """DGREP_PEER_HOST: the host the endpoint advertises (empty: the bind
    host); set it when peers must dial a routable name."""
    raw = os.environ.get("DGREP_PEER_HOST")
    return raw.strip() if raw else default


def env_peer_bind(default: str = "") -> str:
    """DGREP_PEER_BIND: the address the data server binds.  Empty binds
    loopback, unless DGREP_PEER_HOST advertises a name, which implies the
    wildcard (a server on 127.0.0.1 cannot be reached by the name other
    hosts are told to dial)."""
    raw = os.environ.get("DGREP_PEER_BIND")
    if raw and raw.strip():
        return raw.strip()
    if default:
        return default
    return "0.0.0.0" if env_peer_host() else "127.0.0.1"


def checksum(data: bytes) -> str:
    """The spool entry's self-checksum: crc32 as 8 hex digits (the store's
    commit-record checksum)."""
    return f"{zlib.crc32(data):08x}"


def _safe_segment(name: str) -> str:
    name = urllib.parse.unquote(name)
    if "/" in name or name.startswith("."):
        raise ValueError(f"invalid shuffle path segment: {name!r}")
    return name


class PeerDataServer:
    """One worker process's shuffle data server: a spool of committed map
    output and the GET surface other workers' reducers fetch from, shared
    by every task loop of the process (names are unique a job, task and
    partition)."""

    def __init__(self, host: str | None = None, port: int | None = None,
                 spool_dir: str | None = None):
        self.spool_root = Path(spool_dir or tempfile.mkdtemp(
            prefix="dgrep-peer-"))
        self._owns_spool = spool_dir is None
        host = env_peer_bind() if host is None else host
        self._httpd = ThreadingHTTPServer(
            (host, env_peer_port() if port is None else port),
            _make_peer_handler(self))
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None
        self._closed = False
        adv_host = env_peer_host() or host
        if adv_host in ("0.0.0.0", "::"):
            # a wildcard is not dialable: advertise the host's name
            adv_host = socket.gethostname()
        self.endpoint = f"http://{adv_host}:{self._httpd.server_address[1]}"
        # the spool's live size, updated by every task loop of the process
        self._spool_lock = threading.Lock()
        self._spool_bytes = 0
        self._last_prune = time.monotonic()
        # the bytes served (DataPlaneHandler._send_file counts them)
        self._traffic_lock = threading.Lock()
        self.data_plane: Counter = Counter()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def count(self, table: Counter, **adds: float) -> None:
        with self._traffic_lock:
            for k, v in adds.items():
                table[k] += v

    def start(self) -> "PeerDataServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="peer-data", daemon=True)
        self._thread.start()
        log.info("peer shuffle data server on %s (spool %s)", self.endpoint,
                 self.spool_root)
        return self

    # --------------------------------------------------------------- spool
    def spool_path(self, job_id: str, name: str) -> Path:
        return (self.spool_root / _safe_segment(job_id or "_")
                / _safe_segment(name))

    def put(self, job_id: str, name: str, data: bytes) -> tuple[int, str]:
        """Commit one intermediate file to the spool (a temp file and a
        rename, no fsync: a torn entry after a crash is a dead worker's,
        and the lost-output path recovers both); (size, crc32) for the
        commit record and the finished RPC."""
        p = self.spool_path(job_id, name)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(p.name + ".tmp")
        prev = p.stat().st_size if p.exists() else 0
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)
        with self._spool_lock:
            self._spool_bytes += len(data) - prev
        self._maybe_prune()
        return len(data), checksum(data)

    def get_local(self, job_id: str, name: str) -> bytes:
        """A spool entry without HTTP: the reducer is its producer."""
        return self.spool_path(job_id, name).read_bytes()

    def spool_bytes(self) -> int:
        return max(0, self._spool_bytes)

    def _maybe_prune(self, max_age_s: float = _SPOOL_PRUNE_S) -> None:
        """Drop the job directories untouched for ``max_age_s``; at most
        once a minute."""
        now = time.monotonic()
        if now - self._last_prune < 60.0:
            return
        self._last_prune = now
        cutoff = time.time() - max_age_s
        try:
            for d in self.spool_root.iterdir():
                if not d.is_dir():
                    continue
                try:
                    if d.stat().st_mtime < cutoff and not any(
                            f.stat().st_mtime >= cutoff for f in d.iterdir()):
                        freed = sum(f.stat().st_size for f in d.iterdir()
                                    if f.is_file())
                        shutil.rmtree(d, ignore_errors=True)
                        with self._spool_lock:
                            self._spool_bytes -= freed
                        log.info("pruned idle shuffle spool %s (%d bytes)",
                                 d.name, freed)
                except OSError:
                    continue
        except OSError:
            pass

    def close(self) -> None:
        """Stop serving and delete the spool when it is ours: the
        producer's death, as its reducers see it."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            # shutdown() waits on serve_forever: never on an unstarted one
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._owns_spool:
            shutil.rmtree(self.spool_root, ignore_errors=True)


def _make_peer_handler(server: PeerDataServer):
    class Handler(DataPlaneHandler):
        server_ref = server

        # GET /shuffle/<job>/<name>, /healthz
        def do_GET(self):
            self._streaming_body = False  # per request (keep-alive)
            try:
                if self.path == "/healthz":
                    self._send_json({"ok": True,
                                     "spool_bytes": server.spool_bytes()})
                    return
                if not self.path.startswith("/shuffle/"):
                    self._send_json({"error": "not found"}, 404)
                    return
                rest = self.path[len("/shuffle/"):]
                parts = rest.split("/", 1)
                if len(parts) != 2:
                    self._send_json(
                        {"error": f"bad shuffle path: {self.path!r}"}, 400)
                    return
                p = server.spool_path(parts[0], parts[1])
                if not p.exists():
                    # pruned, or never produced here: the reducer reports
                    # it lost and the map runs again
                    self._send_json({"error": f"no such file: {rest}"}, 404)
                    return
                self._send_file(p)
            except BrokenPipeError:
                self.close_connection = True
            except Exception as e:  # noqa: BLE001 -- answered 500
                self.close_connection = True
                log.exception("peer get error on %s", self.path)
                if getattr(self, "_streaming_body", False):
                    return  # the headers are out: never splice JSON in
                try:
                    self._send_json({"error": str(e)}, 400
                                    if isinstance(e, ValueError) else 500)
                except OSError:
                    pass

    return Handler
