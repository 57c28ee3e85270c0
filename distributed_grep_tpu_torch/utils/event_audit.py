"""Runtime check of the telemetry vocabulary (the reference's
utils/event_audit.py): every span and instant name a SpanBuffer or an
EventLog takes is looked up in ``analysis/events.py EVENTS``, the
package's copy of the reference's registry.  An undeclared name, or one
emitted as another kind than its declaration's, is a finding.

Off by default: every hook is one module-global bool read, and the span
pipeline calls ``record()`` outside its buffer locks.  ``activate()``
switches it on (tests); ``DGREP_EVENT_AUDIT=1`` before the process starts
switches it on at import and also logs each finding as a warning.
"""

from __future__ import annotations

import os
import threading

_MAX_FINDINGS = 256

_lock = threading.Lock()
_active = False
_env_mode = False
_findings: list[str] = []
_flagged: set[str] = set()


def env_event_audit() -> bool:
    """DGREP_EVENT_AUDIT: ``1`` validates every emitted span/instant/
    daemon-event name against the analysis/events.py registry and logs
    undeclared names.  Default off (zero overhead)."""
    return os.environ.get("DGREP_EVENT_AUDIT", "").strip() == "1"


def is_active() -> bool:
    return _active


def activate() -> None:
    global _active
    _active = True


def deactivate() -> None:
    global _active
    _active = False


def reset() -> None:
    with _lock:
        _findings.clear()
        _flagged.clear()


def findings() -> list[str]:
    with _lock:
        return list(_findings)


def record(kind: str, name) -> None:
    """Validate one emitted event name (kind: "span"|"instant"|"daemon").
    No-op unless the audit is active; duplicate names report once."""
    if not _active or not isinstance(name, str) or not name:
        return
    # resolved on first use: utils/spans.py imports this module
    from distributed_grep_tpu_torch.analysis.events import lookup

    hit = lookup(name)
    if hit is None:
        msg = (f"undeclared {kind} event name {name!r}: not in "
               f"analysis/events.py EVENTS (nor any declared family)")
    elif kind not in hit[1].kinds:
        msg = (f"event {name!r} emitted as a {kind} but declared "
               f"{'/'.join(hit[1].kinds)} in analysis/events.py EVENTS")
    else:
        return
    with _lock:
        if name in _flagged or len(_findings) >= _MAX_FINDINGS:
            return
        _flagged.add(name)
        _findings.append(msg)
    if _env_mode:
        from distributed_grep_tpu_torch.utils.logging import get_logger

        get_logger("event_audit").warning("%s", msg)


if env_event_audit():
    _env_mode = True
    activate()
