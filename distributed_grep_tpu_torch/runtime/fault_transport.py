"""Deterministic network-fault injection around any Transport (the
reference's runtime/fault_transport.py), the control- and data-plane
sibling of ``runtime/store.FaultStore``.

``FaultTransport(base, hooks)`` wraps the Transport methods a worker
calls: the five control verbs and the data plane, ``fetch_peer`` (the
peer shuffle's fetch) among them.  ``hooks`` maps a FaultPoint to a
callable(ctx), ctx the wrapped method's name (``"map_finished"``,
``"read_input"``, ...); a truthy return injects at that point:

* DROP_REQUEST: the call is not made; ConnectionResetError (the request
  died on the wire before the peer saw it);
* DROP_REPLY: the call is made and its reply dropped;
  ConnectionResetError (the peer acted and the caller cannot know: a
  retry delivers twice, which the idempotent commits must absorb);
* DELAY: the truthy return is seconds to sleep before the call;
* DUPLICATE: the call is made twice, the first reply dropped.

An injected error reaches the caller as a broken connection whose retry
schedule ran dry reaches it: a worker loop over this wrapper dies as a
worker whose network died, and the scheduler's re-execution and
quarantine are what the chaos tests then hold to account.  Methods the
base lacks are not added, so the worker's ``hasattr`` probes see the
base's truth.
"""

from __future__ import annotations

import random
import time
from typing import Callable

from distributed_grep_tpu_torch.utils.logging import get_logger

log = get_logger("fault_transport")


class FaultPoint:
    """The injection points: each one way the network can betray a call."""

    DROP_REQUEST = "drop_request"
    DROP_REPLY = "drop_reply"
    DELAY = "delay"
    DUPLICATE = "duplicate"

    ALL = (DROP_REQUEST, DROP_REPLY, DELAY, DUPLICATE)


# The Transport methods wrapped, where the base has them.
_WRAPPED = (
    "assign_task", "map_finished", "reduce_finished", "reduce_next_file",
    "heartbeat",
    "read_input", "read_input_path", "write_intermediate",
    "read_intermediate", "write_output", "write_output_from_file",
    "publish_task_commit", "fetch_peer",
)


class FaultTransport:
    """A Transport with faults injected at its boundary."""

    def __init__(self, base, hooks: dict[str, Callable]):
        self.base = base
        self.hooks = dict(hooks)
        unknown = set(self.hooks) - set(FaultPoint.ALL)
        if unknown:
            raise ValueError(f"unknown fault points: {sorted(unknown)}")
        for name in _WRAPPED:
            if hasattr(base, name):
                setattr(self, name, self._wrap(name))

    def __getattr__(self, name: str):
        # everything not wrapped (is_local, bind_job, retry_count, ...) is
        # the base's
        return getattr(self.base, name)

    def _wrap(self, name: str) -> Callable:
        fn = getattr(self.base, name)

        def call(*args, **kwargs):
            delay_hook = self.hooks.get(FaultPoint.DELAY)
            if delay_hook:
                delay = delay_hook(name)
                if delay:
                    time.sleep(float(delay))
            drop_req = self.hooks.get(FaultPoint.DROP_REQUEST)
            if drop_req and drop_req(name):
                log.debug("fault: dropping the request of %s", name)
                raise ConnectionResetError(
                    f"injected fault: {name} request dropped")
            dup = self.hooks.get(FaultPoint.DUPLICATE)
            if dup and dup(name):
                log.debug("fault: duplicating %s", name)
                fn(*args, **kwargs)  # the first delivery's reply is dropped
            out = fn(*args, **kwargs)
            drop_reply = self.hooks.get(FaultPoint.DROP_REPLY)
            if drop_reply and drop_reply(name):
                log.debug("fault: dropping the reply of %s", name)
                raise ConnectionResetError(
                    f"injected fault: {name} reply dropped")
            return out

        call.__name__ = name
        return call


def seeded_schedule(seed: int, rates: dict[str, float],
                    only: tuple[str, ...] = ()) -> dict[str, Callable]:
    """Hooks that fire with the given probability a point, from one seeded
    random stream (DELAY's draws scale a 0-50 ms sleep); ``only`` limits
    them to the named methods (empty: all).  One (seed, rates) pair names
    one fault interleaving a call sequence."""
    rng = random.Random(seed)

    def mk(point: str, rate: float) -> Callable:
        def hook(ctx: str):
            if only and ctx not in only:
                return 0
            draw = rng.random()
            if draw >= rate:
                return 0
            if point == FaultPoint.DELAY:
                return 0.05 * draw / max(rate, 1e-9)
            return 1

        return hook

    return {point: mk(point, rate) for point, rate in rates.items()}
