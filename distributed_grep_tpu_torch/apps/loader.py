"""Dynamic application loading (the reference's apps/loader.py).

An application is a Python module, addressed by dotted name
(``distributed_grep_tpu_torch.apps.wordcount``) or by file path
(``/path/to/my_app.py``), exposing

* ``map_fn`` / ``reduce_fn`` (or the names ``Map`` / ``Reduce``), and
  optionally
* ``configure(**options)`` (job options, e.g. the grep pattern),
  ``set_progress(fn)``, ``map_path_fn``, ``map_batch_fn`` (with
  ``map_batch_paths``), ``map_fused_fn``, ``reduce_stream_fn`` and
  ``reduce_is_identity``.

Every load executes a fresh instance of the module, so two jobs in one
process never share an application's module state.  ``from_module`` wraps
a module already imported, shared with whoever else holds it.
"""

from __future__ import annotations

import importlib.util
import itertools
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

from distributed_grep_tpu_torch.apps.base import KeyValue


@dataclass
class LoadedApplication:
    """A validated Map/Reduce function pair and its source module."""

    name: str
    map_fn: Callable[[str, bytes], list[KeyValue]]
    reduce_fn: Callable[[str, list[str]], str]
    module: Any
    # streaming entry: a local file path instead of its bytes
    map_path_fn: Callable[[str, str], list] | None = None
    # a batched split's (filename, contents) list in one call
    map_batch_fn: Callable[[list], list] | None = None
    # map_batch_fn also takes (filename, path) items: on a local data plane
    # the worker hands it paths (the corpus cache then serves warm windows
    # with no read)
    map_batch_paths: bool = False
    # streaming reduce over a value iterator; agrees with reduce_fn
    reduce_stream_fn: Callable[[str, Any], str] | None = None
    # the fused map (ops/fuse.py): map_fused_fn(items, participants)
    # scans the split once for K participants' queries and returns a
    # record list a participant, each equal to its own map_batch_fn's
    map_fused_fn: Callable[[list, list], list] | None = None

    def configure(self, **options: Any) -> None:
        hook = getattr(self.module, "configure", None)
        if hook is not None:
            hook(**options)

    def set_progress(self, fn: Any) -> bool:
        """Install (or clear, with None) the task's progress callback;
        whether the application reports progress."""
        hook = getattr(self.module, "set_progress", None)
        if hook is None:
            return False
        hook(fn)
        return True


_instance_counter = itertools.count()


def _fresh_instance_name(stem: str) -> str:
    return f"_dgrep_app_{stem}_{next(_instance_counter)}"


def _exec_fresh(name: str, origin) -> Any:
    spec = importlib.util.spec_from_file_location(name, origin)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load an application from {origin}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _import_by_path(path: str) -> Any:
    p = Path(path)
    return _exec_fresh(_fresh_instance_name(p.stem), p)


def _import_fresh_by_name(dotted: str) -> Any:
    spec = importlib.util.find_spec(dotted)
    if spec is None or spec.origin is None:
        raise ImportError(f"no module named {dotted!r}")
    return _exec_fresh(_fresh_instance_name(dotted.rsplit(".", 1)[-1]),
                       spec.origin)


def from_module(module: Any, name: str | None = None) -> LoadedApplication:
    """Validate ``module`` as an application and wrap it as it is."""
    name = name or getattr(module, "__name__", repr(module))
    map_fn = getattr(module, "map_fn", None) or getattr(module, "Map", None)
    reduce_fn = (getattr(module, "reduce_fn", None)
                 or getattr(module, "Reduce", None))
    if not callable(map_fn) or not callable(reduce_fn):
        raise TypeError(
            f"application {name!r} must expose callable map_fn/reduce_fn "
            f"(or Map/Reduce); got map={map_fn!r} reduce={reduce_fn!r}")

    def optional(attr: str):
        fn = getattr(module, attr, None)
        return fn if callable(fn) else None

    map_batch_fn = optional("map_batch_fn")
    return LoadedApplication(
        name=name, map_fn=map_fn, reduce_fn=reduce_fn, module=module,
        map_path_fn=optional("map_path_fn"), map_batch_fn=map_batch_fn,
        map_batch_paths=bool(getattr(module, "map_batch_paths", False))
        and map_batch_fn is not None,
        reduce_stream_fn=optional("reduce_stream_fn"),
        map_fused_fn=optional("map_fused_fn"))


def load_application(spec: str, **options: Any) -> LoadedApplication:
    """Load an application by dotted module name or .py file path, a fresh
    module instance each time; ``options`` go to its ``configure``."""
    if spec.endswith(".py") or "/" in spec:
        module = _import_by_path(spec)
    else:
        module = _import_fresh_by_name(spec)
    app = from_module(module, name=spec)
    if options:
        app.configure(**options)
    return app
