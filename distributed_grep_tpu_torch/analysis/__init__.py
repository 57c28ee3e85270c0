"""Project static analysis: machine-checked invariants (rules.py), the
DGREP_* env-knob registry (knobs.py), the telemetry event registry
(events.py), and the ``analyze`` command (checker.py).  Constructs the
package must not hold -- a jax import, a plain leg behind a failed
kernel, a ctypes binding that disagrees with its C signature -- are
rejected at check time, not discovered on the card."""

from distributed_grep_tpu_torch.analysis.checker import run_analysis
from distributed_grep_tpu_torch.analysis.rules import RULES, Project, Violation

__all__ = ["run_analysis", "RULES", "Project", "Violation"]
