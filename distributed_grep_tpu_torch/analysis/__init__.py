"""Data the analysis tooling reads: the telemetry event registry."""
