"""Telemetry of the port: the metrics registry and span tracer (copies of
the reference's framework-free ``obs`` modules)."""
