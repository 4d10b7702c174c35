"""Telemetry of the port: the metrics registry serving reports through."""
