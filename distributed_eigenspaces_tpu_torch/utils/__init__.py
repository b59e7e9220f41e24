"""Host-side utilities of the port: fault types, telemetry, log lines."""
