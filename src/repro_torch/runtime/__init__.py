"""The port's runtime layers: run telemetry and fault tolerance."""
