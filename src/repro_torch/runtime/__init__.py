"""The port's runtime layers: run telemetry, fault tolerance and elastic
restarts."""
