"""Observability for the port: the metrics registry."""
