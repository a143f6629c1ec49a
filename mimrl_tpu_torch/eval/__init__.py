"""Metrics and the serving path."""
