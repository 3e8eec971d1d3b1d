"""Metric readers, one module per metric (or per metric name before its
first dot): ``read(ctx) -> float or None``."""
