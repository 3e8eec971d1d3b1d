"""Operation and byte counts, one module per model family."""
