"""Data layer of the port: bucketed evaluation batches."""
