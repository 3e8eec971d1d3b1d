"""The harness: registry, loops, timing, trace reduction, the result line."""
