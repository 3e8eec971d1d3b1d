"""Traffic loops, one module each, found by a traffic mix's ``loop``."""
