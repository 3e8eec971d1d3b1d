"""Model families, one module each, found by a configuration's ``family``."""
