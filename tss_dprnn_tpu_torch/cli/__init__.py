"""Entry points of the port: ``generate_manifests``, ``train`` and ``test``."""
