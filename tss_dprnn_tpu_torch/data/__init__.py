"""Data layer of the port: WAV I/O (``wav``, ``native``), frozen manifests
(``manifest``, ``reference_compat``), the LibriMix datasets (``librimix``),
training and bucketed evaluation batches (``loader``) and resampling
(``resample``)."""
