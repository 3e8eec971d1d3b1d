"""tss_dprnn_tpu_torch — the PyTorch and CUDA port of ``tss_dprnn_tpu``.

Runs two model families on an NVIDIA Hopper card, each served (masked,
bucketed, full-length inference) and trained (fixed crops): DPRNN-Spe-TasNet
target speech separation with any of its five fusions
(``inference.InferencerSpe``, ``training.TrainerSpe``) and DPRNN-TasNet
blind source separation (``inference.Inferencer``, ``training.Trainer``),
both with a bidirectional or a one-direction (``bidirectional=False``)
inter-chunk scan, and with LSTM, GRU or tanh-RNN cells. Module paths
mirror the JAX package's, so each port module sits under the same name as
its counterpart; the JAX package stays the reference the port is tested
against.

The port imports torch, numpy and the standard library only. Its
hand-written kernels are built with nvcc at first use: the fused
bidirectional LSTM scan, its serving scan, training forward and backward
(``ops/bilstm2.py`` + ``csrc/bilstm2_serve.cu``, ``csrc/bilstm2_resid.cu``,
``csrc/bilstm2_bwd.cu``, with the products of ``csrc/products.cu``), the
stacked-direction LSTM scan and its backward (``ops/lstm.py``: its three forwards,
the cell-state one among them, on the same products and serving or training
scans, the backward ``csrc/lstm_bwd.cu``), and the opt-in and
test-only scans, all on the serving route: the dense mode (its SplitDense
products on ``csrc/products.cu`` after the scan), the shared-input pair and
the batch-major and manual-DMA kernels' entries (their bf16 streams through
the bf16-operand product of ``csrc/products.cu``).
Entry points run on the card unless the caller passes ``device="cpu"``
(see :func:`tss_dprnn_tpu_torch.device.resolve_device`). The command-line
entry points (``cli.generate_manifests``, ``cli.train``, ``cli.test``, each
with ``--device``) take the shipped YAML configs and LibriMix data
(``data/``: WAV I/O, frozen manifests, the datasets), log through the
log-only ``reporters.Reporter``, and score STOI and PESQ on the host
(``ops/metrics.py``, ``ops/pesq.py``) or, with ``device_metrics`` /
``device_pesq``, on the card (``ops/stoi.py``, ``ops/pesq_device.py``).
"""

__version__ = "0.1.0"
