"""tss_dprnn_tpu_torch — the PyTorch and CUDA port of ``tss_dprnn_tpu``.

Runs the DPRNN-Spe-TasNet serving path (masked, bucketed, full-length
inference) and its training path (``training.TrainerSpe`` on fixed crops)
on an NVIDIA Hopper card. Module paths mirror the JAX package's, so each
port module sits under the same name as its counterpart; the JAX package
stays the reference the port is tested against.

The port imports torch, numpy and the standard library only. Its
hand-written kernels, the fused bidirectional LSTM scan and its backward
(``ops/bilstm2.py`` + ``csrc/bilstm2.cu``, ``csrc/bilstm2_bwd.cu``), are
built with nvcc at first use.
Entry points run on the card unless the caller passes ``device="cpu"``
(see :func:`tss_dprnn_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
