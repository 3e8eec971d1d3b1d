"""tss_dprnn_tpu_torch — the PyTorch and CUDA port of ``tss_dprnn_tpu``.

Runs the four model families on an NVIDIA Hopper card, each served (masked,
bucketed, full-length inference) and trained (fixed crops or whole
utterances), in fp32 or the bf16 lane: DPRNN-Spe-TasNet target speech
separation with any of its five fusions, DPRNN-Spe-IRA-TasNet and
DPRNN-RawNet-TasNet (``inference.InferencerSpe`` / ``InferencerRawNet``,
``training.TrainerSpe`` / ``TrainerRawNet``), and DPRNN-TasNet blind source
separation (``inference.Inferencer``, ``training.Trainer``), with a
bidirectional or a one-direction (``bidirectional=False``) inter-chunk scan
and with LSTM, GRU or tanh-RNN cells. Module paths mirror the JAX
package's, so each port module sits under the same name as its
counterpart; the JAX package stays the reference the port is tested
against.

The port imports torch, numpy and the standard library only. Its
hand-written kernels are built with nvcc at first use: the fused
bidirectional LSTM scan, its serving scan, training forward and backward
(``ops/bilstm2.py`` + ``csrc/bilstm2_serve.cu``, ``csrc/bilstm2_resid.cu``,
``csrc/bilstm2_bwd.cu``, with the products of ``csrc/products.cu``), the
stacked-direction LSTM scan and its backward (``ops/lstm.py``: its three
forwards, the cell-state one among them, on the same products and serving or
training scans, the backward ``csrc/lstm_bwd.cu``), and the opt-in and
test-only scans, all on the serving route. The five serving entries are
torch operators (namespace ``tss_dprnn_tpu_torch``, registered on import of
``tss_dprnn_tpu_torch.ops``), so ``torch.export`` records them.
Entry points run on the card unless the caller passes ``device="cpu"``
(see :func:`tss_dprnn_tpu_torch.device.resolve_device`). The command-line
entry points, each with ``--device``: ``cli.generate_manifests``,
``cli.train`` and ``cli.test`` take the shipped YAML configs and LibriMix
data (``data/``), log through the log-only ``reporters.Reporter``, and score
STOI and PESQ on the host or, with ``device_metrics`` / ``device_pesq``, on
the card; ``cli.separate`` separates one WAV, full length or in windows
(``inference/long_audio.py``); ``cli.export_model`` writes a serving
artifact that ``inference.export.load_artifact`` runs without the model
code; ``cli.results_table`` renders ``final_metrics.json`` files.
``cli.train`` and ``cli.test`` scale over cards under ``torch.distributed.run``,
one process per card (``parallel``: DistributedDataParallel training with
BatchNorm on the global batch, evaluation in whole batches per process);
``parallel.make_mesh(data, model)`` adds the mesh's model axis to
``Trainer`` and ``Inferencer`` (each process holds its slices of the
matched weights and of Adam's moments).
"""

__version__ = "0.1.0"
