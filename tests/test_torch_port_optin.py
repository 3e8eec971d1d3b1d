"""The port's counterparts of the JAX package's opt-in scan kernels and its
test-only stacked-scan entries, against the JAX entries in Pallas interpret
mode on the CPU:

- the dense mode of the fused kernel (``bilstm2_dense_forward``) and the
  batch-major twin (``bilstm2_forward_bm``), with the switches that route a
  model through them (``TSS_FUSED_DENSE=1``, ``TSS_BM=1``) in
  ``ops/rnn.py`` and ``models/dprnn.py``;
- ``lstm_scan`` and ``bilstm_fused`` (``_lstm_kernel``, the latter in its
  ``reverse_dir1`` mode) and ``lstm_scan_v2`` / ``bilstm_v2``
  (``_lstm_manual_kernel``, whose bf16 stream rounds at more points).

On a CPU tensor each entry runs its plain PyTorch version, so these tests
hold those versions against the TPU kernels' functions. T = 10 divides the
TPU entries' unroll, T = 11 makes them pad time; R = 5 pads their 8-row
tiles. Tolerances: 1e-5 absolute for fp32 forwards (sums in another order at
F = H = 16); 2^-7 (one bf16 ulp of values in [1, 2)) for the bf16 manual-DMA
scan; 3e-4 for gradients (the JAX package's own bar for the fused dense
path); 60 dB for models. The CUDA kernels are held against the plain
versions on the card by the ``cuda`` tests at the end (run there with
``python -m pytest --noconftest -m cuda tests/test_torch_port_optin.py``:
that machine has no JAX) and by chip_smoke.py."""

import csv
import functools

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch.ops import bilstm2 as port2
from tss_dprnn_tpu_torch.ops import lstm as port
from tss_dprnn_tpu_torch.ops import rnn as port_rnn

TOL = dict(atol=1e-5, rtol=0)
F = H = 16
FO = 8
SWITCHES = ("TSS_FUSED_DENSE", "TSS_BM")


@pytest.fixture
def interpret(monkeypatch):
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _weights(rng, D=2, F=F, H=H, bf16=False):
    """(w_ih [D, F, 4H], b [D, 4H], w_hh [D, H, 4H]) as numpy; with ``bf16``
    the matrices hold bf16 values, as both kernels consume them."""
    w_ih = (rng.standard_normal((D, F, 4 * H)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((D, 4 * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((D, H, 4 * H)) * 0.3).astype(np.float32)
    if bf16:
        w_ih, w_hh = (torch.from_numpy(w).bfloat16().float().numpy() for w in (w_ih, w_hh))
    return w_ih, b, w_hh


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("T", [10, 11])
def test_dense_forward_matches_pallas(rng, interpret, T):
    from tss_dprnn_tpu.ops import pallas_lstm

    x = rng.standard_normal((24, T, F)).astype(np.float32)
    w_ih, b, w_hh = _weights(rng)
    wo = (rng.standard_normal((2, H, FO)) * 0.3).astype(np.float32)
    want = pallas_lstm.bilstm2_dense_forward(x, w_ih, b, w_hh, wo)
    before = port2.launch_count()
    got = port2.bilstm2_dense_forward(*_t(x, w_ih, b, w_hh, wo))
    assert port2.launch_count() == before  # a CPU tensor runs the plain version
    for g, w in zip(got, want):
        assert g.shape == (24, T, FO)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("T", [16, 11])
def test_bm_forward_matches_pallas(rng, interpret, T):
    """T = 16 fills the TPU kernel's 8-step blocks, T = 11 pads the last."""
    from tss_dprnn_tpu.ops import pallas_lstm

    x = rng.standard_normal((24, T, F)).astype(np.float32)
    w_ih, b, w_hh = _weights(rng)
    want = pallas_lstm.bilstm2_forward_bm(x, w_ih, b, w_hh)
    got = port2.bilstm2_forward_bm(*_t(x, w_ih, b, w_hh))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("T", [10, 11])
@pytest.mark.parametrize("entry", ["lstm_scan", "lstm_scan_v2"])
def test_stacked_scans_match_pallas(rng, interpret, entry, T):
    """Stacked directions, each on its own input: lstm_scan_pallas and the
    manual-DMA lstm_scan_pallas_v2 (which pads T to its 10-step chunks)."""
    from tss_dprnn_tpu.ops import pallas_lstm

    x = rng.standard_normal((2, 5, T, F)).astype(np.float32)
    w_ih, b, w_hh = _weights(rng)
    jax_entry = {"lstm_scan": pallas_lstm.lstm_scan_pallas,
                 "lstm_scan_v2": pallas_lstm.lstm_scan_pallas_v2}[entry]
    want = np.asarray(jax_entry(x, w_ih, w_hh, b))
    got = getattr(port, entry)(*_t(x, w_ih, w_hh, b))
    assert got.shape == (2, 5, T, H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("T", [10, 11])
@pytest.mark.parametrize("entry", ["bilstm_fused", "bilstm_v2"])
def test_shared_input_bilstms_match_pallas(rng, interpret, entry, T):
    """Two directions on one input, direction 1 reversed inside the kernel:
    bilstm_pallas_fused (``reverse_dir1``) and bilstm_pallas_v2."""
    from tss_dprnn_tpu.ops import pallas_lstm

    x = rng.standard_normal((5, T, F)).astype(np.float32)
    w_ih, b, w_hh = _weights(rng)
    jax_entry = {"bilstm_fused": pallas_lstm.bilstm_pallas_fused,
                 "bilstm_v2": pallas_lstm.bilstm_pallas_v2}[entry]
    want = np.asarray(jax_entry(x, w_ih, w_hh, b))
    got = getattr(port, entry)(*_t(x, w_ih, w_hh, b))
    assert got.shape == (5, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same function as the fused bidirectional kernel's, concatenated
    ref = torch.cat(port2.bilstm2_reference(*_t(x, w_ih, b, w_hh)), dim=-1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_lstm_scan_v2_bf16_rounds_as_the_tpu_kernel(rng, interpret):
    """bf16 streams: the manual-DMA kernel's source rounds the gates, each
    operation of the activations, i * g and tanh(c) too. The plain version
    agrees with the JAX entry within 2^-7 and differs from the h-only
    rounding of ``lstm_reference``. Neither reproduces the JAX run bit for
    bit: XLA on the CPU drops two of the source's roundings (f's last
    operation and i * g, each widened to fp32 right after), so the test also
    asks that the plain version match many more of its elements exactly
    (about 60 % here) than ``lstm_reference`` does (about 36 %)."""
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import pallas_lstm

    x = torch.from_numpy(rng.standard_normal((2, 5, 11, F)).astype(np.float32)).bfloat16()
    w_ih, b, w_hh = _weights(rng, bf16=True)
    want = pallas_lstm.lstm_scan_pallas_v2(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                           w_ih, w_hh, b)
    want = np.asarray(want.astype(jnp.float32))
    got = port.lstm_scan_v2(x, *_t(w_ih, w_hh, b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -7, rtol=0)
    h_only = port.lstm_reference(x, *_t(w_ih, b, w_hh)).float().numpy()
    assert (h_only != got.float().numpy()).mean() > 0.5
    assert (got.float().numpy() == want).mean() > (h_only == want).mean() + 0.15


def _jax_directions(w_ih, b, w_hh):
    from tss_dprnn_tpu.ops import rnn as jax_rnn

    return [jax_rnn.LSTMWeights(w_ih[d], w_hh[d], b[d]) for d in (0, 1)]


def test_split_dense_grad_matches_jax(rng, interpret, monkeypatch):
    """``lstm_split_dense`` with TSS_FUSED_DENSE=1: forward and gradients of
    :class:`BiLSTM2Dense` against jax.grad of the JAX entry on its Pallas
    lane (``_recurrence3_dense``'s custom VJP)."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.ops import rnn as jax_rnn

    monkeypatch.setenv("TSS_FUSED_DENSE", "1")
    x = rng.standard_normal((24, 10, F)).astype(np.float32)
    w_ih, b, w_hh = _weights(rng)
    kernel = (rng.standard_normal((2 * H, FO)) * 0.3).astype(np.float32)

    def jax_loss(x, w_ih, b, w_hh, kernel):
        fwd, bwd = _jax_directions(w_ih, b, w_hh)
        return jnp.sum(jnp.square(jax_rnn.lstm_split_dense(x, fwd, bwd, kernel)))

    with jax_rnn.lstm_backend("pallas"):  # the backward reads the backend too
        want_loss, want = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
            x, w_ih, b, w_hh, kernel)
    leaves = [t.clone().requires_grad_() for t in _t(x, w_ih, b, w_hh, kernel)]
    out = port_rnn.lstm_split_dense(leaves[0], tuple(leaves[1:4]), leaves[4].reshape(2, H, FO))
    loss = out.square().sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, t, w in zip(("x", "w_ih", "b", "w_hh", "kernel"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=3e-4, rtol=3e-4,
                                   err_msg=name)


@pytest.mark.parametrize("switch", [None, *SWITCHES])
def test_split_dense_routes_by_switch(rng, monkeypatch, switch):
    """Which plain version each switch reaches, with and without gradients:
    the dense mode (or ``BiLSTM2Dense``) for unmasked scans under
    TSS_FUSED_DENSE=1, the batch-major entry for unmasked inference under
    TSS_BM=1, the default entries otherwise; lengths always take the masked
    kernel. Every route gives the same numbers."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    if switch:
        monkeypatch.setenv(switch, "1")
    x, w_ih, b, w_hh = _t(rng.standard_normal((6, 7, F)).astype(np.float32), *_weights(rng))
    wo2 = torch.from_numpy((rng.standard_normal((2, H, FO)) * 0.3).astype(np.float32))
    stacked = (w_ih, b, w_hh)
    lens = torch.tensor([7, 3, 5, 1, 7, 2])
    called = []
    for mod, names in ((port_rnn, ("bilstm2_dense_forward", "bilstm2_forward_bm",
                                   "bilstm2_forward", "bilstm2_forward_masked")),):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, functools.partial(
                lambda fn, name, *a: called.append(name) or fn(*a), fn, name))
    with torch.no_grad():
        y = port_rnn.lstm_split_dense(x, stacked, wo2)
        port_rnn.lstm_split_dense(x, stacked, wo2, lens)
    want = {None: "bilstm2_forward", "TSS_FUSED_DENSE": "bilstm2_dense_forward",
            "TSS_BM": "bilstm2_forward_bm"}[switch]
    assert called == [want, "bilstm2_forward_masked"]
    o0, o1 = port2.bilstm2_reference(x, w_ih, b, w_hh)
    torch.testing.assert_close(y, o0 @ wo2[0] + o1 @ wo2[1], **TOL)
    leaf = x.clone().requires_grad_()
    y_grad = port_rnn.lstm_split_dense(leaf, stacked, wo2)
    # with gradients: the dense Function, or the default one (TSS_BM is inference only)
    fn = "BiLSTM2DenseBackward" if switch == "TSS_FUSED_DENSE" else "BiLSTM2Backward"
    assert fn in _graph(y_grad.grad_fn)
    torch.testing.assert_close(y_grad, y, **TOL)


def _graph(node, seen=None):
    """Names of the autograd nodes reachable from ``node``."""
    seen = set() if seen is None else seen
    if node is None or node in seen:
        return []
    seen.add(node)
    return [type(node).__name__] + [n for nxt, _ in node.next_functions
                                    for n in _graph(nxt, seen)]


# a small DPRNN-Spe-TasNet, one repeat, bucketed rows with lengths
SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln", activation_type="sigmoid", O=8, P=12,
             embeddings_size=8, num_spks=5, fusion_type="att")


def _snr_db(got, want):
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


@pytest.mark.parametrize("switch", SWITCHES)
def test_model_with_switch_matches_jax(interpret, monkeypatch, switch):
    """DPRNN-Spe-TasNet with chunk lengths under each switch against the JAX
    model on its Pallas lane with the same switch: the intra scans take the
    switched kernel and the inter scans the masked one, in both packages."""
    import jax

    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
    from tss_dprnn_tpu.ops import rnn as jax_rnn
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.utils.weights import state_dict_from_jax

    monkeypatch.setenv(switch, "1")
    rng = np.random.default_rng(5)
    lengths = np.array([200, 157, 121], np.int32)
    ref_len = np.array([150, 111, 90], np.float32)
    mix = rng.standard_normal((3, 200)).astype(np.float32)
    ref = rng.standard_normal((3, 150)).astype(np.float32)
    for i in range(3):
        mix[i, lengths[i]:] = 0
        ref[i, int(ref_len[i]):] = 0
    model = JaxDPRNNSpeTasNet(**SMALL)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), mix[:1], ref[:1], ref_len[:1])
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    with jax_rnn.lstm_backend("pallas"):
        # a fresh function, so no trace made under another switch is reused
        want_wav, want_logits = jax.jit(lambda v, *a: model.apply(v, *a))(
            variables, mix, ref, ref_len, lengths)
    port_model = DPRNNSpeTasNet(**SMALL).eval()
    port_model.load_state_dict(state_dict_from_jax(variables, "ln", 2, "att"), strict=True)
    with torch.inference_mode():
        wav, logits = port_model(*_t(mix, ref, ref_len, lengths))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=0)
    for i, n in enumerate(lengths):
        assert _snr_db(wav[i, :n].numpy(), np.asarray(want_wav)[i, :n]) >= 60.0


class _Utterances:
    """In-memory dataset: ds[i] -> (mix, target, reference, spk_idx)."""

    def __init__(self, seed, mix_lens, ref_lens):
        rng = np.random.default_rng(seed)
        self.items = []
        for n, nr in zip(mix_lens, ref_lens):
            target = rng.standard_normal(n).astype(np.float32)
            self.items.append((target + rng.standard_normal(n).astype(np.float32), target,
                               rng.standard_normal(nr).astype(np.float32),
                               int(rng.integers(0, 5))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it[0]) for it in self.items]


@pytest.mark.parametrize("switch", SWITCHES)
def test_inferencer_spe_with_switch_equals_default(tmp_path, monkeypatch, switch):
    """``InferencerSpe.run`` reads the switch at each call: with it on, every
    row's metrics equal the switch-off run's."""
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    ckpt = tmp_path / "model.pt"
    torch.save(init_weights_(DPRNNSpeTasNet(**SMALL), torch.Generator().manual_seed(0))
               .state_dict(), ckpt)
    ds = _Utterances(0, [301, 250, 420, 199], [260, 300, 190, 222])
    rows = {}
    for on in (False, True):
        if on:
            monkeypatch.setenv(switch, "1")
        out_dir = tmp_path / f"metrics_{on}"
        inf = InferencerSpe(DPRNNSpeTasNet(**SMALL), {
            "checkpoint_path": str(ckpt), "test_savedir": str(out_dir), "metrics": ["si_sdr"],
            "data": {"sample_rate": 8000}}, device="cpu")
        inf.run(ds, batch_size=2, n_buckets=2, bucket_multiple=100)
        with open(out_dir / "all_metrics.csv") as f:
            rows[on] = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    assert len(rows[True]) == len(ds)
    for got, want in zip(rows[True], rows[False]):
        assert got == pytest.approx(want, abs=1e-5)


# ---------------------------------------------------------------- on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _card_case(D=2, R=70, T=33, F=128, H=128, seed=0):
    """R not a multiple of the 16- or 32-row tiles, T not a multiple of the
    4-step slabs; weights at PyTorch's LSTM scale."""
    rng = np.random.default_rng(seed)
    k = H ** -0.5
    x = rng.standard_normal((D, R, T, F)).astype(np.float32)
    w = [(rng.uniform(-k, k, s)).astype(np.float32)
         for s in ((D, F, 4 * H), (D, 4 * H), (D, H, 4 * H))]
    return [t.cuda() for t in _t(x, *w)]


# bf16 kernel vs bf16 plain version: the two sum a gate in different orders,
# so a rounded value may differ by an ulp. With h the only rounded value a
# kernel sits near 80 dB and one that skips the rounding near 60 (PERF.md).
# The manual-DMA kernel rounds six times per unit and step: two valid
# summation orders then drift to 60-65 dB at the serving shapes, while the
# h-only rounding in its place scores 45 dB (scripts/port/v2_bf16_floor.py),
# so its bar is 55, as in chip_smoke.py.
BF16_SNR_DB = 70.0
V2_BF16_SNR_DB = 55.0


def _assert_kernel_close(got, want, dtype, snr_db=BF16_SNR_DB):
    """fp32: 1e-4 absolute. bf16 streams: 2^-7 and ``snr_db`` against the
    bf16 plain version."""
    assert got.dtype == want.dtype == dtype
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=1e-4 if dtype == torch.float32 else 2.0 ** -7,
                               rtol=0)
    if dtype == torch.bfloat16:
        snr = 10 * torch.log10(want.pow(2).sum() / (got - want).pow(2).sum().clamp_min(1e-30))
        assert snr >= snr_db


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Fo", [128, 64])
def test_dense_kernel_matches_reference_on_card(dtype, Fo):
    _needs_card()
    x, w_ih, b, w_hh = _card_case()
    wo2 = torch.rand(2, 128, Fo, device="cuda") * 0.2 - 0.1
    x = x[0].to(dtype)
    before = port2.bilstm2_dense_forward.launches
    got = port2.bilstm2_dense_forward(x, w_ih, b, w_hh, wo2)
    assert port2.bilstm2_dense_forward.launches == before + 1
    for g, r in zip(got, port2.bilstm2_dense_reference(x, w_ih, b, w_hh, wo2)):
        assert g.shape == (70, 33, Fo)
        _assert_kernel_close(g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_rejects_what_it_does_not_take(dtype):
    """The dense mode takes every Fo >= 1, as the JAX entry does: Fo wider
    than H (130) and no multiple of the product kernel's 4 or 8 (6) match the
    plain version. A wo2 that is not [2, H, Fo] is still refused before any
    launch."""
    _needs_card()
    x, w_ih, b, w_hh = _card_case(R=40, T=21)
    x = x[0].to(dtype)
    for Fo in (130, 6):  # wider than H; not a multiple of 4
        wo2 = torch.rand(2, 128, Fo, device="cuda") * 0.2 - 0.1
        before = port2.bilstm2_dense_forward.launches
        got = port2.bilstm2_dense_forward(x, w_ih, b, w_hh, wo2)
        assert port2.bilstm2_dense_forward.launches == before + 1
        for g, r in zip(got, port2.bilstm2_dense_reference(x, w_ih, b, w_hh, wo2)):
            assert g.shape == (40, 21, Fo)
            _assert_kernel_close(g, r, dtype)
    before = port2.launch_count()
    with pytest.raises(ValueError, match="wo2 must be"):
        port2.bilstm2_dense_forward(x, w_ih, b, w_hh, torch.zeros(2, 64, 8, device="cuda"))
    assert port2.launch_count() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [33, 32, 1])
def test_bm_kernel_matches_reference_on_card(dtype, T):
    _needs_card()
    x, w_ih, b, w_hh = _card_case(T=T)
    x = x[0].to(dtype)
    before = port2.bilstm2_forward_bm.launches
    got = port2.bilstm2_forward_bm(x, w_ih, b, w_hh)
    assert port2.bilstm2_forward_bm.launches == before + 1
    for g, r in zip(got, port2.bilstm2_bm_reference(x, w_ih, b, w_hh)):
        _assert_kernel_close(g, r, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["bilstm_fused", "bilstm_v2", "lstm_scan_v2", "lstm_scan"])
def test_stacked_scan_kernels_match_reference_on_card(dtype, entry):
    _needs_card()
    x, w_ih, b, w_hh = _card_case()
    if entry.startswith("bilstm"):
        x = x[0]
    fn = getattr(port, entry)
    plain = {"bilstm_fused": port.bilstm_fused_reference, "bilstm_v2": port.bilstm_v2_reference,
             "lstm_scan_v2": port.lstm_v2_reference,
             "lstm_scan": lambda x, w_ih, w_hh, b: port.lstm_reference(x, w_ih, b, w_hh)}[entry]
    x = x.to(dtype)
    before = fn.launches
    got = fn(x, w_ih, w_hh, b)
    assert fn.launches == before + 1
    _assert_kernel_close(got, plain(x, w_ih, w_hh, b), dtype,
                         V2_BF16_SNR_DB if entry.endswith("v2") else BF16_SNR_DB)


@pytest.mark.cuda
@pytest.mark.parametrize("switch", SWITCHES)
def test_switches_launch_their_kernels_on_card(monkeypatch, switch):
    """lstm_split_dense on the card: without gradients the switched kernel
    (and the masked one for lengths), with them the dense Function's
    residual and backward kernels under TSS_FUSED_DENSE=1; every route
    against the plain version."""
    _needs_card()
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(switch, "1")
    x, w_ih, b, w_hh = _card_case(R=40, T=21)
    x = x[0]
    wo2 = torch.rand(2, 128, 128, device="cuda") * 0.2 - 0.1
    lens = torch.randint(1, 22, (40,), device="cuda")
    stacked = (w_ih, b, w_hh)
    port2.reset_launch_counts()
    with torch.no_grad():
        y = port_rnn.lstm_split_dense(x, stacked, wo2)
        port_rnn.lstm_split_dense(x, stacked, wo2, lens)
    want = {"bilstm2_forward_masked": 1,
            "bilstm2_dense_forward" if switch == "TSS_FUSED_DENSE" else "bilstm2_forward_bm": 1}
    assert {e.__name__: e.launches for e in port2.ENTRIES if e.launches} == want
    o0, o1 = port2.bilstm2_reference(x, w_ih, b, w_hh)
    torch.testing.assert_close(y, o0 @ wo2[0] + o1 @ wo2[1], atol=1e-4, rtol=0)
    if switch == "TSS_FUSED_DENSE":
        leaves = [t.clone().requires_grad_() for t in (x, w_ih, b, w_hh, wo2)]
        port2.reset_launch_counts()
        port_rnn.lstm_split_dense(leaves[0], tuple(leaves[1:4]), leaves[4]).square().sum().backward()
        assert {e.__name__: e.launches for e in port2.ENTRIES if e.launches} == {
            "bilstm2_forward_resid": 1, "bilstm2_backward": 1}
        cpu = [t.detach().cpu().requires_grad_() for t in leaves]
        port_rnn.lstm_split_dense(cpu[0], tuple(cpu[1:4]), cpu[4]).square().sum().backward()
        for got, want in zip(leaves, cpu):
            torch.testing.assert_close(got.grad.cpu(), want.grad,
                                       atol=1e-4 * float(want.grad.abs().max()), rtol=0)
