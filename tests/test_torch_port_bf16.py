"""The port's bf16 lane (``model.dtype: bfloat16``) on the CPU, at small
widths, against the JAX package's bf16 lane (its models built with
``dtype=jnp.bfloat16``, LSTM scans on the Pallas lane in interpret mode).

- The registry takes the dtype spellings the JAX registry reads as float32
  or bfloat16 (and ``torch.bfloat16``) and refuses any other.
- The ops that round in bf16: the channel norm's bf16 route, the
  overlap-add, the split Dense and the LSTM bias sum, each within one bf16
  ulp of the JAX op on the same bf16 inputs (the norm masked and unmasked).
- The type at every module boundary equals JAX's: a block's output and the
  core's masks bf16, the model's outputs fp32, the parameters fp32.
- Every family's bf16 forward from ``state_dict_from_jax`` weights loaded
  with ``strict=True``: its SNR against JAX fp32 on the rows' valid region
  is no more than 1 dB below the SNR of JAX's own bf16 lane against JAX fp32
  (both printed). Of the five fusions only 'att' is held against JAX: the
  fusions run fp32 in both lanes, so each fusion's test is that the core's
  input is the fp32 lane's bit for bit (each fusion's fp32 forward is held
  against JAX by tests/test_torch_port_families.py).
- ``cli.test --set model.dtype=bfloat16`` on the CPU scores a checkpoint
  like the fp32 lane does.

The ``cuda`` case serves the tiny TSS and causal BSS models in bf16 on the
card against the same models on the CPU.
"""

import functools
import json

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # the card's machine has no JAX: only the cuda cases run there
    jax = jnp = None

from tss_dprnn_tpu_torch.models import DPRNNTasNet
from tss_dprnn_tpu_torch.models.dprnn import DPRNNBlock, DPRNNCore
from tss_dprnn_tpu_torch.models.layers import RNNCore, SplitDense
from tss_dprnn_tpu_torch.models.registry import build_model, model_dtype
from tss_dprnn_tpu_torch.ops import bilstm2, chunking, lstm as lstm_ops, norms
from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

SMALL = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
             hop_length=4, n_repeats=1, norm_type="ln", activation_type="sigmoid")
SPE = dict(SMALL, O=8, P=12, embeddings_size=8, num_spks=5)
RAW = dict(rawnet_C=32, rawnet_scale=4, rawnet_sinc_stride=16)
# the port's bf16 forward may trail JAX bf16's fidelity to JAX fp32 by this much
FIDELITY_SLACK_DB = 1.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: in the suite's parallel workers
    torch's idle pool threads spin against each other's and every small op
    waits on the scheduler (test_torch_port_device_metrics.py measures it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _snr_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16(a):
    """A numpy array rounded to bf16, as a torch bf16 tensor and a JAX one."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _within_one_ulp(got, want):
    """Every element of ``got`` within one bf16 ulp of ``want`` (the spacing
    of bf16 at |want|; exact zeros must match)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.abs(want)
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7), 0.0)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


# ------------------------------------------------------------------ registry

@pytest.mark.parametrize("spelling,want", [
    (None, None), ("float32", None), ("f4", None), ("single", None), (torch.float32, None),
    ("bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16)])
def test_registry_reads_the_dtype_spellings(spelling, want):
    assert model_dtype(spelling) is want
    if isinstance(spelling, str):
        assert jnp.dtype(spelling) == (jnp.bfloat16 if want else jnp.float32)
    model = build_model(dict(SPE, target="dprnn_spe_tasnet", dtype=spelling))
    assert model.separation.dtype is want
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("spelling", ["float16", "bf16", "float64", torch.float16, 16])
def test_registry_refuses_other_dtypes(spelling):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        build_model(dict(SMALL, target="dprnn_tasnet", dtype=spelling))


# ------------------------------------------------------------------- the ops

@pytest.mark.parametrize("masked", [False, True])
def test_channel_norm_bf16_matches_jax(rng, masked):
    from tss_dprnn_tpu.ops import norms as jax_norms

    x, xj = _bf16(rng.standard_normal((3, 5, 6, 16)) * 2 + 0.3)
    gamma = rng.standard_normal(16).astype(np.float32)
    beta = rng.standard_normal(16).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(5)[None, :] < np.array([5, 2, 4])[:, None]).astype(np.float32)
        mask = mask[:, :, None, None]
    want = jax_norms.global_channel_norm_cl(
        xj, jnp.asarray(gamma), jnp.asarray(beta), eps=norms.GROUPNORM_EPS,
        mask=None if mask is None else jnp.asarray(mask, jnp.bfloat16))
    got = norms.global_channel_norm_cl(
        x, torch.from_numpy(gamma), torch.from_numpy(beta), norms.GROUPNORM_EPS,
        None if mask is None else torch.from_numpy(mask).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got.float().numpy(), _f32(want))
    if masked:
        assert np.all(got.float().numpy()[np.broadcast_to(mask, got.shape) == 0] == 0)


@pytest.mark.parametrize("K,hop,L", [(8, 4, 37), (8, 2, 30), (6, 4, 25)])
def test_overlap_add_bf16_matches_jax(rng, K, hop, L):
    from tss_dprnn_tpu.ops import chunking as jax_chunking

    S = chunking.num_chunks(L, K, hop)
    x, xj = _bf16(rng.standard_normal((2, S, K, 5)))
    got = chunking.overlap_add_cl(x, L, hop)
    want = jax_chunking.overlap_add_cl(xj, L, hop)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got.float().numpy(), _f32(want))


def test_split_dense_and_bias_sum_bf16_match_jax(rng):
    """The block's Dense on a direction pair (``o0 @ k[:H] + o1 @ k[H:] +
    b``, each term rounded in bf16) and the LSTM bias ``b_ih + b_hh`` summed
    in bf16 after each is cast, as the JAX modules compute them."""
    from tss_dprnn_tpu.models.layers import SplitDense as JaxSplitDense

    H, N = 16, 12
    o0, o0j = _bf16(rng.standard_normal((4, 7, H)))
    o1, o1j = _bf16(rng.standard_normal((4, 7, H)))
    kernel = (rng.standard_normal((2 * H, N)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    jsd = JaxSplitDense(N, 2 * H, dtype=jnp.bfloat16)
    want = jsd.apply({"params": {"kernel": kernel, "bias": bias}}, o0j, o1j)
    sd = SplitDense(2 * H, N, dtype=torch.bfloat16)
    sd.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                        "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        wo2, b = sd.halves()
        got = o0 @ wo2[0] + o1 @ wo2[1] + b
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _within_one_ulp(got.float().numpy(), _f32(want))

    core = RNNCore(N, H, True, "LSTM", torch.bfloat16)
    b_ih = rng.standard_normal((2, 4 * H)).astype(np.float32)
    b_hh = rng.standard_normal((2, 4 * H)).astype(np.float32)
    with torch.no_grad():
        for d, sfx in enumerate(("", "_reverse")):
            for name in ("weight_ih", "weight_hh"):
                getattr(core.rnn, f"{name}_l0{sfx}").normal_()
            getattr(core.rnn, f"bias_ih_l0{sfx}").copy_(torch.from_numpy(b_ih[d]))
            getattr(core.rnn, f"bias_hh_l0{sfx}").copy_(torch.from_numpy(b_hh[d]))
    with torch.no_grad():
        w_ih2, b2, w_hh2 = core.stacked_weights()
    assert w_ih2.dtype == b2.dtype == w_hh2.dtype == torch.bfloat16
    want_b = _f32(jnp.asarray(b_ih, jnp.bfloat16) + jnp.asarray(b_hh, jnp.bfloat16))
    np.testing.assert_array_equal(b2.float().numpy(), want_b)


# --------------------------------------------------------- module boundaries

def test_module_boundary_types_equal_jax(interpret):
    """A block's output and the core's masks are bf16 in both packages."""
    from tss_dprnn_tpu.models.dprnn import DPRNNBlock as JaxBlock
    from tss_dprnn_tpu.models.dprnn import DPRNNCore as JaxCore
    from tss_dprnn_tpu.ops import rnn as jax_rnn

    rng = np.random.default_rng(0)
    xb, xj = _bf16(rng.standard_normal((2, 3, 8, 16)))
    h = rng.standard_normal((2, 30, 16)).astype(np.float32)
    core_kw = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8,
                   hop_length=4, n_repeats=1, norm_type="ln")
    jblock = JaxBlock(16, 16, "ln", dtype=jnp.bfloat16)
    jcore = JaxCore(**core_kw, dtype=jnp.bfloat16, remat=False)

    def run(key):
        with jax_rnn.lstm_backend("pallas"):
            out = jblock.apply(jblock.init(key, xj), xj, jnp.asarray([3, 2]))
            return out, jcore.apply(jcore.init(key, h), h)

    jout, jmasks = jax.eval_shape(run, jax.random.PRNGKey(0))  # traced, not compiled
    block = init_weights_(DPRNNBlock(16, 16, "ln", dtype=torch.bfloat16),
                          torch.Generator().manual_seed(0))
    core = init_weights_(DPRNNCore(**core_kw, dtype=torch.bfloat16),
                         torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = block(xb, torch.tensor([3, 2]))
        masks = core(torch.from_numpy(h))
    assert jout.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    assert jmasks.dtype == jnp.bfloat16 and masks.dtype == torch.bfloat16

    # the models' outputs: test_family_bf16_fidelity_matches_jax


# -------------------------------------------------------------- the families

def _bss_batch():
    rng = np.random.default_rng(21)
    lengths = np.array([200, 157, 121], np.int32)
    mix = rng.standard_normal((3, 200)).astype(np.float32)
    for b in range(3):
        mix[b, lengths[b]:] = 0
    return dict(args=(mix,), lengths=lengths)


def _spe_batch(raw: bool):
    rng = np.random.default_rng(22)
    lengths = np.array([200, 157, 121], np.int32)
    ref_len = np.array([1200, 900, 700] if raw else [150, 111, 90], np.float32)
    mix = rng.standard_normal((3, 200)).astype(np.float32)
    ref = rng.standard_normal((3, int(ref_len[0]))).astype(np.float32)
    for b in range(3):
        mix[b, lengths[b]:] = 0
        ref[b, int(ref_len[b]):] = 0
    return dict(args=(mix, ref, ref_len), lengths=lengths)


FAMILIES = {
    "bss-causal": ("dprnn_tasnet", dict(SMALL, bidirectional=False), {}),
    "bss-bidirectional": ("dprnn_tasnet", dict(SMALL, bidirectional=True), {}),
    "spe-att": ("dprnn_spe_tasnet", dict(SPE, fusion_type="att"), {}),
    "ira-share1": ("dprnn_spe_ira_tasnet", dict(SPE, fusion_type="att", n_repeats=2),
                   dict(share_blocks=1)),
    "rawnet": ("dprnn_rawnet_tasnet", dict(SPE, fusion_type="att"), RAW),
    "bss-gru": ("dprnn_tasnet", dict(SMALL, bidirectional=True, rnn_type="GRU"), {}),
}


def _jax_model(target, cfg, extra, dtype):
    from tss_dprnn_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY

    kw = dict(cfg, **extra)
    if target == "dprnn_spe_ira_tasnet":
        kw["remat"] = False
    return JAX_REGISTRY[target](**kw, dtype=dtype)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_bf16_fidelity_matches_jax(interpret, family):
    from tss_dprnn_tpu.ops import rnn as jax_rnn

    target, cfg, extra = FAMILIES[family]
    batch = (_bss_batch() if target == "dprnn_tasnet"
             else _spe_batch(target == "dprnn_rawnet_tasnet"))
    args, lengths = batch["args"], batch["lengths"]
    j32 = _jax_model(target, cfg, extra, None)
    j16 = _jax_model(target, cfg, extra, jnp.bfloat16)

    @jax.jit
    def run(key):  # one program: the weights, the fp32 (XLA) and the bf16 (Pallas) lanes
        variables = j32.init(key, *(a[:1] for a in args))
        with jax_rnn.lstm_backend("pallas"):
            out16 = j16.apply(variables, *args, lengths)
        return variables, j32.apply(variables, *args, lengths), out16

    variables, out32, out16 = run(jax.random.PRNGKey(4))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    if target != "dprnn_tasnet":
        assert out16[1].dtype == jnp.float32
        out32, out16 = out32[0], out16[0]
    assert out16.dtype == jnp.float32

    model = build_model(dict(cfg, target=target, dtype="bfloat16", **extra)).eval()
    kernel = cfg["kernel_size"]
    sd = state_dict_from_jax(variables, cfg["norm_type"], kernel, cfg.get("fusion_type", "att"))
    model.load_state_dict(sd, strict=True)
    before = bilstm2.launch_count(), lstm_ops.launch_count()
    with torch.inference_mode():
        got = model(*(torch.from_numpy(np.asarray(a)) for a in args), torch.from_numpy(lengths))
    assert (bilstm2.launch_count(), lstm_ops.launch_count()) == before  # plain versions on the CPU
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if target != "dprnn_tasnet":
        assert got[1].dtype == torch.float32
        got = got[0]
    assert got.dtype == torch.float32

    def valid(a):
        a = np.asarray(a, np.float64)
        return np.concatenate([a[b, ..., :n].ravel() for b, n in enumerate(lengths)])

    want32 = valid(out32)
    port_db = _snr_db(valid(got.numpy()), want32)
    jax_db = _snr_db(valid(_f32(out16)), want32)
    print(f"{family}: port bf16 vs JAX fp32 {port_db:.2f} dB, JAX bf16 vs JAX fp32 "
          f"{jax_db:.2f} dB")
    assert port_db >= jax_db - FIDELITY_SLACK_DB, (port_db, jax_db)


@pytest.mark.parametrize("fusion", ["att", "add", "cat", "mul", "film"])
def test_fusion_stays_fp32_in_the_bf16_lane(fusion):
    """The speaker branch, the bottleneck norm, every fusion and the
    bottleneck Dense run fp32 in the bf16 lane, as in JAX (its Fusion and
    bottleneck take no dtype, tss_dprnn_tpu/models/dprnn_spe.py:213-220): the
    core's input is the fp32 lane's bit for bit, so the lanes differ in the
    core alone, which the spe-att case of
    test_family_bf16_fidelity_matches_jax holds against JAX."""
    torch.manual_seed(0)
    batch = _spe_batch(raw=False)
    args = [torch.from_numpy(np.asarray(a)) for a in batch["args"]]
    lengths = torch.from_numpy(batch["lengths"])
    start = init_weights_(build_model(dict(SPE, target="dprnn_spe_tasnet", fusion_type=fusion)),
                          torch.Generator().manual_seed(5)).state_dict()
    core_in, outs = {}, {}
    for lane, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
        model = build_model(dict(SPE, target="dprnn_spe_tasnet", fusion_type=fusion,
                                 dtype=dtype)).eval()
        model.load_state_dict(start, strict=True)
        model.separation.bottleneck[1].register_forward_hook(
            lambda mod, inp, out, lane=lane: core_in.__setitem__(lane, out))
        with torch.inference_mode():
            outs[lane] = model(*args, lengths)
    assert core_in["bf16"].dtype == torch.float32
    assert torch.equal(core_in["bf16"], core_in["fp32"])
    assert torch.equal(outs["bf16"][1], outs["fp32"][1])  # the speaker logits
    est = outs["bf16"][0]
    assert est.dtype == torch.float32 and torch.isfinite(est).all()
    assert not torch.equal(est, outs["fp32"][0])  # the core did run in bf16


# ---------------------------------------------------------------------- cli


def test_cli_test_bf16_on_cpu(tmp_path):
    """``cli.test --set model.dtype=bfloat16`` scores a seeded BSS checkpoint
    on the CPU; its rows are finite and within 0.05 dB SI-SDR of the fp32
    lane's on the same checkpoint."""
    import csv

    import yaml

    from tests.fixtures import make_mini_librimix

    class SubsetDumper(yaml.SafeDumper):
        """Mappings in block style, lists in flow style: the reader's subset."""

    SubsetDumper.add_representer(
        dict, lambda d, v: d.represent_mapping("tag:yaml.org,2002:map", v, flow_style=False))
    SubsetDumper.add_representer(
        list, lambda d, v: d.represent_sequence("tag:yaml.org,2002:seq", v, flow_style=True))
    from tss_dprnn_tpu_torch.cli import test as test_cli

    csv_path = make_mini_librimix(str(tmp_path / "wavs"), n_mix=4, min_sec=1.0, max_sec=1.5)
    tiny = dict(input_size=8, feature_size=12, hidden_size=10, chunk_length=40, kernel_size=2,
                hop_length=20, n_repeats=1, norm_type="ln", target="dprnn_tasnet")
    ckpt = tmp_path / "bss.pt"
    torch.save(init_weights_(DPRNNTasNet(**{k: v for k, v in tiny.items() if k != "target"}),
                             torch.Generator().manual_seed(5)).state_dict(), ckpt)
    rows, finals = {}, {}
    for lane, extra in (("fp32", []), ("bf16", ["--set", "model.dtype=bfloat16"])):
        savedir = tmp_path / f"metrics_{lane}"
        cfg = dict(name="b", is_test=True, data=dict(test_path=csv_path, sample_rate=8000),
                   model=tiny, checkpoint_path=str(ckpt), metrics=["si_sdr"],
                   test_savedir=str(savedir))
        path = tmp_path / f"test_{lane}.yaml"
        path.write_text(yaml.dump(cfg, Dumper=SubsetDumper, width=1 << 20))
        finals[lane] = test_cli.main(["--config", str(path), "--mode", "bss", "--batch-size",
                                      "2", "--n-buckets", "2", "--device", "cpu", *extra])
        with open(savedir / "all_metrics.csv") as f:
            rows[lane] = list(csv.DictReader(f))
        assert set(json.loads((savedir / "final_metrics.json").read_text())) == {
            "si_sdr", "si_sdr_imp"}
    assert len(rows["bf16"]) == len(rows["fp32"]) == 4
    for a, b in zip(rows["bf16"], rows["fp32"]):
        assert np.isfinite(float(a["si_sdr"]))
        assert abs(float(a["si_sdr"]) - float(b["si_sdr"])) <= 0.05, (a, b)
    assert all(np.isfinite(v) for v in finals["bf16"].values())


# ----------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("target", ["dprnn_spe_tasnet", "dprnn_tasnet"])
def test_bf16_lane_card_vs_cpu(target):
    """The bf16 lane on the card (the bf16 kernels: widths 16 here, so no
    padding) against the same model's plain versions on the CPU, on the
    rows' valid region, >= 50 dB; a bf16 kernel launched on every scan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg = dict(SPE, fusion_type="att") if target == "dprnn_spe_tasnet" else dict(
        SMALL, bidirectional=False)
    model = init_weights_(build_model(dict(cfg, target=target, dtype="bfloat16")),
                          torch.Generator().manual_seed(8)).eval()
    batch = _spe_batch(False) if target == "dprnn_spe_tasnet" else _bss_batch()
    args = [torch.from_numpy(np.asarray(a)) for a in (*batch["args"], batch["lengths"])]
    with torch.inference_mode():
        want = model(*args)
        bilstm2.reset_launch_counts()
        lstm_ops.reset_launch_counts()
        got = model.cuda()(*(a.cuda() for a in args))
    launched = bilstm2.launch_count() + lstm_ops.launch_count()
    assert launched == 2 * cfg["n_repeats"]
    if target == "dprnn_spe_tasnet":
        got, want = got[0], want[0]
    for b, n in enumerate(batch["lengths"]):
        assert _snr_db(got[b, ..., :n].float().cpu().numpy(), want[b, ..., :n].numpy()) >= 50.0
