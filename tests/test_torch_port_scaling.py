"""Data and model parallelism of the port (``tss_dprnn_tpu_torch.parallel``):
two and four processes under gloo against one process and the JAX package,
on the CPU.

The processes are ``tests/torch_port_ddp_worker.py``, started at once with
the environment ``torch.distributed.run`` gives its processes (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), each pinned to one torch
thread, at the small widths of ``tests/test_torch_port_training.py``: a
group of two, a group of four, and one process alone that runs the same
jobs. They run while this process takes the JAX trainer's eager step.

- The three loaders' per-process rows equal the JAX loaders' slicing for
  ``process_index`` / ``process_count`` given (W = 1, 2, 4), and under
  ``accum_steps`` every global micro-batch holds JAX's micro-batch rows.
- BatchNorm synced over two processes equals one BatchNorm on the whole
  batch: output, running statistics, input and weight gradients.
- TrainerSpe under DDP, global batch 4, three steps, ``accum_steps`` 1 and
  2: both processes' parameters bit for bit equal, and within 1e-6 of one
  process over the same global batches (fp32 sums over halves of the batch
  and the all-reduce's order); the first step within 1e-6 of the JAX
  trainer's eager step, the bar of ``test_trainer_spe_step_matches_jax``.
- One DDP step each of BSS, IRA and RawNet, ``Trainer.run`` (process 0
  alone writes; the checkpoint loads into one process's model; best loss,
  lr and ``is_metrics`` agree), and ``cli.test --data-parallel 2``
  (``proc0`` / ``proc1`` partition the utterances; the merged files equal
  one process's).
- At four processes: a TrainerSpe step, ``cli.test --data-parallel 4``, and
  the group left and joined again.
- ``jax.distributed`` config keys, and ``resolve_device`` under
  ``LOCAL_RANK``.
- The model axis (``make_mesh(data, model)``): the rule table marks the
  leaves and dimensions that JAX's ``param_shardings`` marks; TrainerSpe
  steps under a 1 x 2 mesh (the two processes of the group) and a 2 x 2 one
  (the four) against one process and the JAX trainer's first step, each
  process holding only its slices; a step of each other family and a bf16
  step at 1 x 2; a 1 x 2 checkpoint (with Adam's moments) loaded into one
  process and resumed under the mesh; ``InferencerSpe.run`` at 2 x 2
  against one process; ``make_mesh`` refusing layouts off the world size.

The ``cuda`` cases run BatchNorm and the TrainerSpe steps with both
processes on one card (gloo with CUDA tensors: NCCL takes one process per
card), also at 1 x 2, and, on a host with four cards, the four-process
step, ``cli.test --data-parallel 4`` and the re-join under NCCL, one
process per card, then a 2 x 2 TrainerSpe step and ``InferencerSpe.run``
with ``device_metrics`` and ``device_pesq`` under that mesh, as
``dryrun_multichip(4)`` runs them.
"""

import csv
import functools
import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tss_dprnn_tpu_torch import device as device_mod
from tss_dprnn_tpu_torch.data import loader
from tss_dprnn_tpu_torch.models.layers import BatchNorm
from tss_dprnn_tpu_torch.utils.checkpoint import load_model
from tss_dprnn_tpu_torch.utils.config import distributed_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_ddp_worker.py")
# the worker's module, by its path: another installed package may own the
# name ``tests``
_spec = importlib.util.spec_from_file_location("torch_port_ddp_worker", WORKER)
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)
# one process's parameters after 3 Adam steps (lr 1e-3) against two's: the
# gradients differ by fp32 summation order (halves of the batch, the
# all-reduce), ~1e-7 of the parameters here
PARAM_ATOL = 1e-6
# gradients against one process's, of each tensor's max |grad|, the bar of
# the JAX step comparison (test_trainer_spe_step_matches_jax); a tensor whose
# gradient peaks below NOISE of the model's largest is fp32 noise around a
# zero gradient (RawNet3's input-norm scale, the attention biases before its
# softmax over time) and is held to GRAD_RTOL of the model's largest
GRAD_RTOL = 1e-4
NOISE = 1e-4
# the TINY model of the cli tests (tests/test_torch_port_config_cli.py)
CLI_MODEL = dict(target="dprnn_spe_tasnet", input_size=8, feature_size=12, hidden_size=10,
                 chunk_length=40, kernel_size=2, hop_length=20, n_repeats=1, norm_type="ln",
                 O=8, P=12, embeddings_size=8, num_spks=8, fusion_type="att")
TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(out, jobs, device="cpu", world=2, cli_config=None, backend="gloo"):
    """The worker processes: ``world`` of them in one group, or with world
    None one process alone; ``device`` may name the process's rank
    (``cuda:{rank}``)."""
    port = _free_port()
    procs = []
    for rank in range(world or 1):
        # gloo on the loopback device: the address the host name resolves to
        # may not carry gloo's pairs between local processes
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(key, None)
        if world:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        argv = [sys.executable, WORKER, "--out", str(out), "--device", device.format(rank=rank),
                "--jobs", ",".join(jobs), "--backend", backend] + \
            (["--cli-config", cli_config] if cli_config else [])
        procs.append(subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs):
    """Every process's end; raises with its output when one failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed (rc={p.returncode}):\n{out[-6000:]}"


def _yaml(node, indent=0):
    """A config in the port reader's YAML subset (block mappings, flow lists)."""
    lines = []
    for key, value in node.items():
        if isinstance(value, dict):
            lines.append(" " * indent + f"{key}:")
            lines.append(_yaml(value, indent + 2))
        elif isinstance(value, list):
            lines.append(" " * indent + f"{key}: [{', '.join(map(str, value))}]")
        else:
            lines.append(" " * indent + f"{key}: {value}")
    return "\n".join(lines)


def _mini_librimix(root, n_mix, n_speakers, min_sec, max_sec, seed, sr=8000):
    """A two-speaker LibriMix-style split as ``tests/fixtures.py`` writes
    one (WAV files named ``<spk>-<chap>-<utt>_...``, a metadata CSV), with
    the port's WAV writer only, so that it also runs where neither pandas
    nor the JAX package is installed; returns the CSV's path."""
    from tss_dprnn_tpu_torch.data import wav

    rng = np.random.default_rng(seed)
    for d in ("mix_clean", "s1", "s2"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rows, counts = [], {}
    for i in range(n_mix):
        spks = rng.choice(n_speakers, size=2, replace=False) + 1000
        T = int(sr * rng.uniform(min_sec, max_sec))
        t = np.arange(T) / sr
        utts, srcs = [], []
        for j, spk in enumerate(spks):
            counts[spk] = counts.get(spk, 0) + 1
            utts.append(f"{spk}-{(j + 1) * 100 + i}-{counts[spk]:04d}")
            s = 0.4 * np.sin(2 * np.pi * rng.uniform(100, 800) * t + j) * rng.uniform(0.5, 1.0)
            srcs.append((s + 0.05 * rng.standard_normal(T)).astype(np.float32))
        stem = "_".join(utts)
        row = {"mixture_ID": stem, "mixture_path": os.path.join(root, "mix_clean", f"{stem}.wav"),
               "length": T}
        wav.write(row["mixture_path"], np.sum(srcs, axis=0).astype(np.float32), sr)
        for j, s in enumerate(srcs):
            row[f"source_{j + 1}_path"] = os.path.join(root, f"s{j + 1}", f"{stem}.wav")
            wav.write(row[f"source_{j + 1}_path"], s, sr)
        rows.append(row)
    path = os.path.join(root, "mixture_test_mix_clean.csv")
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return path


def _cli_inputs(root):
    """A LibriMix-style test split, a seeded checkpoint and a test config."""
    from tss_dprnn_tpu_torch.models.registry import build_model
    from tss_dprnn_tpu_torch.utils.weights import init_weights_

    csv_path = _mini_librimix(str(root / "corpus"), n_mix=10, n_speakers=4, min_sec=1.0,
                              max_sec=2.0, seed=4)
    ckpt = root / "tss.pt"
    torch.save(init_weights_(build_model(CLI_MODEL), torch.Generator().manual_seed(7))
               .state_dict(), ckpt)
    config = root / "test.yaml"
    config.write_text(_yaml({"data": {"test_path": csv_path, "sample_rate": 8000},
                             "model": CLI_MODEL, "checkpoint_path": str(ckpt),
                             "metrics": ["si_sdr", "stoi"],
                             "test_savedir": str(root / "unused")}) + "\n")
    return str(config)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Two processes in a gloo group and one alone, started together."""
    root = tmp_path_factory.mktemp("scaling")
    config = _cli_inputs(root)
    procs = (_start(root, ["bn", "steps", "families", "run", "cli", "mesh_steps",
                           "mesh_families", "mesh_bf16", "mesh_checkpoint"], cli_config=config)
             + _start(root, ["steps", "families", "run", "bf16"], world=None)
             + _start(root, ["step", "cli", "rejoin", "mesh_steps", "mesh_eval"], world=4,
                      cli_config=config))
    yield {"root": root, "procs": procs, "config": config}
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_first_step(launched):
    """The JAX trainer's first step on the first global batch, eagerly (its
    Pallas LSTM lane in interpret mode), as test_trainer_spe_step_matches_jax
    takes it, from the port's seeded weights: the parameters after it, in
    the port's state_dict layout. Taken while the workers run."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from tss_dprnn_tpu.models import DPRNNSpeTasNet as JaxDPRNNSpeTasNet
    from tss_dprnn_tpu.ops import rnn as jax_rnn
    from tss_dprnn_tpu.training.train_state import TrainState, make_optimizer
    from tss_dprnn_tpu.training.trainer_spe import TrainerSpe as JaxTrainerSpe
    from tss_dprnn_tpu.utils.torch_convert import convert_state_dict
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.utils.weights import init_weights_, state_dict_from_jax

    config = dict(worker.STEP_CONFIG, lstm_backend="pallas")
    batch = next(iter(loader.TrainLoader(worker.Crops(2, worker.GLOBAL_BATCH * worker.STEPS),
                                         worker.GLOBAL_BATCH, loader.collate_spe, seed=3,
                                         prefetch=0, process_index=0, process_count=1)))
    seeded = init_weights_(DPRNNSpeTasNet(**worker.TINY), torch.Generator().manual_seed(0))
    variables = convert_state_dict(seeded.state_dict())
    jtrainer = JaxTrainerSpe(JaxDPRNNSpeTasNet(**worker.TINY),
                             dict(config, new_checkpoints_path=str(launched["root"] / "j")))
    tx = make_optimizer(1e-3, 1e-2, 5.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        with jax_rnn.lstm_backend("pallas"):
            loss, new_bs, _ = jtrainer._forward_loss(
                {"params": params, "batch_stats": state.batch_stats}, jbatch, train=True)
        return loss, new_bs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        (_, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    after = state.apply_gradients(grads)
    return state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": after.params, "batch_stats": new_bs}), "ln", 2, "att")


@pytest.fixture(scope="module")
def results(launched, jax_first_step):
    """The workers' outputs by job and world: {job: {"2": [rank 0, rank 1],
    "4": [rank 0 .. rank 3], "1": one process}} (JAX's step taken first,
    while they run)."""
    _wait(launched["procs"])
    root = launched["root"]

    def load(job, tag):
        return torch.load(root / f"{job}_{tag}.pt", weights_only=False)

    out = {job: {"2": [load(job, f"rank{r}of2") for r in range(2)]}
           for job in ("bn", "steps", "families", "run", "cli", "mesh_steps", "mesh_families",
                       "mesh_bf16", "mesh_checkpoint")}
    for job in ("steps", "families", "run", "bf16"):
        out.setdefault(job, {})["1"] = load(job, "rank0of1")
    for job in ("step", "cli", "rejoin", "mesh_steps", "mesh_eval"):
        out.setdefault(job, {})["4"] = [load(job, f"rank{r}of4") for r in range(4)]
    return dict(out, root=root, config=launched["config"])


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _close(got, want, atol, what, counters=True):
    """Every float entry within ``atol``; BatchNorm's step counters equal
    (``counters``: the JAX package keeps none)."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert not counters or torch.equal(got[k], w), f"{what}: {k}"
            continue
        torch.testing.assert_close(got[k], w, atol=atol, rtol=0, msg=f"{what}: {k}")


def _grads_close(got, want, what):
    assert set(got) == set(want), what
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        peak = float(w.abs().max())
        bar = GRAD_RTOL * (peak if peak >= NOISE * top else top)
        torch.testing.assert_close(got[k], w, atol=bar, rtol=0, msg=f"{what}: {k}")


# ----------------------------------------------------------------- loaders

class _Indexed:
    """ds[i] carries i in every array: (mix, target, reference, spk_idx)."""

    def __init__(self, n):
        self.n = n
        self.lens = [int(40 + (7 * i) % 50) for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.full(self.lens[i], float(i), np.float32)
        return x, x, np.full(5, float(i), np.float32), i % 3

    def lengths(self):
        return self.lens


def _rows(batch):
    return batch["mix"][:, 0].astype(int).tolist()


def _jax_loaders():
    from tss_dprnn_tpu.data import loader as jloader

    return jloader


@pytest.mark.parametrize("world", [1, 2, 4])
def test_loader_rows_equal_jax_process_slicing(world):
    """Each process's rows of every batch are the JAX loaders' for the same
    process_index / process_count: TrainLoader and VarLenTrainLoader slice
    every global batch, BucketedEvalLoader takes whole batches plan[i::n];
    len() is the same on every process."""
    jl = _jax_loaders()
    ds = _Indexed(37)
    collate = loader.make_collate_spe_eval()
    jcollate = jl.make_collate_spe_eval()
    for rank in range(world):
        kw = dict(process_index=rank, process_count=world)
        for shuffle in (True, False):
            got = loader.TrainLoader(ds, 8, loader.collate_spe, shuffle=shuffle, seed=5,
                                     prefetch=0, **kw)
            want = jl.TrainLoader(ds, 8, jl.collate_spe, shuffle=shuffle, seed=5, prefetch=0,
                                  **kw)
            for epoch in (0, 1):
                got.set_epoch(epoch)
                want.set_epoch(epoch)
                assert [b.tolist() for b in got._index_batches()] == \
                    [b.tolist() for b in want._index_batches()]
            assert len(got) == len(want) == 37 // 8
        got = loader.VarLenTrainLoader(ds, 4, collate, ds.lengths(), seed=2, n_buckets=3,
                                       multiple=20, prefetch=0, **kw)
        want = jl.VarLenTrainLoader(ds, 4, jcollate, ds.lengths(), seed=2, n_buckets=3,
                                    multiple=20, prefetch=0, **kw)
        pairs = list(zip(got, want))
        assert len(pairs) == len(got) == len(want) > 0
        for g, w in pairs:
            assert _rows(g) == _rows(w) and g["mix"].shape == w["mix"].shape
            assert g["lengths"].tolist() == w["lengths"].tolist()
        got = loader.BucketedEvalLoader(ds, 3, collate, ds.lengths(), n_buckets=3, multiple=20,
                                        **kw)
        want = jl.BucketedEvalLoader(ds, 3, jcollate, ds.lengths(), n_buckets=3, multiple=20,
                                     prefetch=0, **kw)
        assert [(b, list(i)) for b, i in got.batch_plan()] == \
            [(b, list(i)) for b, i in want._batch_plan()]
    with pytest.raises(ValueError, match="global batch_size 6 must divide by process_count 4"):
        loader.TrainLoader(ds, 6, loader.collate_spe, process_index=0, process_count=4)


@pytest.mark.parametrize("world", [2, 4])
def test_accumulation_micro_batches_hold_jax_rows(world):
    """Under accum_steps n each process holds its share of every global
    micro-batch; the trainer's k-th local micro-batch, concatenated over
    the processes in rank order, is the JAX trainer's micro-batch k (rows
    [k m, (k+1) m) of the global batch)."""
    jl = _jax_loaders()
    ds = _Indexed(50)
    n, B = 2, 4 * world
    m = B // n
    whole = jl.TrainLoader(ds, B, jl.collate_spe, seed=9, prefetch=0, process_index=0,
                           process_count=1)._index_batches()
    mine = [loader.TrainLoader(ds, B, loader.collate_spe, seed=9, prefetch=0, process_index=r,
                               process_count=world, accum_steps=n)._index_batches()
            for r in range(world)]
    for i, batch in enumerate(whole):
        for k in range(n):
            joined = np.concatenate([mine[r][i][k * m // world:(k + 1) * m // world]
                                     for r in range(world)])
            assert joined.tolist() == batch[k * m:(k + 1) * m].tolist()
    collate = loader.make_collate_spe_eval()
    plan = loader.VarLenTrainLoader(ds, B, collate, ds.lengths(), seed=1, n_buckets=2,
                                    multiple=20, prefetch=0, process_index=0,
                                    process_count=1).batch_plan()
    shares = [list(loader.VarLenTrainLoader(ds, B, collate, ds.lengths(), seed=1, n_buckets=2,
                                            multiple=20, prefetch=0, process_index=r,
                                            process_count=world, accum_steps=n))
              for r in range(world)]
    for i, (_, chunk) in enumerate(plan):
        for k in range(n):
            joined = sum((_rows(shares[r][i])[k * m // world:(k + 1) * m // world]
                          for r in range(world)), [])
            assert joined == chunk[k * m:(k + 1) * m].tolist()
    with pytest.raises(ValueError, match="must divide by accum_steps 2 x process_count"):
        loader.TrainLoader(ds, 2 * world + world, loader.collate_spe, process_index=0,
                           process_count=world, accum_steps=2)


# --------------------------------------------------------------- BatchNorm

def _batchnorm_whole(shape, dev):
    """One process's BatchNorm over the whole batch: its output, running
    statistics and gradients."""
    x, cot, w, b = worker.bn_inputs(shape, dev)
    x = x.clone().requires_grad_(True)
    bn = BatchNorm(shape[-1]).to(dev)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    y = bn(x)
    (y * cot).sum().backward()
    return {"y": y.detach().cpu(), "x_grad": x.grad.cpu(), "w_grad": bn.weight.grad.cpu(),
            "b_grad": bn.bias.grad.cpu(), "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu()}


def _check_batchnorm(parts, dev):
    """Two processes' halves against one BatchNorm on the whole batch: the
    outputs and input gradients row for row; the running statistics; the
    weight and bias gradients, which DDP divides by the world size."""
    for i, shape in enumerate(worker.BN_SHAPES):
        want = _batchnorm_whole(shape, dev)
        got = [p[i] for p in parts]
        for key in ("y", "x_grad"):
            torch.testing.assert_close(torch.cat([g[key] for g in got]), want[key],
                                       atol=1e-5, rtol=1e-5, msg=key)
        for key in ("running_mean", "running_var", "w_grad", "b_grad"):
            assert torch.equal(got[0][key], got[1][key]), key
            scale = 0.5 if key.endswith("grad") else 1.0
            torch.testing.assert_close(got[0][key], want[key] * scale, atol=1e-5, rtol=1e-5,
                                       msg=key)


def test_synced_batchnorm_equals_one_batchnorm(results):
    _check_batchnorm(results["bn"]["2"], "cpu")


# ----------------------------------------------------------------- training

def _check_steps(runs, alone, accum):
    r0, r1 = runs
    for s0, s1, s in zip(r0[accum]["states"], r1[accum]["states"], alone[accum]["states"]):
        assert _equal(s0, s1), "the processes' parameters differ"
        _close(s0, s, PARAM_ATOL, f"accum_steps {accum} against one process")
    for g0, g in zip(r0[accum]["grads"], alone[accum]["grads"]):
        _grads_close(g0, g, f"accum_steps {accum} gradients")
    # each process's loss is its rows' mean; their mean is the global batch's
    first = (r0[accum]["losses"][0] + r1[accum]["losses"][0]) / 2
    np.testing.assert_allclose(first, alone[accum]["losses"][0], rtol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_spe_ddp_steps_match_one_process_and_jax(results, jax_first_step, accum):
    """Three TrainerSpe steps at global batch 4 under DDP: the two processes
    bit for bit equal, within PARAM_ATOL of one process over the same
    global batches (BatchNorm synced; under accumulation its statistics per
    global micro-batch); the first step against the JAX trainer's eager
    step at test_trainer_spe_step_matches_jax's 1e-6."""
    runs, alone = results["steps"]["2"], results["steps"]["1"]
    _check_steps(runs, alone, accum)
    if accum == 1:
        _close(runs[0][1]["states"][0], jax_first_step, 1e-6, "the first step against JAX",
               counters=False)


@pytest.mark.parametrize("family", ["bss", "ira", "rawnet"])
def test_ddp_step_of_each_family(results, family):
    """Two DDP steps of each other family: the processes bit for bit equal,
    the first step's loss (the processes' mean) and gradients those of one
    process. RawNet's DDP looks for unused parameters (``spk_encoder.bn1``
    is never run); its parameters are not compared after Adam, whose first
    steps move a parameter by ~lr whatever its gradient's size, and three
    of RawNet3's gradients are fp32 noise around 0 (NOISE)."""
    (r0, r1), alone = results["families"]["2"], results["families"]["1"]
    for s0, s1 in zip(r0[family]["states"], r1[family]["states"]):
        assert _equal(s0, s1)
        assert all(torch.isfinite(v).all() for v in s0.values() if v.is_floating_point())
    np.testing.assert_allclose((r0[family]["losses"][0] + r1[family]["losses"][0]) / 2,
                               alone[family]["losses"][0], rtol=1e-5)
    _grads_close(r0[family]["grads"][0], alone[family]["grads"][0], family)
    if family != "rawnet":
        for s0, s in zip(r0[family]["states"], alone[family]["states"]):
            _close(s0, s, PARAM_ATOL, family)


def test_trainer_spe_ddp_step_at_four_processes(results):
    """A TrainerSpe step at global batch 4 over four processes, one row
    each (BatchNorm synced over all four): the processes' parameters bit
    for bit equal, within PARAM_ATOL of one process's first step, and the
    mean of their losses the global batch's."""
    runs, alone = results["step"]["4"], results["steps"]["1"][1]
    for r in runs[1:]:
        assert _equal(r["states"][0], runs[0]["states"][0]), "the processes' parameters differ"
    _close(runs[0]["states"][0], alone["states"][0], PARAM_ATOL, "four processes against one")
    _grads_close(runs[0]["grads"][0], alone["grads"][0], "four processes' gradients")
    np.testing.assert_allclose(np.mean([r["losses"][0] for r in runs]), alone["losses"][0],
                               rtol=1e-5)


def test_trainer_run_writes_on_process_zero_and_processes_agree(results):
    """Trainer.run over two epochs: process 0 alone writes checkpoints, the
    same ones as one process; the written model loads into one process's
    model (no ``module.`` prefix) and is process 0's; both processes agree
    on best loss, lr and the epoch's metric sums and count, and these match
    one process's."""
    (r0, r1), alone = results["run"]["2"], results["run"]["1"]
    assert r0["written"] == alone["written"] == ["1_best", "2_best", "2_last"]
    assert r1["written"] == []
    for key in ("run", "lr", "metric_sums", "metric_cnt"):
        assert r0[key] == r1[key], key
    assert r0["metric_cnt"] == alone["metric_cnt"] == 8
    np.testing.assert_allclose(r0["run"]["best_loss"], alone["run"]["best_loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["metric_sums"]["si_sdr"], alone["metric_sums"]["si_sdr"],
                               rtol=1e-5)
    assert r0["lr"] == alone["lr"]
    assert _equal(r0["state"], r1["state"])
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet

    model = DPRNNSpeTasNet(**worker.TINY)
    ckpt = load_model(str(results["root"] / "run_2" / "2_last"), model)
    assert not any(k.startswith("module.") for k in ckpt["model"])
    assert _equal(model.state_dict(), r0["state"])
    _close(r0["state"], alone["state"], 1e-5, "Trainer.run against one process")


# --------------------------------------------------------------------- eval

def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _check_cli(results, world, device):
    """cli.test --data-parallel ``world``: proc0/ .. proc<W-1>/ partition the
    utterances, and the merged all_metrics.csv and final_metrics.json are
    one process's files at the same --batch-size; --data-parallel 3 in the
    world raises."""
    from tss_dprnn_tpu_torch.cli import test as test_cli

    root = results["root"]
    one = root / f"eval_one_{world}"
    final = test_cli.main(["--config", results["config"], "--mode", "tss_spe", "--device",
                           device, "--batch-size", str(worker.cli_batch(world)), "--n-buckets",
                           "2", "--set", f"test_savedir={one}"])
    dp = root / f"eval_{world}"
    parts = [{r["index"] for r in _csv(dp / f"proc{i}" / "all_metrics.csv")}
             for i in range(world)]
    assert all(parts) and sum(map(len, parts)) == len(set().union(*parts))
    assert sorted(set().union(*parts), key=int) == [r["index"] for r in
                                                    _csv(one / "all_metrics.csv")]
    assert (dp / "all_metrics.csv").read_text() == (one / "all_metrics.csv").read_text()
    assert json.loads((dp / "final_metrics.json").read_text()) == \
        json.loads((one / "final_metrics.json").read_text())
    assert all(r["final"] == final for r in results["cli"][str(world)])
    assert f"--data-parallel 3 but the process group has world size {world}" in \
        results["cli"][str(world)][0]["refused"]


def test_cli_test_data_parallel_equals_one_process(results):
    """cli.test --data-parallel 2 against one process (``_check_cli``)."""
    _check_cli(results, 2, "cpu")


def test_cli_test_data_parallel_at_four_processes(results):
    """cli.test --data-parallel 4 against one process (``_check_cli``)."""
    _check_cli(results, 4, "cpu")


def test_group_joined_again_after_leaving(results):
    """Four processes leave the group and join it again, two of them later
    than the other two: the new group reduces over all four (each join
    rendezvouses under its own keys; one that read the last group's
    addresses hung)."""
    assert results["rejoin"]["4"] == [6.0] * 4


# --------------------------------------------------------------- model axis

def _jax_variables(family):
    """The JAX model of ``family`` at the worker's widths, its variables'
    shapes (no values: ``jax.eval_shape`` of its init)."""
    import jax
    import jax.numpy as jnp

    from tss_dprnn_tpu.models import (DPRNNRawNetTasNet, DPRNNSpeIRATasNet, DPRNNSpeTasNet,
                                      DPRNNTasNet)

    T, ref = 240, (1200 if family == "rawnet" else 200)
    if family == "bss":
        model = DPRNNTasNet(**worker.BSS_TINY)
        args = (jnp.zeros((2, T)),)
    else:
        cls = {"tss": DPRNNSpeTasNet, "ira": DPRNNSpeIRATasNet,
               "rawnet": DPRNNRawNetTasNet}[family]
        model = cls(**worker.TINY, **(worker.RAW if family == "rawnet" else {}))
        args = (jnp.zeros((2, T)), jnp.zeros((2, ref)), jnp.full((2,), float(ref)))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))


@pytest.mark.parametrize("family", ["bss", "tss", "ira", "rawnet"])
def test_tp_rules_mark_the_leaves_jax_param_shardings_marks(family):
    """DEFAULT_TP_RULES against JAX's param_shardings on make_mesh(data=4,
    model=2): each JAX leaf is given the index along its sharded axis (zeros
    when replicated) and converted by state_dict_from_jax; the port's
    placements mark exactly the parameters whose converted values vary, on
    the dimension they vary along (the transposes included), and nothing
    else."""
    import jax

    from tss_dprnn_tpu.parallel import make_mesh as jax_make_mesh
    from tss_dprnn_tpu.parallel import param_shardings
    from tss_dprnn_tpu_torch import parallel
    from tss_dprnn_tpu_torch.utils.weights import state_dict_from_jax

    shapes = _jax_variables(family)
    specs = param_shardings(shapes["params"], jax_make_mesh(data=4, model=2))

    def indicator(leaf, sharding):
        spec = list(sharding.spec)
        axes = [leaf.ndim - len(spec) + i for i, a in enumerate(spec) if a == "model"]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * leaf.ndim
        shape[axes[0]] = leaf.shape[axes[0]]
        index = np.arange(1, leaf.shape[axes[0]] + 1, dtype=np.float32).reshape(shape)
        return np.broadcast_to(index, leaf.shape).copy()

    marked = {"params": jax.tree_util.tree_map(indicator, shapes["params"], specs),
              "batch_stats": jax.tree_util.tree_map(
                  lambda leaf: np.zeros(leaf.shape, np.float32), shapes.get("batch_stats", {}))}
    sd = state_dict_from_jax(marked, "ln", 2, "att")
    model = worker.FAMILIES[family][0]()
    got = parallel.param_placements(model, parallel.Mesh(4, 2, rank=0))
    want = {}
    for name, _ in model.named_parameters():
        t = sd[name]
        varies = [d for d in range(t.ndim) if t.shape[d] > 1 and
                  not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert len(varies) <= 1, name
        want[name] = varies[0] if varies else None
    assert got == want
    # the flagship's count at n_repeats 1: 16 LSTM tensors and 2 Denses a
    # block, and the three heads
    assert sum(d is not None for d in got.values()) == 21
    assert all(d is None for d in parallel.param_placements(
        model, parallel.Mesh(8, 1, rank=0)).values())


@pytest.mark.parametrize("n,parts", [(64, 2), (7, 2), (10, 4), (3, 4)])
def test_shard_bounds_cover_each_dimension_once(n, parts):
    """The parts tile [0, n) in order, as torch.tensor_split cuts it."""
    from tss_dprnn_tpu_torch.parallel import shard_bounds

    bounds = [shard_bounds(n, parts, i) for i in range(parts)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert [hi - lo for lo, hi in bounds] == [len(t) for t in torch.tensor_split(
        torch.arange(n), parts)]


def test_make_mesh_refuses_layouts_off_the_world_size(results):
    """data * model must equal the world size: one process alone, and a
    group of four asked for 3 x 2 or a model axis of 3."""
    from tss_dprnn_tpu_torch import parallel

    for kw in (dict(model=2), dict(data=2), dict(data=1, model=2)):
        with pytest.raises(ValueError, match="data \\* model must equal the world size"):
            parallel.make_mesh(**kw)
    assert parallel.make_mesh().shape == {"data": 1, "model": 1}
    for rank in results["mesh_steps"]["4"]:
        assert len(rank["refused"]) == 2
        assert all("the process group has 4" in m for m in rank["refused"])


def _mesh_runs(results, layout):
    world = {"1x2": "2", "2x2": "4"}[layout]
    return results["mesh_steps"][world]


def _check_mesh_steps(runs, alone, accum):
    """Every process's whole state bit for bit equal (the replicated
    parameters unsliced, the sliced ones gathered), within PARAM_ATOL of one
    process over the same global batches, the gradients at GRAD_RTOL; the
    data groups' mean loss the global batch's (process r holds data index
    r // 2's rows)."""
    for r in runs[1:]:
        for s, s0 in zip(r[accum]["states"], runs[0][accum]["states"]):
            assert _equal(s, s0), "the processes' parameters differ"
    for s, want in zip(runs[0][accum]["states"], alone["states"]):
        _close(s, want, PARAM_ATOL, f"{len(runs)} processes, accum_steps {accum}")
    _grads_close(runs[0][accum]["grads"][0], alone["grads"][0], "gradients")
    first = np.mean([runs[2 * d][accum]["losses"][0] for d in range(len(runs) // 2)])
    np.testing.assert_allclose(first, alone["losses"][0], rtol=1e-5)


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_steps_match_one_process_and_jax(results, jax_first_step, layout, accum):
    """Three TrainerSpe steps at global batch 4 under the mesh against one
    process (``_check_mesh_steps``); the first step within 1e-6 of the JAX
    trainer's eager step."""
    runs = _mesh_runs(results, layout)
    _check_mesh_steps(runs, results["steps"]["1"][accum], accum)
    if accum == 1:
        _close(runs[0][1]["states"][0], jax_first_step, 1e-6, "the first step against JAX",
               counters=False)


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_mesh_processes_hold_only_their_slices(results, layout):
    """Each process's sharded parameters and their Adam moments are its
    slice of the whole (half of the gate rows, of the Denses' input
    columns, of the heads' output rows); every other tensor whole."""
    runs = _mesh_runs(results, layout)
    whole = {k: tuple(v.shape) for k, v in runs[0][1]["states"][-1].items()}
    for rank, r in enumerate(runs):
        run = r[1]
        for name, dim in run["placements"].items():
            want = list(whole[name])
            if dim is not None:
                want[dim] //= 2
            assert run["held"][name] == run["moments"][name] == tuple(want), (rank, name)
        assert sum(d is not None for d in run["placements"].values()) == 21


@pytest.mark.parametrize("family", ["bss", "ira", "rawnet"])
def test_mesh_step_of_each_family(results, family):
    """Two steps of each other family at 1 x 2 against one process's: the
    processes bit for bit equal, the first loss and gradients one
    process's, the parameters within PARAM_ATOL (RawNet's as in
    test_ddp_step_of_each_family)."""
    (r0, r1), alone = results["mesh_families"]["2"], results["families"]["1"]
    for s0, s1 in zip(r0[family]["states"], r1[family]["states"]):
        assert _equal(s0, s1)
    np.testing.assert_allclose(r0[family]["losses"][0], alone[family]["losses"][0], rtol=1e-5)
    _grads_close(r0[family]["grads"][0], alone[family]["grads"][0], family)
    if family != "rawnet":
        for s0, s in zip(r0[family]["states"], alone[family]["states"]):
            _close(s0, s, PARAM_ATOL, family)


def test_mesh_bf16_step_matches_one_process(results):
    """A bf16 TrainerSpe step at 1 x 2 against one process's bf16 step."""
    (r0, r1), alone = results["mesh_bf16"]["2"], results["bf16"]["1"]
    assert _equal(r0["states"][0], r1["states"][0])
    np.testing.assert_allclose(r0["losses"][0], alone["losses"][0], rtol=1e-5)
    _grads_close(r0["grads"][0], alone["grads"][0], "bf16 gradients")
    _close(r0["states"][0], alone["states"][0], PARAM_ATOL, "bf16 against one process")


def test_mesh_checkpoint_is_whole_and_loads_across_layouts(results, tmp_path):
    """Trainer.run at 1 x 2 with save_optimizer: process 0's checkpoint holds
    whole tensors that load into one process's model and trainer; its Adam
    moments, cut as each process holds them, equal that process's bit for
    bit; a trainer resumed from it under the mesh holds what the run held;
    the demo mixture was separated."""
    from tss_dprnn_tpu_torch.models import DPRNNSpeTasNet
    from tss_dprnn_tpu_torch.parallel import shard_bounds
    from tss_dprnn_tpu_torch.training import TrainerSpe

    runs = results["mesh_checkpoint"]["2"]
    path = str(results["root"] / "mesh_run_2" / "1_last")
    trainer = TrainerSpe(DPRNNSpeTasNet(**worker.TINY), dict(
        worker.run_config(str(tmp_path)), checkpoint_path=path), device="cpu")
    ckpt = torch.load(path, weights_only=False)
    names = [n for n, _ in trainer.model.named_parameters()]
    state = ckpt["optimizer"]["state"]
    for rank, r in enumerate(runs):
        assert r["resumed_equal"]
        for i, name in enumerate(names):
            dim = r["placements"][name]
            for key in ("exp_avg", "exp_avg_sq"):
                whole = state[i][key]
                if dim is not None:
                    lo, hi = shard_bounds(whole.shape[dim], 2, rank)
                    whole = whole.narrow(dim, lo, hi - lo)
                assert torch.equal(whole, r["moments"][name][key]), (rank, name, key)
            want = ckpt["model"][name]
            if dim is not None:
                lo, hi = shard_bounds(want.shape[dim], 2, rank)
                want = want.narrow(dim, lo, hi - lo)
            assert torch.equal(r["params"][name], want), (rank, name)
    assert _equal(dict(trainer.model.state_dict()), ckpt["model"])
    est = runs[0]["estimated"]
    assert est is not None and np.isfinite(est).all() and runs[1]["estimated"] is None


def test_mesh_inferencer_rows_equal_one_process(results, tmp_path):
    """InferencerSpe.run under 2 x 2: the merged rows and means are one
    process's at the same batches, model index 0 of each data group wrote
    its proc<d>/ (process 0 also the merged files), model index 1 nothing."""
    runs = results["mesh_eval"]["4"]
    _check_mesh_eval(runs, results["root"] / "mesh_eval_4", results["config"], "cpu", tmp_path)


def _check_mesh_eval(runs, savedir, config, device, tmp_path, **extra):
    one = worker.mesh_eval(config, device, str(tmp_path / "one"), **extra)
    assert [r["written"] for r in runs] == [["proc0", "."], [], ["proc1"], []]
    assert (savedir / "all_metrics.csv").read_text() == \
        (tmp_path / "one" / "all_metrics.csv").read_text()
    assert all(r["final"] == one["final"] for r in runs)
    parts = [{r["index"] for r in _csv(savedir / f"proc{i}" / "all_metrics.csv")}
             for i in range(2)]
    assert all(parts) and not parts[0] & parts[1]


# ---------------------------------------------------------- set-up, devices

def test_jax_distributed_keys_map_to_the_group_arguments():
    assert distributed_args({}) is None
    assert distributed_args({"jax": {"compilation_cache_dir": "x"}}) is None
    assert distributed_args({"jax": {"distributed": True}}) == {
        "coordinator_address": None, "num_processes": None, "process_id": None}
    assert distributed_args({"jax": {"distributed": True, "coordinator_address": "h:1234",
                                     "num_processes": 4, "process_id": 3}}) == {
        "coordinator_address": "h:1234", "num_processes": 4, "process_id": 3}


def test_resolve_device_follows_local_rank(monkeypatch):
    """In a process group the card of LOCAL_RANK, or a raise when the host
    has fewer cards; an explicit device wins; no card raises."""
    current = []
    monkeypatch.setattr(device_mod, "is_distributed", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert device_mod.resolve_device() == torch.device("cuda", 1)
    assert current == [torch.device("cuda", 1)]
    assert device_mod.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 but the host has 2 CUDA card"):
        device_mod.resolve_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device()


# ----------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card_results(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tmp_path_factory.mktemp("scaling_card")
    procs = (_start(root, ["bn", "steps", "mesh_steps"], device="cuda:0")
             + _start(root, ["steps"], device="cuda:0", world=None))
    _wait(procs)

    def load(job, tag):
        return torch.load(root / f"{job}_{tag}.pt", weights_only=False)

    return {"bn": [load("bn", f"rank{r}of2") for r in range(2)],
            "steps": [load("steps", f"rank{r}of2") for r in range(2)],
            "mesh_steps": [load("mesh_steps", f"rank{r}of2") for r in range(2)],
            "alone": load("steps", "rank0of1")}


@pytest.mark.cuda
def test_card_synced_batchnorm_equals_one_batchnorm(card_results):
    """Two processes on one card (gloo, CUDA tensors) against one BatchNorm
    on the card."""
    _check_batchnorm(card_results["bn"], "cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
def test_card_trainer_spe_ddp_steps_match_one_process(card_results, accum):
    """The TrainerSpe steps with both processes on one card, through the
    kernels, against one process on the card."""
    _check_steps(card_results["steps"], card_results["alone"], accum)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
def test_card_mesh_steps_match_one_process(card_results, accum):
    """The TrainerSpe steps with both processes on one card as a 1 x 2 mesh
    (gloo: the weights gathered by all-reduce of CUDA tensors), through the
    kernels, against one process on the card."""
    _check_mesh_steps(card_results["mesh_steps"], card_results["alone"][accum], accum)


@pytest.fixture(scope="module")
def cards_results(tmp_path_factory):
    """Four processes on four cards under NCCL (the deployment: one process
    per card) and one process alone on the first card."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    root = tmp_path_factory.mktemp("scaling_cards")
    config = _cli_inputs(root)
    procs = (_start(root, ["step", "cli", "rejoin", "mesh_steps", "mesh_eval_device"],
                    device="cuda:{rank}", world=4, cli_config=config, backend="nccl")
             + _start(root, ["steps"], device="cuda:0", world=None))
    _wait(procs)

    def load(job, tag):
        return torch.load(root / f"{job}_{tag}.pt", weights_only=False)

    return {"step": {"4": [load("step", f"rank{r}of4") for r in range(4)]},
            "steps": {"1": load("steps", "rank0of1")},
            "cli": {"4": [load("cli", f"rank{r}of4") for r in range(4)]},
            "rejoin": {"4": [load("rejoin", f"rank{r}of4") for r in range(4)]},
            "mesh_steps": {"4": [load("mesh_steps", f"rank{r}of4") for r in range(4)]},
            "mesh_eval": {"4": [load("mesh_eval_device", f"rank{r}of4") for r in range(4)]},
            "root": root, "config": config}


@pytest.mark.cuda
def test_cards_trainer_spe_ddp_step_at_four_processes(cards_results):
    """The four-process TrainerSpe step on four cards (NCCL, the references'
    length through the gloo group beside it) against one process on a
    card."""
    test_trainer_spe_ddp_step_at_four_processes(cards_results)


@pytest.mark.cuda
def test_cards_cli_test_data_parallel_at_four_processes(cards_results):
    """cli.test --data-parallel 4 on four cards against one process on a
    card (the rows gathered through the gloo group)."""
    _check_cli(cards_results, 4, "cuda:0")


@pytest.mark.cuda
def test_cards_group_joined_again_after_leaving(cards_results):
    test_group_joined_again_after_leaving(cards_results)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
def test_cards_mesh_steps_at_two_by_two(cards_results, accum):
    """A 2 x 2 mesh on four cards (NCCL: the model groups' gathers and the
    data groups' means on the cards, host values through the gloo group
    beside them) against one process on a card, as dryrun_multichip(4)
    lays its mesh out."""
    _check_mesh_steps(cards_results["mesh_steps"]["4"], cards_results["steps"]["1"][accum],
                      accum)


@pytest.mark.cuda
def test_cards_mesh_inferencer_with_device_metrics(cards_results, tmp_path):
    """InferencerSpe.run under the 2 x 2 mesh with device_metrics and
    device_pesq against one process on a card (``_check_mesh_eval``)."""
    _check_mesh_eval(cards_results["mesh_eval"]["4"], cards_results["root"] /
                     "mesh_eval_device_4", cards_results["config"], "cuda:0", tmp_path,
                     **worker.DEVICE_LANE)
