"""One process of the port's data- and model-parallel tests
(``tests/test_torch_port_scaling.py``); pytest does not collect it.

    RANK=r WORLD_SIZE=W LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_ddp_worker.py --out DIR --device cpu --jobs bn,spe

With ``WORLD_SIZE`` set the process joins the process group from that
environment, as a process that ``torch.distributed.run`` starts does,
through gloo (on the CPU, and for two processes sharing one card) or, with
``--backend nccl``, NCCL (one card per process); without
it, it is the one-process run the group is held against. It runs the named
jobs in order, pinned to one torch thread, and writes what each ended with
to ``DIR/<job>_rank<r>of<W>.pt``. The ``mesh_*`` jobs lay the group out as
a data x model mesh (``parallel.make_mesh``): 1 x 2 in a group of two, 2 x 2
in a group of four. The models, data and configs of the jobs
are defined here, so that the test builds its references from the same
ones. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tss_dprnn_tpu_torch import parallel  # noqa: E402
from tss_dprnn_tpu_torch.data import loader  # noqa: E402
from tss_dprnn_tpu_torch.models import (DPRNNRawNetTasNet, DPRNNSpeIRATasNet,  # noqa: E402
                                        DPRNNSpeTasNet, DPRNNTasNet)
from tss_dprnn_tpu_torch.models.layers import BatchNorm  # noqa: E402
from tss_dprnn_tpu_torch.training import Trainer, TrainerRawNet, TrainerSpe  # noqa: E402
from tss_dprnn_tpu_torch.utils.weights import init_weights_  # noqa: E402

# the TINY model of tests/test_torch_port_training.py, and its BSS half
BSS_TINY = dict(input_size=8, feature_size=16, hidden_size=16, chunk_length=8, kernel_size=2,
                hop_length=4, n_repeats=1, norm_type="ln", activation_type="sigmoid")
TINY = dict(BSS_TINY, O=8, P=12, embeddings_size=8, num_spks=5, fusion_type="att")
RAW = dict(rawnet_C=32, rawnet_scale=4, rawnet_sinc_stride=16)
# the optimizer of test_trainer_spe_step_matches_jax
STEP_CONFIG = {"optimizer": {"lr": 1e-3, "weight_decay": 1e-2}, "clip_norm": 5,
               "ce_gamma": 0.5, "print_freq": 1}
GLOBAL_BATCH = 4
STEPS = 3
# BatchNorm's inputs: the global batch's shape (rows split over the processes)
BN_SHAPES = ((6, 7, 5), (6, 5))
EPOCHS = 2
REJOIN_DELAY_S = 2.0
# the metric lane of dryrun_multichip's eval (__graft_entry__.py:270-273)
DEVICE_LANE = {"metrics": ["si_sdr", "stoi", "pesq"], "device_metrics": True,
               "device_pesq": True}


class Crops:
    """In-memory training items of fixed-length crops with references of
    ragged length: ``ds[i] -> (mix, target, reference, spk_idx)``, or with
    ``bss`` ``(mix, sources [2, T])``."""

    def __init__(self, seed: int, n: int, samples: int = 240, bss: bool = False,
                 ref_range=(150, 260)):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            target = rng.standard_normal(samples).astype(np.float32)
            other = rng.standard_normal(samples).astype(np.float32)
            ref = rng.standard_normal(int(rng.integers(*ref_range))).astype(np.float32)
            self.items.append((target + other, np.stack([target, other])) if bss else
                              (target + other, target, ref, int(rng.integers(0, 5))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


FAMILIES = {
    # name: (model, trainer, collate, the data's keywords); RawNet3's
    # convolutions want references of 1000 samples or more at 16 kHz
    "bss": (lambda **kw: DPRNNTasNet(**BSS_TINY, **kw), Trainer, loader.collate_bss,
            {"bss": True}),
    "tss": (lambda **kw: DPRNNSpeTasNet(**TINY, **kw), TrainerSpe, loader.collate_spe, {}),
    "ira": (lambda **kw: DPRNNSpeIRATasNet(**TINY, **kw), TrainerSpe, loader.collate_spe, {}),
    "rawnet": (lambda **kw: DPRNNRawNetTasNet(**TINY, **RAW, **kw), TrainerRawNet,
               lambda items: loader.collate_spe(items, resample_ref_to=16000),
               {"ref_range": (900, 1300)}),
}


def _state(model: torch.nn.Module):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _cpu(tensors):
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def _shares(mesh):
    """A loader's place on the data axis: the mesh's, else the group's."""
    return {} if mesh is None else dict(process_index=mesh.data_index, process_count=mesh.data)


def train_steps(family: str, device, ckpt_dir: str, accum_steps: int = 1,
                steps: int = STEPS, seed: int = 0, batches: int = None, mesh=None,
                dtype=None):
    """``steps`` train steps of ``family`` over the same global batches of
    GLOBAL_BATCH rows on every process, each process on its rows of the
    data axis (the data holds ``batches`` global batches, ``steps`` by
    default: its size keys the shuffle); returns the model's state after
    each step (whole tensors under a model axis), each step's gradients
    (averaged over the processes, clipped; whole) and each step's loss as
    this process computed it. Under a model axis also what this process
    holds: its parameters' and Adam moments' shapes after the last step."""
    make, trainer_cls, collate, data = FAMILIES[family]
    model = init_weights_(make(**({} if dtype is None else {"dtype": dtype})),
                          torch.Generator().manual_seed(seed))
    trainer = trainer_cls(model, dict(STEP_CONFIG, accum_steps=accum_steps,
                                      new_checkpoints_path=ckpt_dir), device=device, mesh=mesh)
    data = Crops(2, GLOBAL_BATCH * (batches or steps), **data)
    states, grads, losses = [], [], []
    for _, batch in zip(range(steps), loader.TrainLoader(data, GLOBAL_BATCH, collate, seed=3,
                                                         prefetch=0, accum_steps=accum_steps,
                                                         **_shares(mesh))):
        loss, _ = trainer.train_step(batch)
        states.append(_cpu(trainer.full_state_dict()))
        grad = {k: p.grad for k, p in trainer.model.named_parameters() if p.grad is not None}
        if trainer.shards is not None:
            grad.update(trainer.shards.gather(grad))
        grads.append(_cpu(grad))
        losses.append(float(loss))
    out = {"states": states, "grads": grads, "losses": losses}
    if trainer.shards is not None:
        moments = trainer.optimizer.adam.state
        out["held"] = {k: tuple(p.shape) for k, p in trainer.model.named_parameters()}
        out["moments"] = {k: tuple(moments[p]["exp_avg"].shape)
                          for k, p in trainer.model.named_parameters() if moments[p]}
        out["placements"] = trainer.shards.placements
    return out


def run_config(ckpt_dir: str):
    return {"optimizer": {"lr": 1e-3, "weight_decay": 1e-5}, "clip_norm": 5, "print_freq": 1,
            "new_checkpoints_path": ckpt_dir, "save_optimizer": True, "is_metrics": True,
            "metrics": ["si_sdr"], "lr_scheduler": {"factor": 0.5, "patience": 0}}


def trainer_run(device, ckpt_dir: str):
    """``TrainerSpe.run`` for EPOCHS epochs; returns what this process saw:
    the checkpoints it wrote, its run counters, lr, last epoch's metric sums
    and count, and the final weights."""
    model = init_weights_(DPRNNSpeTasNet(**TINY), torch.Generator().manual_seed(1))
    trainer = TrainerSpe(model, run_config(ckpt_dir), device=device)
    written, save = [], trainer.ckpt.save

    def recorded(epoch, payload, best=False):
        written.append(os.path.basename(save(epoch, payload, best=best)))
        return written[-1]

    trainer.ckpt.save = recorded
    trainer.run(loader.TrainLoader(Crops(0, 8), GLOBAL_BATCH, loader.collate_spe, seed=3,
                                   prefetch=0),
                loader.TrainLoader(Crops(9, 4), GLOBAL_BATCH, loader.collate_spe,
                                   shuffle=False, prefetch=0),
                EPOCHS, early_stop=10)
    return {"written": written, "run": dict(trainer._run_counters),
            "lr": trainer.optimizer.learning_rate, "metric_sums": dict(trainer._metric_sums),
            "metric_cnt": trainer._metric_cnt, "state": _state(trainer.model)}


def bn_inputs(shape, device):
    """BatchNorm's global input, cotangent, weight and bias, from a seed."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(*shape, generator=g) * 2 + 0.5
    cot = torch.randn(*shape, generator=g)
    w, b = torch.randn(shape[-1], generator=g), torch.randn(shape[-1], generator=g)
    return [t.to(device) for t in (x, cot, w, b)]


def batchnorm_step(shape, device, rank: int, world: int):
    """One training-mode BatchNorm forward and backward on this process's
    rows of the global batch, under DDP in a process group: the output, the
    running statistics, and the input, weight and bias gradients."""
    x, cot, w, b = bn_inputs(shape, device)
    rows = slice(rank * shape[0] // world, (rank + 1) * shape[0] // world)
    x = x[rows].clone().requires_grad_(True)
    bn = BatchNorm(shape[-1]).to(device)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    net = bn
    if parallel.is_distributed():
        net = torch.nn.parallel.DistributedDataParallel(
            bn, device_ids=[torch.device(device).index] if torch.device(device).type == "cuda"
            else None, broadcast_buffers=False)
    y = net(x)
    (y * cot[rows]).sum().backward()
    return {"y": y.detach().cpu(), "x_grad": x.grad.cpu(), "w_grad": bn.weight.grad.cpu(),
            "b_grad": bn.bias.grad.cpu(), "running_mean": bn.running_mean.cpu(),
            "running_var": bn.running_var.cpu()}


def cli_batch(world: int) -> int:
    """cli.test's --batch-size in a world (it must divide by the world)."""
    return max(2, world)


def cli_test(config: str, device: str, world: int, savedir: str):
    """``cli.test`` over the world (``--data-parallel`` W) into ``savedir``;
    in a group also ``--data-parallel 3``, which must raise: its message."""
    from tss_dprnn_tpu_torch.cli import test as test_cli

    argv = ["--config", config, "--mode", "tss_spe", "--device", device, "--batch-size",
            str(cli_batch(world)), "--n-buckets", "2", "--set", f"test_savedir={savedir}"]
    out = {"final": test_cli.main(argv + ["--data-parallel", str(world)])}
    if world > 1:
        try:
            test_cli.main(argv + ["--data-parallel", "3"])
        except ValueError as exc:
            out["refused"] = str(exc)
        else:
            raise AssertionError(f"--data-parallel 3 ran in a world of {world}")
    return out


def rejoin(device: str, rank: int, world: int):
    """Leave the group and join it again from the same environment, the
    upper half of the processes later than the lower (as after uneven work;
    a join that read the keys of the group before hung here): the sum of
    the ranks over the new group."""
    parallel.leave_group()
    if rank >= world // 2:
        time.sleep(REJOIN_DELAY_S)
    parallel.join_group(None, device=device)
    t = torch.tensor([float(rank)], device=device)
    torch.distributed.all_reduce(t)
    return float(t)


def mesh_refusals():
    """What ``make_mesh`` says to layouts that do not cover the group."""
    out = []
    for kw in (dict(data=3, model=2), dict(model=3)):
        try:
            parallel.make_mesh(**kw)
        except ValueError as exc:
            out.append(str(exc))
        else:
            raise AssertionError(f"make_mesh({kw}) covered a world of {parallel.process_count()}")
    return out


def mesh_checkpoint(device, out: str, mesh):
    """``TrainerSpe.run`` for one epoch (one step) under the mesh with
    ``save_optimizer`` and a demo mixture, then a trainer of other weights
    resumed from its last checkpoint under the same mesh: what this process
    held after the run (parameters and Adam moments by name), whether the
    resumed trainer holds them bit for bit, and the mixture's estimate."""
    def trainer(seed, **extra):
        model = init_weights_(DPRNNSpeTasNet(**TINY), torch.Generator().manual_seed(seed))
        return TrainerSpe(model, dict(run_config(out), **extra), device=device, mesh=mesh,
                          eval_mixtures=mixtures)

    item = Crops(4, 1)[0]
    mixtures = {"0": {"mix": item[0], "reference": item[2]}}
    first = trainer(1)
    first.run(loader.TrainLoader(Crops(0, GLOBAL_BATCH), GLOBAL_BATCH, loader.collate_spe,
                                 seed=3, prefetch=0, **_shares(mesh)),
              loader.TrainLoader(Crops(9, GLOBAL_BATCH), GLOBAL_BATCH, loader.collate_spe,
                                 shuffle=False, prefetch=0, **_shares(mesh)),
              1, early_stop=10)

    def held(t):
        state = t.optimizer.adam.state
        return ({k: p.detach().cpu().clone() for k, p in t.model.named_parameters()},
                {k: {m: state[p][m].cpu().clone() for m in ("exp_avg", "exp_avg_sq")}
                 for k, p in t.model.named_parameters()})

    params, moments = held(first)
    again = held(trainer(5, checkpoint_path=os.path.join(out, "1_last")))
    return {"params": params, "moments": moments, "placements": first.shards.placements,
            "resumed_equal": _same(again[0], params) and
            all(_same(again[1][k], v) for k, v in moments.items()),
            "estimated": mixtures["0"].get("estimated")}


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def mesh_eval(config: str, device, savedir: str, mesh=None, **extra):
    """``InferencerSpe.run`` of the cli config's test split and checkpoint
    under ``mesh`` (batches of 2, 2 buckets) into ``savedir``: its final
    metrics and, by this process, the directories it wrote files into
    (relative to ``savedir``)."""
    from tss_dprnn_tpu_torch.cli.common import dataset_for
    from tss_dprnn_tpu_torch.inference import InferencerSpe
    from tss_dprnn_tpu_torch.models.registry import build_model
    from tss_dprnn_tpu_torch.utils.config import load_config, model_config

    cfg = dict(load_config(config), test_savedir=savedir, **extra)
    inf = InferencerSpe(build_model(model_config(cfg)), cfg, device=device, mesh=mesh)
    written, save = [], inf._save_result

    def recorded(rows, where=None):
        written.append(os.path.relpath(where or savedir, savedir))
        return save(rows, where)

    inf._save_result = recorded
    final = inf.run(dataset_for(cfg, "test", True), batch_size=2, n_buckets=2)
    return {"final": final, "written": written}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--jobs", required=True, help="comma-separated: bn, steps, step, families, "
                                                  "bf16, run, cli, rejoin, mesh_steps, "
                                                  "mesh_families, mesh_bf16, mesh_checkpoint, "
                                                  "mesh_eval, mesh_eval_device")
    ap.add_argument("--cli-config", default=None)
    ap.add_argument("--backend", default="gloo", help="gloo, or nccl with one card per process")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if "WORLD_SIZE" in os.environ:
        parallel.initialize_distributed(backend=args.backend, device=args.device)
    rank, world = parallel.process_index(), parallel.process_count()
    tag = f"rank{rank}of{world}"
    ckpts = os.path.join(args.out, f"ckpt_{world}")
    mesh = None
    for job in args.jobs.split(","):
        if job.startswith("mesh_") and mesh is None:
            # made at the first mesh job: after a rejoin, in the new group
            mesh = parallel.make_mesh(model=2)
        if job == "bn":
            out = [batchnorm_step(s, args.device, rank, world) for s in BN_SHAPES]
        elif job == "steps":
            out = {n: train_steps("tss", args.device, ckpts, accum_steps=n) for n in (1, 2)}
        elif job == "step":
            out = train_steps("tss", args.device, ckpts, steps=1, batches=STEPS)
        elif job == "families":
            out = {f: train_steps(f, args.device, ckpts, steps=2)
                   for f in ("bss", "ira", "rawnet")}
        elif job == "run":
            out = trainer_run(args.device, os.path.join(args.out, f"run_{world}"))
        elif job == "cli":
            out = cli_test(args.cli_config, args.device, world,
                           os.path.join(args.out, f"eval_{world}"))
        elif job == "rejoin":
            out = rejoin(args.device, rank, world)
        elif job == "bf16":
            out = train_steps("tss", args.device, ckpts, steps=1, batches=STEPS,
                              dtype=torch.bfloat16)
        elif job == "mesh_steps":
            out = {n: train_steps("tss", args.device, ckpts, accum_steps=n, mesh=mesh)
                   for n in (1, 2)}
            out["refused"] = mesh_refusals()
        elif job == "mesh_families":
            out = {f: train_steps(f, args.device, ckpts, steps=2, mesh=mesh)
                   for f in ("bss", "ira", "rawnet")}
        elif job == "mesh_bf16":
            out = train_steps("tss", args.device, ckpts, steps=1, batches=STEPS,
                              dtype=torch.bfloat16, mesh=mesh)
        elif job == "mesh_checkpoint":
            out = mesh_checkpoint(args.device, os.path.join(args.out, f"mesh_run_{world}"), mesh)
        elif job in ("mesh_eval", "mesh_eval_device"):
            extra = {} if job == "mesh_eval" else DEVICE_LANE
            out = mesh_eval(args.cli_config, args.device,
                            os.path.join(args.out, f"{job}_{world}"), mesh, **extra)
        else:
            raise ValueError(f"unknown job {job!r}")
        torch.save(out, os.path.join(args.out, f"{job}_{tag}.pt"))
    if parallel.is_distributed():
        parallel.leave_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
