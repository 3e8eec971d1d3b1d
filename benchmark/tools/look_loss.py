#!/usr/bin/env python3
"""A look at a training cell's loss gaps, seed by seed, on the card.

    python3 benchmark/tools/look_loss.py --workload <cell> --seeds 1,2,3

For each seed it runs the cell's set-up (the trainer's first steps on the
loader's first batches) and prints one JSON line:
- ``program_losses`` / ``reference_losses``: each step's loss of the trainer
  and of the reference following it;
- ``program_parts`` / ``reference_parts``: the first step's loss in its
  parts (SI-SDR and, for target speech separation, cross-entropy): the
  program's from a second trainer's first step on the same batch, the
  reference's from its own forward;
- ``rows``: per step, each row's negative SI-SDR on the reference (for blind
  separation, of each source permutation) and ``pit_margin``, the least gap
  between a row's best and second-best permutation, where a near tie can
  send the program and the reference different ways.
"""

import argparse
import itertools
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from benchmark.lib import harness  # noqa: E402
from benchmark.lib.registry import Registry  # noqa: E402
from benchmark.reference import dprnn as ref  # noqa: E402
from benchmark.reference import training as ref_training  # noqa: E402


def _rows(config: dict, p: dict, b: dict) -> dict:
    """The reference's per-row negative SI-SDR on batch ``b`` (and, with two
    sources, each permutation's and the least margin between them)."""
    m = config["model"]
    with torch.no_grad():
        if "target" in b:
            est, logits = ref.tss_forward(p, m, b["mix"], b["reference"], b["ref_len"], train=True)
            neg = ref_training.neg_sisdr(est, b["target"])
            ce = F.cross_entropy(logits, b["spk_idx"].long())
            return {"neg_sisdr": neg.tolist(), "sisdr_part": float(neg.mean()),
                    "ce_part": float(ce)}
        est = ref.bss_forward(p, m, b["mix"])
        src = b["sources"]
        perms = list(itertools.permutations(range(src.shape[1])))
        per = torch.stack([torch.stack([ref_training.neg_sisdr(est[:, i], src[:, j])
                                        for i, j in enumerate(q)]).mean(dim=0)
                           for q in perms], dim=-1)  # [B, perms]
        top2 = per.sort(dim=-1).values[:, :2]
        return {"per_perm": per.tolist(), "pit_margin": float((top2[:, 1] - top2[:, 0]).min())}


def look(reg: Registry, workload: str, seed: int, device: torch.device, override=None) -> dict:
    cell = reg.cell(workload)
    config, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    if override is not None:
        override(config, traffic)
    tcfg = config["training"]
    with tempfile.TemporaryDirectory() as scratch:
        loop = harness.make_loop(reg, config, traffic, seed, device, scratch)
        loop.setup(False)
        loop.free()
        want = loop._follow(False, loop.batches)
        second = loop.family.trainer(config, loop.state, device, scratch)
        loss, aux = second.train_step(loop.batches[0])
        parts = {"loss": float(loss), **{k: float(v) for k, v in aux.items() if v.ndim == 0}}
        del second
    dev = [{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}
           for b in loop.batches]
    params = {k: v.detach().clone() for k, v in loop.state.items()}
    leaves = [params[k].requires_grad_(True) for k in loop.trainable]
    adam = ref_training.Adam(leaves, tcfg["optimizer"]["lr"], tcfg["optimizer"]["weight_decay"])
    loss_fn = loop.family.reference_loss(config)
    rows = []
    with ref.precision(False):
        for b in dev:  # the reference's steps, as train_steps takes them
            rows.append(_rows(config, params, b))
            grads = list(torch.autograd.grad(loss_fn(params, b), leaves))
            ref_training.clip_(grads, tcfg["clip_norm"])
            adam.step(grads)
    return {"workload": workload, "seed": seed, "program_losses": loop.losses,
            "reference_losses": want["losses"], "program_parts": parts,
            "reference_parts": {k: v for k, v in rows[0].items() if k.endswith("_part")},
            "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    reg = Registry()
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(look(reg, args.workload, seed, torch.device("cuda", 0))), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
