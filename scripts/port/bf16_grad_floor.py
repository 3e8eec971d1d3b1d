"""How far a valid bf16 backward sits from the TPU kernel's, and how far one
without its bf16 rounding of dpre sits: the floor under the bf16 gradient
bars (``BF16_GRAD_SNR_DB`` in chip_smoke.py and
tests/test_torch_port_bf16_training.py).

    python scripts/port/bf16_grad_floor.py [--seeds 12]

CPU only. For each seed, the JAX package's Pallas entries in interpret mode
(bf16 streams) give the residual forward and the backward of the fused pair
(unmasked and masked) and of the stacked-direction scan (D = 1 and 2) at the
tests' shapes; the port's plain backward is fed the TPU kernel's own saved
streams (and the gates built from them), so only the backward's arithmetic
differs:

- ``port``: the port's bf16 backward (dpre rounded to bf16 before its
  products, db from the unrounded dpre, dx rounded per direction);
- ``no rounding``: the same backward in fp32 on the same bf16 values.

The TPU kernel recomputes the gates with XLA's exp and tanh, the port reads
them and applies torch's: a dpre within an ulp of a bf16 rounding boundary
can round the other way, and at these sizes that one flip moves dW by up to
a few 1e-4 of its max. Prints, per case and gradient, the worst and best
SNR over the seeds and the worst dW max |err| / max |ref|.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _snr_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=12)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from jax.experimental import pallas as pl

    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    from tss_dprnn_tpu.ops import pallas_lstm
    from tss_dprnn_tpu_torch.ops import bilstm2 as B2
    from tss_dprnn_tpu_torch.ops import lstm as L

    torch.set_num_threads(1)

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    def bf16(rng, shape, scale=1.0):  # (torch bf16, JAX bf16) of the same values
        t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()
        return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)

    def weights(rng, D, F, H):
        ws = [bf16(rng, s, sc) for s, sc in (((D, F, 4 * H), 0.3), ((D, 4 * H), 0.1),
                                             ((D, H, 4 * H), 0.3))]
        return [t.float() for t, _ in ws], [j for _, j in ws]

    def pair_case(rng, R, T, lens, F=16, H=32):
        x, xj = bf16(rng, (R, T, F))
        w, wj = weights(rng, 2, F, H)
        ln = None if lens is None else np.asarray(lens, np.int32)
        if ln is None:
            _, resid = pallas_lstm.bilstm2_forward_resid(xj, *wj)
        else:
            _, resid = pallas_lstm.bilstm2_forward_resid_masked(xj, ln, *wj)
        g0, _ = bf16(rng, (R, T, H))
        g1, g1j = bf16(rng, (R, T, H))
        if ln is not None:
            g0[torch.from_numpy(np.arange(T)[None, :] >= ln[:, None])] = 0
        g0j = jnp.asarray(g0.float().numpy(), jnp.bfloat16)
        if ln is None:
            want = pallas_lstm.bilstm2_backward(*resid, g0j, g1j, *wj)
        else:
            want = pallas_lstm.bilstm2_backward_masked(*resid, g0j, g1j, *wj, ln)
        streams = [torch.from_numpy(np.swapaxes(f32(s)[:T, :R], 0, 1)).bfloat16()
                   for s in resid[1:]]
        w_ih, b, w_hh = w
        pre = torch.stack([(x.float() @ w_ih[d] + hp.float() @ w_hh[d]) + b[d]
                           for d, hp in ((0, streams[0]), (1, streams[3]))], dim=2)
        rest = (*w,) if ln is None else (*w, torch.from_numpy(ln))
        run = B2.bilstm2_backward if ln is None else B2.bilstm2_backward_masked
        return run, x, (*streams, pre), (g0, g1), rest, want

    def stack_case(rng, D, R, T, F=16, H=32):
        x, xj = bf16(rng, (D, R, T, F))
        w, wj = weights(rng, D, F, H)
        _, xk, hp, cp, tc = pallas_lstm.lstm_forward_resid(xj, *wj)
        g, gj = bf16(rng, (D, R, T, H))
        want = pallas_lstm.lstm_backward(xk, hp, cp, tc, jnp.transpose(gj, (2, 0, 1, 3)), *wj)
        streams = [torch.from_numpy(np.swapaxes(f32(s)[:, :T, :R], 1, 2)).bfloat16()
                   for s in (hp, cp, tc)]
        w_ih, b, w_hh = w
        pre = (torch.einsum("drtf,dfg->drtg", x.float(), w_ih)
               + torch.einsum("drth,dhg->drtg", streams[0].float(), w_hh)) + b[:, None, None]
        return L.lstm_backward, x, (*streams, pre), (g,), tuple(w), want

    cases = {"pair R=11 T=12": lambda rng: pair_case(rng, 11, 12, None),
             "pair masked R=9 T=6": lambda rng: pair_case(rng, 9, 6, [6, 6, 5, 4, 3, 2, 1, 6, 2]),
             "stack D=1 R=13 T=12": lambda rng: stack_case(rng, 1, 13, 12),
             "stack D=2 R=7 T=10": lambda rng: stack_case(rng, 2, 7, 10)}
    names = ("dx", "dW_ih", "db", "dW_hh")
    for label, make in cases.items():
        snr = {k: {n: [] for n in names} for k in ("port", "no rounding")}
        rel = []
        for seed in range(args.seeds):
            run, x, resid, cots, rest, want = make(np.random.default_rng(seed))
            got = run(x, resid, *cots, *rest)
            flat = run(x.float(), tuple(t.float() for t in resid), *(c.float() for c in cots),
                       *rest)
            for tag, grads in (("port", got), ("no rounding", flat)):
                for n, a, b in zip(names, grads, want):
                    snr[tag][n].append(_snr_db(a.float().numpy(), f32(b)))
            rel.append(max(float(np.abs(a.numpy() - f32(b)).max() / np.abs(f32(b)).max())
                           for a, b in zip(got[1:], want[1:])))
        print(f"{label} ({args.seeds} seeds): port worst/best SNR "
              + ", ".join(f"{n} {min(snr['port'][n]):.1f}/{max(snr['port'][n]):.1f}"
                          for n in names)
              + f" dB, dW/db max|err|/max|ref| up to {max(rel):.2e}; no rounding best SNR "
              + ", ".join(f"{n} {max(snr['no rounding'][n]):.1f}" for n in names) + " dB",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
