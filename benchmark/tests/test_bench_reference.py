"""The plain reference agrees with the program at tiny widths on the CPU:
forwards unpadded, a padded masked batch row by row, and a training step's
loss and gradients with padded references and BatchNorm on batch
statistics."""

import copy

import numpy as np
import pytest
import torch
from conftest import TINY_MODEL

from benchmark.lib import audio, port
from benchmark.lib.registry import Registry
from benchmark.lib.weights import seeded_state
from benchmark.reference import dprnn as ref
from benchmark.reference import training as ref_training

REG = Registry()
SPE = REG.family("dprnn_spe_tasnet")
BSS = REG.family("dprnn_tasnet")


def _config(name):
    config = copy.deepcopy(REG.config(name))
    for k, v in TINY_MODEL.items():
        if k in config["model"]:
            config["model"][k] = v
    return config


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def tss():
    config = _config("dprnn_spe_att")
    state = seeded_state(port.template(config), 2**31 + 77)
    return config, state, port.model(config, state, torch.device("cpu")).eval()


def _requests(seed, n=3, mix_seconds=(0.05, 0.2)):
    return audio.Requests(audio.Source(seed), mix_seconds, [0.05, 0.2], n, 8000)


def test_tss_forward_unpadded(tss):
    config, state, model = tss
    item = SPE.item(config, _requests(3), 1)
    mix, _, aux, _ = item
    mix_t, aux_t = torch.from_numpy(mix)[None], torch.from_numpy(aux)[None]
    aux_len = torch.tensor([float(len(aux))])
    with torch.no_grad():
        est, logits = model(mix_t, aux_t, aux_len)
        want, want_logits = ref.tss_forward(state, config["model"], mix_t, aux_t, aux_len)
        served = SPE.reference_estimate(state, config, item, torch.device("cpu"))
    assert _rel(est, want) < 1e-5 and _rel(logits, want_logits) < 1e-5
    assert torch.equal(served, want[0])


def test_padded_masked_batch_equals_each_request_alone(tss):
    config, state, model = tss
    reqs = _requests(4, n=4)
    items = [SPE.item(config, reqs, i) for i in range(4)]
    T = max(len(it[0]) for it in items)
    batch = SPE.eval_collate(config, 100)(items, T + 37)
    lengths = torch.tensor([len(it[0]) for it in items])
    with torch.no_grad():
        est, _ = model(torch.from_numpy(batch["mix"]), torch.from_numpy(batch["reference"]),
                       torch.from_numpy(batch["ref_len"]), lengths=lengths)
        for row, (mix, _, aux, _) in enumerate(items):
            want, _ = ref.tss_forward(state, config["model"], torch.from_numpy(mix)[None],
                                      torch.from_numpy(aux)[None],
                                      torch.tensor([float(len(aux))]))
            assert _rel(est[row, :len(mix)], want[0]) < 1e-5


def test_bss_forward_unpadded():
    config = _config("dprnn_tasnet")
    state = seeded_state(port.template(config), 5)
    model = port.model(config, state, torch.device("cpu")).eval()
    item = BSS.item(config, _requests(5), 2)
    with torch.no_grad():
        got = model(torch.from_numpy(item[0])[None])
        want = BSS.reference_estimate(state, config, item, torch.device("cpu"))
    assert _rel(got[0], want) < 1e-5


def test_a_tss_training_step_loss_and_gradients():
    config = _config("dprnn_spe_att")
    state = seeded_state(port.template(config), 6)
    model = port.model(config, state, torch.device("cpu")).train()
    items = audio.Items(_requests(6, 5, (0.1, 0.1)), lambda r, i: SPE.item(config, r, i),
                        range(5))
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in SPE.train_collate(config)([items[i] for i in range(5)]).items()}
    est, logits = model(batch["mix"], batch["reference"], batch["ref_len"])
    from tss_dprnn_tpu_torch.ops import losses

    loss = (losses.pit_sisdr_loss(est[:, None], batch["target"][:, None])
            + 0.5 * losses.cross_entropy(logits, batch["spk_idx"]))
    loss.backward()
    params = {k: v.clone() for k, v in state.items()}
    names = [n for n, _ in model.named_parameters()]
    leaves = [params[n].requires_grad_(True) for n in names]
    config["training"]["ce_gamma"] = 0.5
    want = SPE.reference_loss(config)(params, batch)
    grads = torch.autograd.grad(want, leaves)
    assert abs(float(loss.detach()) - float(want.detach())) < 1e-5 * abs(float(want.detach()))
    got = dict(model.named_parameters())
    median = float(np.median([float(g.norm()) for g in grads]))
    for n, g in zip(names, grads):  # each leaf against its norm or the median leaf's
        gap = float((got[n].grad - g).norm()) / max(float(g.norm()), median)
        assert gap < 1e-5, n


def test_a_bss_training_step_loss_and_gradients():
    config = _config("dprnn_tasnet")
    state = seeded_state(port.template(config), 7)
    model = port.model(config, state, torch.device("cpu")).train()
    items = audio.Items(_requests(7, 5, (0.1, 0.1)), lambda r, i: BSS.item(config, r, i),
                        range(5))
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in BSS.train_collate(config)([items[i] for i in range(5)]).items()}
    from tss_dprnn_tpu_torch.ops import losses

    loss = losses.pit_sisdr_loss(model(batch["mix"]), batch["sources"])
    loss.backward()
    params = {k: v.clone() for k, v in state.items()}
    names = [n for n, _ in model.named_parameters()]
    leaves = [params[n].requires_grad_(True) for n in names]
    want = BSS.reference_loss(config)(params, batch)
    grads = torch.autograd.grad(want, leaves)
    assert abs(float(loss.detach()) - float(want.detach())) < 1e-5 * abs(float(want.detach()))
    got = dict(model.named_parameters())
    median = float(np.median([float(g.norm()) for g in grads]))
    for n, g in zip(names, grads):
        gap = float((got[n].grad - g).norm()) / max(float(g.norm()), median)
        assert gap < 1e-5, n


def test_adam_and_clip_match_torch():
    torch.manual_seed(0)
    p = [torch.randn(5, 3), torch.randn(4)]
    g = [torch.randn(5, 3) * 10, torch.randn(4) * 10]
    tp = [x.clone().requires_grad_(True) for x in p]
    opt = torch.optim.Adam(tp, lr=1e-3, weight_decay=1e-5)
    mine = ref_training.Adam([x.clone() for x in p], 1e-3, 1e-5)
    for _ in range(3):
        for x, gg in zip(tp, g):
            x.grad = gg.clone()
        torch.nn.utils.clip_grad_norm_(tp, 5.0)
        opt.step()
        gs = [gg.clone() for gg in g]
        ref_training.clip_(gs, 5.0)
        mine.step(gs)
    for a, b in zip(tp, mine.params):
        assert torch.allclose(a.detach(), b, rtol=1e-6, atol=1e-7)
