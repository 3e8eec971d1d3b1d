"""Parameter-owning building blocks of the port's models
(counterpart of ``tss_dprnn_tpu/models/layers.py``).

Every module keeps the reference's torch parameter names and shapes, so a
reference-format ``state_dict`` (``utils/weights.py``) loads with
``strict=True``. Inputs are channels-last ([B, ..., C]), as in the JAX
package. Parameters start uninitialised (``torch.empty``): weights always
come from a state_dict.

Parameters are fp32 whatever the lane. A module built with ``dtype`` (the
bf16 lane: ``torch.bfloat16``) casts its input and parameters to it and
computes in it, as flax's ``promote_dtype`` does in the JAX modules; with
``dtype=None`` it computes in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from tss_dprnn_tpu_torch.ops import norms as norms_ops
from tss_dprnn_tpu_torch.ops import rnn as rnn_ops
from tss_dprnn_tpu_torch.parallel import data_count, differentiable_sum

# BatchNorm's running-statistics momentum, torch's default
# (tss_dprnn_tpu/models/layers.py:224)
_MOMENTUM = 0.1


class Dense(nn.Module):
    """``x @ weight.T + bias`` over the last axis.

    ``weight`` keeps the reference module's shape: [out, in] for nn.Linear,
    [out, in, 1] for a 1x1 Conv1d (``conv_dims=1``), [out, in, 1, 1] for a
    1x1 Conv2d (``conv_dims=2``). With ``dtype`` the product and the bias add
    run in it, each rounded there (the JAX module's ``x @ kernel + bias``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 conv_dims: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, *([1] * conv_dims)))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def matrix(self) -> torch.Tensor:
        return self.weight.reshape(self.out_features, self.in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return nn.functional.linear(x, self.matrix(), self.bias)
        y = x.to(self.dtype) @ self.matrix().to(self.dtype).T
        return y if self.bias is None else y + self.bias.to(self.dtype)


class SplitDense(Dense):
    """Dense(2H -> features) that follows a bidirectional scan, applied per
    direction: :meth:`halves` gives its weight as the two halves a scan's
    pair contracts with (``rnn_ops.lstm_split_dense``), the counterpart of
    the JAX module's ``promoted()``. Same parameters as the Dense on the
    concatenation."""

    def halves(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(wo2 [2, H, features], bias): wo2[d] = W[:, dH:(d+1)H].T, a view
        of the weight; with ``dtype`` both cast to it (the JAX module's
        ``promoted()``)."""
        H = self.in_features // 2
        wo2 = self.matrix().reshape(self.out_features, 2, H).permute(1, 2, 0)
        if self.dtype is None:
            return wo2, self.bias
        return wo2.to(self.dtype), self.bias.to(self.dtype)


# gate blocks per cell: i, f, g, o; r, z, n; one
GATES = {"LSTM": 4, "GRU": 3, "RNN": 1}


class _RNNParams(nn.Module):
    """The parameter set of a one-layer torch ``nn.LSTM``, ``nn.GRU`` or
    ``nn.RNN``, under its names (the ``_reverse`` ones only when
    bidirectional); the port never calls cuDNN's cells."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True,
                 rnn_type: str = "LSTM"):
        super().__init__()
        G = GATES[rnn_type] * hidden_size
        self.suffixes = ("", "_reverse") if bidirectional else ("",)
        for sfx in self.suffixes:
            self.register_parameter(f"weight_ih_l0{sfx}", nn.Parameter(torch.empty(G, input_size)))
            self.register_parameter(f"weight_hh_l0{sfx}", nn.Parameter(torch.empty(G, hidden_size)))
            self.register_parameter(f"bias_ih_l0{sfx}", nn.Parameter(torch.empty(G)))
            self.register_parameter(f"bias_hh_l0{sfx}", nn.Parameter(torch.empty(G)))

    def cell(self, sfx: str, dtype: Optional[torch.dtype] = None) -> rnn_ops.CellWeights:
        """A direction as (w_ih [F, G], w_hh [H, G], b_ih, b_hh), each cast
        to ``dtype`` when one is given."""
        def p(name):
            t = getattr(self, f"{name}_l0{sfx}")
            return t if dtype is None else t.to(dtype)

        return p("weight_ih").T, p("weight_hh").T, p("bias_ih"), p("bias_hh")

    def direction(self, sfx: str, dtype: Optional[torch.dtype] = None) -> rnn_ops.LSTMWeights:
        """An LSTM direction; b = b_ih + b_hh is summed in ``dtype`` (each
        bias cast first, as the JAX RNNCore sums them)."""
        w_ih, w_hh, b_ih, b_hh = self.cell(sfx, dtype)
        return rnn_ops.LSTMWeights(w_ih, w_hh, b_ih + b_hh)

    def stacked(self, dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return rnn_ops.stack_directions(*(self.direction(sfx, dtype) for sfx in self.suffixes))


class RNNCore(nn.Module):
    """An RNN over [B, T, F], the reference SingleRNN (``rnn`` holds the
    torch cell's tensors; JAX ``models/layers.py:108-165``). With
    ``rnn_type`` 'LSTM' the port's kernels run. Bidirectional: [B, T, 2H],
    or with ``return_pair`` the pair (out_f, out_b), each [B, T, H],
    unconcatenated; with ``dense_kernel`` (a :class:`SplitDense`'s halves,
    [2, H, Fo]) the pair's product with it, [B, T, Fo], without the bias
    (``rnn_ops.lstm_split_dense``). With ``lengths`` the backward direction
    reads each row reversed within its length. ``time_major`` (bidirectional,
    no ``dense_kernel``): x [T, R, F] through ``rnn_ops.lstm_pair_tm`` (the
    pair [T, R, H], with ``lengths`` [R] the masked scan) or, without
    ``return_pair`` and ``lengths``, ``rnn_ops.lstm_tm`` ([T, R, 2H]); the
    caller gates on ``rnn_ops.lstm_time_major_available``. Unidirectional:
    [B, T, H]; ``lengths`` are not used (steps past a row's length are
    unspecified and masked by the consumer). 'GRU' and 'RNN' run
    ``rnn_ops.gru`` / ``rnn_ops.vanilla_rnn`` (plain PyTorch, no kernel)
    and return the directions concatenated, [B, T, H * ndir]. With ``dtype``
    x and each parameter are cast to it first (the LSTM's bias sum then
    rounds in it), so the kernels stream that type. The JAX module's
    asserts raise ValueError here."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True,
                 rnn_type: str = "LSTM", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if rnn_type not in GATES:
            raise ValueError(f"rnn_type must be LSTM/GRU/RNN, got {rnn_type!r}")
        self.bidirectional = bidirectional
        self.rnn_type = rnn_type
        self.dtype = dtype
        self.rnn = _RNNParams(input_size, hidden_size, bidirectional, rnn_type)
        self._stacked = None  # (the parameters it was built from, stacked weights)

    def stacked_weights(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The directions in the kernels' layout (``rnn_ops.stack_directions``).
        When autograd records, they are stacked on every call, so the gradient
        reaches the parameters. Otherwise they are built once per set of
        parameter values: ``load_state_dict`` and an optimizer step write the
        parameters in place (their version moves) and ``.to()`` gives them
        new storage, and either rebuilds it. Under ``torch.export`` they are
        stacked without the cache, whose checks read storage addresses that a
        traced tensor does not have."""
        params = tuple(self.rnn.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return self.rnn.stacked(self.dtype)
        if torch.compiler.is_exporting():
            return self.rnn.stacked(self.dtype)
        if self._stacked is None or any(
                p.data_ptr() != v.data_ptr() or p._version != n
                for p, (v, n) in zip(params, self._stacked[0])):
            with torch.no_grad():
                stacked = self.rnn.stacked(self.dtype)
            # the detached views keep the old storages alive, so no new
            # parameter can reuse their addresses
            self._stacked = (tuple((p.detach(), p._version) for p in params), stacked)
        return self._stacked[1]

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                dense_kernel: Optional[torch.Tensor] = None, time_major: bool = False,
                return_pair: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.rnn_type != "LSTM":
            if dense_kernel is not None or time_major or return_pair:
                raise ValueError("dense_kernel, time_major and return_pair need an LSTM")
            cells = [self.rnn.cell(sfx, self.dtype) for sfx in self.rnn.suffixes]
            fn = rnn_ops.gru if self.rnn_type == "GRU" else rnn_ops.vanilla_rnn
            return fn(x, cells[0], cells[1] if self.bidirectional else None, lengths)
        if (dense_kernel is not None or time_major or return_pair) and not self.bidirectional:
            raise ValueError("dense_kernel, time_major and return_pair need a bidirectional "
                             "RNNCore")
        if dense_kernel is not None:
            if time_major or return_pair:
                raise ValueError("dense_kernel excludes time_major and return_pair")
            return rnn_ops.lstm_split_dense(x, self.stacked_weights(), dense_kernel, lengths)
        if time_major:
            if return_pair:
                return rnn_ops.lstm_pair_tm(x, self.stacked_weights(), lengths)
            if lengths is not None:
                raise ValueError("time-major without return_pair takes no lengths")
            return rnn_ops.lstm_tm(x, self.stacked_weights())
        if self.bidirectional:
            pair = rnn_ops.lstm_pair(x, self.stacked_weights(), lengths)
            return pair if return_pair else torch.cat(pair, dim=-1)
        return rnn_ops.lstm_stack(x[None], self.stacked_weights())[0]


class GlobalNorm(nn.Module):
    """Channels-last global layer norm: 'gLN' (GlobLN, eps 1e-8, parameters
    gamma/beta) or 'ln' (GroupNorm(1, C), eps 1e-5, parameters weight/bias).
    Statistics are fp32; the output has x's type (a bf16 input takes the
    norm's bf16 route, ``norms_ops.global_channel_norm_cl``)."""

    def __init__(self, channels: int, norm_type: str = "gLN"):
        super().__init__()
        if norm_type not in ("gLN", "ln"):
            raise ValueError(f"norm_type must be gLN or ln, got {norm_type!r}")
        self.eps = norms_ops.GLOBLN_EPS if norm_type == "gLN" else norms_ops.GROUPNORM_EPS
        self._names = ("gamma", "beta") if norm_type == "gLN" else ("weight", "bias")
        self.register_parameter(self._names[0], nn.Parameter(torch.empty(channels)))
        self.register_parameter(self._names[1], nn.Parameter(torch.empty(channels)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                batch_axis: int = 0) -> torch.Tensor:
        """Statistics per index of ``batch_axis`` (1 for the time-major
        block's [T, B, ..., C])."""
        gamma, beta = (getattr(self, n) for n in self._names)
        return norms_ops.global_channel_norm_cl(x, gamma, beta, self.eps, mask, batch_axis)


class PReLU(nn.Module):
    """torch nn.PReLU(): one shared slope."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp_min(0) + self.weight.to(x.dtype) * x.clamp_max(0)


class BatchNorm(nn.Module):
    """torch BatchNorm1d over channels-last [..., C]. In eval mode it
    normalises with the running statistics. In training mode
    (``module.train()``) it normalises with the batch statistics over every
    axis but the channel (padded frames count, as in the JAX package) and
    moves the running mean and the running unbiased variance by
    ``_MOMENTUM`` (``tss_dprnn_tpu/models/layers.py:214-247``).

    Under a process group of more than one process the batch is the global
    one, as in the JAX package's data-parallel step: the channel sums and
    frame counts are summed over the data axis (the whole group, or the data
    group of the mesh whose sharded model runs), then the squared
    deviations, each through ``parallel.differentiable_sum``, whose backward
    sums the gradients over it too. A data axis of one process, and eval
    mode, take no collective."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.int64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif data_count() > 1:
            mean, var, n = self._global_statistics(x)
        else:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = (x - mean).square().mean(dim=axes)
            n = x.numel() // x.shape[-1]
        if self.training:
            with torch.no_grad():
                m = _MOMENTUM
                unbiased = var * (n / (n - 1).clamp_min(1) if torch.is_tensor(n)
                                  else n / max(n - 1, 1))
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
                self.num_batches_tracked += 1
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * inv * self.weight + self.bias

    @staticmethod
    def _global_statistics(x: torch.Tensor):
        """(mean, biased variance, frame count) over every process's batch."""
        axes = tuple(range(x.ndim - 1))
        count = x.new_tensor([x.numel() // x.shape[-1]])
        sums = differentiable_sum(torch.cat([x.sum(dim=axes), count]))
        n = sums[-1]
        mean = sums[:-1] / n
        var = differentiable_sum((x - mean).square().sum(dim=axes)) / n
        return mean, var, n.detach()
