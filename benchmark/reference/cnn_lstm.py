"""Plain PyTorch CNN_LSTM, one trial at its own widths, and a fit's first
steps of it, for the benchmark's comparisons.

It follows the reference's layer equations (`BIOINF_tesi/models/
CNN_LSTM_net.py:9-95` at d06b603):

* per conv block (1-2, on the one-hot sequence ``[B, 4, 256]``): a
  same-padded convolution plus bias, BatchNorm (batch moments over the
  unmasked rows), ReLU, max-pool (10, 2), inverted dropout;
* the NCW conv output ``[B, C, L]`` read as ``[B, C*L/4, 4]`` (the
  channel-major flatten cut into steps of 4, `CNN_LSTM_net.py:78-84`);
* an LSTM of 1-2 layers from zero state, written out as a loop over the
  timesteps: ``gates = x_t @ w_ih + h @ w_hh + b_ih + b_hh``, cut into
  ``i, f, g, o``; ``c = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h =
  sigmoid(o) tanh(c)``; a layer's outputs are the next one's inputs;
* the outputs ``[B, steps, H]`` flattened step-major, then
  ``Linear(., 1000)``, ``Linear(1000, 64)`` and ``Linear(64, 2)`` with no
  activation between them;
* the INS-weighted cross entropy over the unmasked rows, and autograd's
  gradients.

Departures from the published description, as the port and the JAX
package state them: FC1 is a learned layer drawn once at init, where
`CNN_LSTM_net.py:85` builds a new ``nn.Linear`` in every forward pass; the
LSTM's weights are kept as ``w_ih [in, 4H]`` and ``w_hh [H, 4H]`` (the
transposes of torch's) and drawn in the port's order; a batch is the
balanced plan's 99 rows, the padding rows masked out of BatchNorm and the
loss.

The recurrence shares no code with the program's, which calls torch's
LSTM (cuDNN on the card): no ``nn.LSTM``, ``torch._VF.lstm`` or
``F.lstm_cell`` here, so a misuse of the library call (the weights'
layout, the gates' order, which state is carried) shows as a gap.

What the port derives from its seeds is worked out again, not taken from
it: each trial's initial parameters from its init seed
(``frozen.seeds.seed_streams``) in the port's order and bounds
(``frozen.cnn_lstm.leaves``), each step's dropout uniforms from the
trial's step generator (``multimodal.StepDraws`` at the trial's own
widths: a CNN_LSTM fit has no supernet, so its own widths are its
bucket), and the optimizer update is ``reference.train.update``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.frozen import cnn_lstm as A
from benchmark.frozen.arch import N_BASES, POOL_KERNEL, POOL_STRIDE
from benchmark.frozen.seeds import group_seed, seed_streams, step_seeds
from benchmark.reference import multimodal as M
from benchmark.reference.precision import conv1d, exact, round_to
from benchmark.reference.train import update

#: the precisions the reference computes in: the cell's, and its control
PRECISIONS = ("float32", "tf32")


def init_trial(a: dict, seed: int) -> dict:
    """The trial's initial leaves (``frozen.cnn_lstm.leaves`` names),
    drawn in the port's order from a CPU generator seeded with ``seed``
    as U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BatchNorm scale 1 and bias 0
    (float32, on the CPU)."""
    gen = torch.Generator().manual_seed(int(seed))
    P = {}
    for name, _, shape, fan in A.leaves(a):
        if fan is None:
            P[name] = (torch.ones if name.endswith("scale")
                       else torch.zeros)(shape)
            continue
        bound = 1.0 / max(float(fan), 1.0) ** 0.5
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        P[name] = (u * 2.0 - 1.0) * bound
    return P


def _mm(x, w, precision: str):
    return torch.matmul(round_to(x, precision), round_to(w, precision))


def lstm(x, P: dict, layers: int, precision: str):
    """``x [B, steps, in]`` -> the last layer's outputs ``[B, steps, H]``,
    one timestep after another from zero state."""
    for layer in range(layers):
        w_ih, w_hh = P[f"lstm{layer}.w_ih"], P[f"lstm{layer}.w_hh"]
        b_ih, b_hh = P[f"lstm{layer}.b_ih"], P[f"lstm{layer}.b_hh"]
        h = x.new_zeros((x.shape[0], w_hh.shape[0]))
        c = torch.zeros_like(h)
        outs = []
        for t in range(x.shape[1]):
            gates = (_mm(x[:, t], w_ih, precision) + _mm(h, w_hh, precision)
                     + b_ih + b_hh)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, dim=1)
    return x


def forward(a: dict, P: dict, codes, mask, precision: str, draws=None):
    """Training logits ``[B, 2]`` of one trial (dropout from ``draws``, a
    ``multimodal.StepDraws``; none without it)."""
    if precision not in PRECISIONS:
        raise ValueError(f"no CNN_LSTM reference in {precision}")
    z = F.one_hot(codes.long(), N_BASES).transpose(1, 2).float()  # [B, 4, L]
    for i in range(a["cnn_depth"]):
        z = conv1d(z, P[f"conv_w{i}"], precision) \
            + P[f"conv_b{i}"][None, :, None]
        z = M._batchnorm(z, P[f"bn{i}.scale"], P[f"bn{i}.bias"], mask)
        z = F.max_pool1d(torch.relu(z), kernel_size=POOL_KERNEL,
                         stride=POOL_STRIDE)
        if draws is not None:
            z = M._dropout(z, a["cnn_dropout"][i], draws.cnn(i))
    seq = z.reshape(z.shape[0], -1, A.STEP_WIDTH)
    h = lstm(seq, P, a["lstm_layers"], precision).reshape(z.shape[0], -1)
    for name in ("fc1", "fc2", "head"):
        h = _mm(h, P[f"w_{name}"], precision) + P[f"b_{name}"]
    return h


def _fresh_state(P: dict) -> dict:
    """The optimizer's state before a fit's first step."""
    return {"m": {k: torch.zeros_like(v) for k, v in P.items()},
            "v": {k: torch.zeros_like(v) for k, v in P.items()},
            "step": torch.zeros(()), "m_schedule": torch.ones(())}


def follow_trial(a: dict, init_seed: int, run_seed: int, data: dict, plan,
                 precision: str, steps: int, device,
                 fault: str | None = None, keep: bool = False) -> dict:
    """``steps`` training steps of one trial on the rows of the plan's
    first batches -> ``{"loss": [steps], "grad": {leaf: norm}, "raw":
    {leaf: norm}, "change": {leaf: norm}}``, as
    ``reference.train.follow_trial`` reports them, and with ``keep`` the
    parameters after the steps (``"params"``).  ``fault`` plants a fault
    in the reference put in the program's place: ``"half"`` takes each
    step over the first half of its rows only, ``"unchanged"`` skips
    every update, ``"lr"`` takes the steps at 1.1 times the trial's
    learning rate, ``"reset"`` starts every step from a fresh optimizer
    state (moments nought, step count 0), so that each step is a first
    one: from the second step on, a state lost between steps."""
    idx, mask = plan
    if fault == "lr":
        a = dict(a, lr=a["lr"] * 1.1)
    P0 = {k: v.to(device) for k, v in init_trial(a, init_seed).items()}
    P = dict(P0)
    state = _fresh_state(P)
    out = {"loss": []}
    for s, seed in enumerate(step_seeds(run_seed, steps)):
        rows = torch.as_tensor(idx[s], device=device)
        m = torch.as_tensor(mask[s], device=device)
        if fault == "half":
            m = m.clone()
            m[m.shape[0] // 2:] = 0.0
        draws = M.StepDraws(a, seed, rows.shape[0], True, device)
        live = {k: v.detach().requires_grad_(True) for k, v in P.items()}
        with exact():
            logits = forward(a, live, data["cnn"][rows], m, precision, draws)
            loss = M.weighted_cross_entropy(logits, data["y"][rows], m)
            grads = torch.autograd.grad(loss, list(live.values()),
                                        allow_unused=True)
        G = {k: (torch.zeros_like(v) if g is None else g.detach())
             for (k, v), g in zip(live.items(), grads)}
        out["loss"].append(float(loss.detach()))
        P = {k: v.detach() for k, v in live.items()}
        if fault == "reset":
            state = _fresh_state(P)
        if fault == "unchanged":
            decayed = {k: torch.zeros_like(v) for k, v in P.items()}
        else:
            decayed = update(P, G, state, a)
        if s == 0:
            out["grad"] = {k: float(g.norm()) for k, g in decayed.items()}
            out["raw"] = {k: float(g.norm()) for k, g in G.items()}
    out["change"] = {k: float((P[k] - P0[k]).norm()) for k in P}
    if keep:
        out["params"] = P
    return out


def follow(archs_by_group: list, seed: int, data: dict, plan,
           precision: str, steps: int, device, fault=None) -> list:
    """:func:`follow_trial` for every trial of every group, each with the
    seeds its group's fit gives it -> one list per group.  The fault
    ``"lr"`` is planted in one trial only, the first group's last, as
    ``reference.train.follow`` plants it."""
    out = []
    for g, archs in enumerate(archs_by_group):
        init, run = seed_streams(group_seed(seed, g), len(archs))
        out.append([follow_trial(a, init[t], run[t], data, plan, precision,
                                 steps, device,
                                 fault if fault != "lr" or
                                 (g, t) == (0, len(archs) - 1) else None)
                    for t, a in enumerate(archs)])
    return out
