"""EmbraceNet fusion core + multimodal wrapper, supernet form (port of
``embracenet_tpu/models/embracenet.py``).

Reference: `BIOINF_tesi/models/EmbraceNetMultimodal.py`.
  * Docking: per-modality ``Linear(d_i -> c) + ReLU`` (`:52-60`).
  * Selection probabilities ``p * availability`` normalised per row (`:69-76`).
  * Embracement: ``torch.multinomial(p, num_samples=c, replacement=True)``
    draws an iid modality index per output feature (`:84`), then that
    modality's docking value is kept (`:85-88`).  With two modalities the
    draw is a per-feature Bernoulli select.

Wrapper (`:94-193`): FFNN_pre + CNN_pre branches, an embracement size in
{512, 768, 1024}, 0-2 post Linear+ReLU+Dropout layers + ``Linear(., 2)``
head, ``selection_probabilities_FFNN`` p -> [p, 1-p], and modality dropout
while training (`:178-182`).

:func:`apply_trials` is a population's forward, ``jax.vmap`` of the JAX
``apply`` written out (the hyperparameters stacked in a ``layers.Trials``,
every trial drawing from its own generator, the fused kernel launched once
for all trials); :func:`apply` is one trial, a population of one.
``apply(fused=True)`` runs docking + embracement as the fused CUDA kernel
(``ops/embrace.py``, differentiable).  Random draws come from ``seed``: a
``torch.Generator`` seeded with it on the input's device feeds dropout,
modality dropout and the unfused draw.  While training, the fused kernel's
Philox key is drawn from that generator (as the JAX package draws it from
its own key), so the kernel's stream is independent of the generator's;
in eval mode (serving) the kernel is keyed by ``seed`` itself.  Same
distribution as the JAX package, different RNG stream.

Under a data-sharded fit (``shard``, a ``parallel.mesh.BatchShard``) every
per-row draw is taken by global row: the generator's draws at the whole
batch's shape, cut to the shard's rows, and the kernel's Philox counter
offset by ``row_base`` = the shard's first row.  A shard then draws exactly
what the unsharded step draws for its rows.
"""

from __future__ import annotations

import numpy as np
import torch

from embracenet_tpu_torch.config import (
    EMBRACE_MAX_POST_LAYERS,
    EMBRACE_MAX_SIZE,
    FFNN_MAX_WIDTH,
    MODALITY_DROPOUT_P,
)
from embracenet_tpu_torch.models import cnn as cnn_mod
from embracenet_tpu_torch.models import ffnn as ffnn_mod
from embracenet_tpu_torch.models.cnn import FLAT_MAX
from embracenet_tpu_torch.models.layers import (
    Trials,
    as_dtype,
    dropout_trials,
    linear,
    one_trial,
    rand,
    torch_uniform_init,
    width_mask,
)
from embracenet_tpu_torch.ops.convmath import CNN_LENGTHS

E = EMBRACE_MAX_SIZE          # 1024
P = 512                       # post-layer space (max of post width menus)


def embrace(dockings, generator=None, availabilities=None,
            selection_probabilities=None, e_mask=None, u=None, shard=None):
    """Stochastic embracement over a list of docked modalities.

    ``dockings``: list of [B, W] tensors (already ReLU-ed and e-masked),
    or of [T, B, W] for a population (then ``u`` [T, B, E] is given and
    the probabilities are [T, B, 2]).  With two modalities the draw is
    ``u < p0``, where ``u`` [B, E] is given (a test feeds the JAX
    package's uniforms) or drawn from ``generator`` at the full
    embracement width and sliced to W, so a width-bucketed docking selects
    exactly as the unbucketed one (and by global row for a ``shard`` of a
    batch).
    """
    m = len(dockings)
    b, width = dockings[0].shape[-2:]
    dev = dockings[0].device
    if availabilities is None:
        availabilities = torch.ones((b, m), device=dev)
    if selection_probabilities is None:
        selection_probabilities = torch.ones((b, m), device=dev)
    p = selection_probabilities * availabilities
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)

    if m == 2:
        if u is None:
            u = rand((b, E), generator, dev, shard)
        out = torch.where(u[..., :width] < p[..., 0:1], dockings[0],
                          dockings[1])
    else:
        idx = torch.multinomial(p, width, replacement=True, generator=generator)
        out = torch.gather(torch.stack(dockings, -1), -1, idx[..., None])[..., 0]
    if e_mask is not None:
        out = out * e_mask
    return out


def fan_ins(hp, in_features_ffnn: int) -> dict:
    """Concrete init fan-ins for the whole multimodal net."""
    n_post = int(hp["n_post"])
    post_widths = [int(w) for w in hp["post_widths"]]
    e_size = int(hp["embrace_size"])
    ffnn_out = int(hp["ffnn"]["widths"][int(hp["ffnn"]["n_layers"]) - 1])
    cnn_depth = int(hp["cnn"]["n_layers"])
    cnn_out = int(hp["cnn"]["channels"][cnn_depth - 1]) * CNN_LENGTHS[cnn_depth - 1]

    post = []
    fan_in = e_size
    for i in range(EMBRACE_MAX_POST_LAYERS):
        post.append(fan_in)
        if i < n_post:
            fan_in = post_widths[i]
    head_fan = e_size if n_post == 0 else post_widths[n_post - 1]
    return {"ffnn": ffnn_mod.fan_ins(hp["ffnn"], in_features_ffnn, head=False),
            "cnn": cnn_mod.fan_ins(hp["cnn"], head=False),
            "dock": np.asarray([ffnn_out, cnn_out], np.float32),
            "post": np.asarray(post, np.float32),
            "head": np.asarray(head_fan, np.float32)}


def init_from_fans(generator: torch.Generator, fans, in_features_ffnn: int,
                   n_classes: int = 2):
    params = {
        "ffnn": ffnn_mod.init_from_fans(generator, fans["ffnn"],
                                        in_features_ffnn, head=False),
    }
    params["cnn"], bn_state = cnn_mod.init_from_fans(generator, fans["cnn"],
                                                     head=False)
    params["dock0_w"] = torch_uniform_init(generator, (FFNN_MAX_WIDTH, E),
                                           fans["dock"][0])
    params["dock0_b"] = torch_uniform_init(generator, (E,), fans["dock"][0])
    params["dock1_w"] = torch_uniform_init(generator, (FLAT_MAX, E),
                                           fans["dock"][1])
    params["dock1_b"] = torch_uniform_init(generator, (E,), fans["dock"][1])
    for i in range(EMBRACE_MAX_POST_LAYERS):
        d_in = E if i == 0 else P
        params[f"post_w{i}"] = torch_uniform_init(generator, (d_in, P),
                                                  fans["post"][i])
        params[f"post_b{i}"] = torch_uniform_init(generator, (P,),
                                                  fans["post"][i])
    params["head_w"] = torch_uniform_init(generator, (E + P, n_classes),
                                          fans["head"])
    params["head_b"] = torch_uniform_init(generator, (n_classes,), fans["head"])
    return params, bn_state


def init(generator: torch.Generator, hp, in_features_ffnn: int,
         n_classes: int = 2):
    """Init FFNN/CNN branches, docking layers, post MLP and head."""
    return init_from_fans(generator, fan_ins(hp, in_features_ffnn),
                          in_features_ffnn, n_classes)


def apply_trials(params, bn_state, trials: Trials, x_ffnn, x_cnn, *,
                 train: bool = False, seed=0, row_mask=None,
                 availabilities=None, modality_dropout: bool = True,
                 compute_dtype=None, cnn_max_depth: int | None = None,
                 cnn_max_channels: tuple | None = None,
                 cnn_max_kernels: tuple | None = None,
                 ffnn_max_width: int | None = None,
                 embrace_max: int | None = None,
                 post_max: int | None = None,
                 fused: bool = False, u=None, shard=None):
    """Forward of a population of T trials -> (logits [T, B, 2],
    new_bn_state): ``jax.vmap`` of the JAX ``apply`` written out.

    Params and BN state leaves ``[T, ...]``, ``x_ffnn [T, B, F]``,
    ``x_cnn [B, T*4, 256]`` (``cnn.trial_channels``), ``row_mask [T, B]``.
    The ``*_max`` statics are width buckets (population maxima): weights
    are sliced so compute costs the bucket dims, exactly equivalent to the
    full supernet.  ``fused=True`` runs docking + embracement of all
    trials in one launch of the fused kernel (a trial axis in its grid);
    ``u`` ([T, B, E] uniforms) feeds the unfused draw instead of the
    trials' generators.  While training every draw is trial t's own, from
    ``trials.draws`` (the kernel's Philox key too); in eval mode the kernel
    is keyed by ``seed`` (an int, or a [T] int64 tensor).  ``shard``: this
    rank's rows of a data-sharded batch.
    """
    dev, hp = x_ffnn.device, trials.hp
    n_trials, b = len(trials), x_ffnn.shape[1]
    EB = embrace_max or E
    PB = post_max or P
    draws = trials.draws if train else None

    f_ffnn, _ = ffnn_mod.features_trials(params["ffnn"], trials.sub("ffnn"),
                                         x_ffnn, train=train,
                                         compute_dtype=compute_dtype,
                                         max_width=ffnn_max_width)
    f_cnn, _, new_bn_state = cnn_mod.features_trials(
        params["cnn"], bn_state, trials.sub("cnn"), x_cnn, train=train,
        row_mask=row_mask, compute_dtype=compute_dtype,
        max_depth=cnn_max_depth, max_channels=cnn_max_channels,
        max_kernels=cnn_max_kernels, shard=shard)

    e_mask = width_mask(EB, hp["embrace_size"], dev)              # [T, EB]
    # modality dropout (EmbraceNetMultimodal.py:178-182): batch-level coin,
    # then per-sample single-modality availability
    if availabilities is None and train and modality_dropout:
        coin = draws.scalar()
        target = torch.round(draws.rand(b, [()] * n_trials, ())).long()
        one_hot_avail = torch.nn.functional.one_hot(target, 2).float()
        availabilities = torch.where(
            (coin >= MODALITY_DROPOUT_P)[:, None, None], one_hot_avail,
            torch.ones((n_trials, b, 2), device=dev))
    # 1 - p in float64, as the single-trial path took it from Python floats
    p_ffnn = hp["p_ffnn"].float()
    p = torch.stack([p_ffnn[:, None].expand(n_trials, b),
                     (1.0 - p_ffnn.double()).float()[:, None].expand(n_trials, b)],
                    dim=-1)                                       # [T, B, 2]

    w0 = params["dock0_w"][:, :f_ffnn.shape[2], :EB]
    w1 = params["dock1_w"][:, :f_cnn.shape[2], :EB]
    if fused:
        from embracenet_tpu_torch.ops.embrace import fused_embrace

        # availability folds into the per-row Bernoulli prob exactly as
        # embrace() normalises it
        pa = p * availabilities if availabilities is not None else p
        p0 = (pa[..., 0] / torch.clamp(pa.sum(-1), min=1e-30)).contiguous()
        x0, x1 = f_ffnn, f_cnn
        dt = as_dtype(compute_dtype) or x0.dtype
        x0, x1, w0, w1 = (t.to(dt) for t in (x0, x1, w0, w1))
        # training keys the kernel with a draw of each trial's generator
        # (JAX: randint from its own key), not with the generator's seed
        kseed = draws.seeds() if train else seed
        # biases as float32, as the JAX wrapper casts them (bf16 live params)
        h, _ = fused_embrace(x0.contiguous(), x1.contiguous(), w0,
                             params["dock0_b"][:, :EB].float().contiguous(), w1,
                             params["dock1_b"][:, :EB].float().contiguous(), p0,
                             e_mask, kseed,
                             row_base=shard.lo if shard is not None else 0)
    else:
        d0 = torch.relu(linear(f_ffnn, w0, params["dock0_b"][:, :EB],
                               compute_dtype)) * e_mask[:, None, :]
        d1 = torch.relu(linear(f_cnn, w1, params["dock1_b"][:, :EB],
                               compute_dtype)) * e_mask[:, None, :]
        if u is None:
            u = draws.rand(b, [(E,)] * n_trials, (E,)) if train else \
                torch.stack([rand((b, E), torch.Generator(dev).manual_seed(
                    int(seed)), dev, shard)] * n_trials)
        elif u.dim() == 2:
            u = u[None]
        h = embrace([d0, d1], availabilities=availabilities,
                    selection_probabilities=p, e_mask=e_mask[:, None, :], u=u)

    # post MLP (0-2 layers) to the population's deepest trial; a layer
    # beyond a trial's n_post passes its input through and draws nothing
    n_host = trials.ints("n_post")
    n_post = hp["n_post"]
    own = trials.own_shapes("post_max", PB, P, lambda w: (w,))
    hp_post = torch.zeros((n_trials, b, PB), device=dev)
    for i in range(max(n_host)):
        inp = h if i == 0 else hp_post
        w = params[f"post_w{i}"][:, :EB, :PB] if i == 0 \
            else params[f"post_w{i}"][:, :PB, :PB]
        mask = width_mask(PB, hp["post_widths"][:, i], dev)[:, None, :]
        z = torch.relu(linear(inp, w, params[f"post_b{i}"][:, :PB],
                              compute_dtype)) * mask
        if train:
            du = draws.rand(b, own, (PB,), [i < n for n in n_host])
            z = dropout_trials(z, hp["post_dropout"][:, i] * (i < n_post), du,
                               train)
        hp_post = torch.where((i < n_post)[:, None, None], z * mask, hp_post)

    head_in = torch.cat([h * (n_post == 0).float()[:, None, None],
                         hp_post * (n_post > 0).float()[:, None, None]], dim=-1)
    # head rows follow the [E | P] concat layout; pick the bucketed rows of
    # each block so the slice matches head_in = [EB | PB]
    if params["head_w"].shape[1] == EB + PB:
        head_w = params["head_w"]
    else:
        head_w = torch.cat([params["head_w"][:, :EB],
                            params["head_w"][:, E:E + PB]], dim=1)
    logits = linear(head_in, head_w, params["head_b"], compute_dtype)
    return logits, new_bn_state


def apply(params, bn_state, hp, x_ffnn, x_cnn, *, train: bool = False,
          seed: int = 0, row_mask=None, availabilities=None,
          modality_dropout: bool = True, compute_dtype=None,
          cnn_max_depth: int | None = None,
          cnn_max_channels: tuple | None = None,
          cnn_max_kernels: tuple | None = None,
          ffnn_max_width: int | None = None,
          embrace_max: int | None = None,
          post_max: int | None = None,
          fused: bool = False, u=None, shard=None):
    """Forward of one trial -> (logits [B, 2], new_bn_state):
    :func:`apply_trials` of a population of one, its draws from a
    ``torch.Generator`` seeded with ``seed`` (in eval mode the fused
    kernel is keyed by ``seed`` itself).  ``u`` ([B, E] uniforms) feeds
    the unfused draw; ``shard``: this rank's rows of a data-sharded
    batch."""
    trials, stack, unstack = one_trial(hp, x_ffnn.shape[0], x_ffnn.device,
                                       seed, train, shard)
    logits, new_bn = apply_trials(
        stack(params), stack(bn_state), trials, x_ffnn[None], x_cnn,
        train=train, seed=seed, row_mask=stack(row_mask),
        availabilities=stack(availabilities),
        modality_dropout=modality_dropout, compute_dtype=compute_dtype,
        cnn_max_depth=cnn_max_depth, cnn_max_channels=cnn_max_channels,
        cnn_max_kernels=cnn_max_kernels, ffnn_max_width=ffnn_max_width,
        embrace_max=embrace_max, post_max=post_max, fused=fused, u=u,
        shard=shard)
    return logits[0], unstack(new_bn)
