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
    as_dtype,
    dropout as _dropout,
    linear,
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

    ``dockings``: list of [B, W] tensors (already ReLU-ed and e-masked).
    With two modalities the draw is ``u < p0``, where ``u`` [B, E] is
    given (a test feeds the JAX package's uniforms) or drawn from
    ``generator`` at the full embracement width and sliced to W, so a
    width-bucketed docking selects exactly as the unbucketed one (and by
    global row for a ``shard`` of a batch).
    """
    m = len(dockings)
    b, width = dockings[0].shape
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
        out = torch.where(u[:, :width] < p[:, 0:1], dockings[0], dockings[1])
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
    """Forward -> (logits [B, 2], new_bn_state).

    The ``*_max`` statics are width buckets (population maxima): weights
    are sliced so compute costs the bucket dims, exactly equivalent to the
    full supernet.  ``fused=True`` runs docking + embracement in the fused
    kernel; ``u`` ([B, E] uniforms) feeds the unfused draw instead of the
    generator.  ``shard``: this rank's rows of a data-sharded batch.
    """
    dev = x_ffnn.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    EB = embrace_max or E
    PB = post_max or P

    f_ffnn, _ = ffnn_mod.features(params["ffnn"], hp["ffnn"], x_ffnn,
                                  train=train, generator=gen,
                                  compute_dtype=compute_dtype,
                                  max_width=ffnn_max_width, shard=shard)
    f_cnn, _, new_bn_state = cnn_mod.features(
        params["cnn"], bn_state, hp["cnn"], x_cnn, train=train, generator=gen,
        row_mask=row_mask, compute_dtype=compute_dtype,
        max_depth=cnn_max_depth, max_channels=cnn_max_channels,
        max_kernels=cnn_max_kernels, shard=shard)

    e_mask = width_mask(EB, hp["embrace_size"], dev)
    b = f_ffnn.shape[0]
    # modality dropout (EmbraceNetMultimodal.py:178-182): batch-level coin,
    # then per-sample single-modality availability
    if availabilities is None and train and modality_dropout:
        coin = torch.rand((), generator=gen, device=dev)
        target = torch.round(rand((b,), gen, dev, shard)).long()
        one_hot_avail = torch.nn.functional.one_hot(target, 2).float()
        availabilities = torch.where(coin >= MODALITY_DROPOUT_P,
                                     one_hot_avail, torch.ones((b, 2), device=dev))
    p_ffnn = float(hp["p_ffnn"])
    # filled on the device: a host tensor copied to the card would wait
    # for the device to drain
    p = torch.stack([torch.full((b,), p_ffnn, device=dev),
                     torch.full((b,), 1.0 - p_ffnn, device=dev)], dim=-1)

    w0 = params["dock0_w"][:f_ffnn.shape[1], :EB]
    w1 = params["dock1_w"][:f_cnn.shape[1], :EB]
    if fused:
        from embracenet_tpu_torch.ops.embrace import fused_embrace

        # availability folds into the per-row Bernoulli prob exactly as
        # embrace() normalises it
        pa = p * availabilities if availabilities is not None else p
        p0 = (pa[:, 0] / torch.clamp(pa.sum(-1), min=1e-30)).contiguous()
        x0, x1 = f_ffnn, f_cnn
        dt = as_dtype(compute_dtype) or x0.dtype
        x0, x1, w0, w1 = (t.to(dt) for t in (x0, x1, w0, w1))
        # training keys the kernel with a draw of the step's generator
        # (JAX: randint from its own key), not with the generator's seed
        kseed = (torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=dev)
                 if train else seed)
        # biases as float32, as the JAX wrapper casts them (bf16 live params)
        h, _ = fused_embrace(x0.contiguous(), x1.contiguous(), w0,
                             params["dock0_b"][:EB].float(), w1,
                             params["dock1_b"][:EB].float(), p0, e_mask, kseed,
                             row_base=shard.lo if shard is not None else 0)
    else:
        d0 = torch.relu(linear(f_ffnn, w0, params["dock0_b"][:EB],
                               compute_dtype)) * e_mask
        d1 = torch.relu(linear(f_cnn, w1, params["dock1_b"][:EB],
                               compute_dtype)) * e_mask
        h = embrace([d0, d1], gen, availabilities=availabilities,
                    selection_probabilities=p, e_mask=e_mask, u=u, shard=shard)

    # post MLP (0-2 layers) with pass-through selection: layers beyond
    # n_post are not computed
    n_post = int(hp["n_post"])
    hp_post = torch.zeros((b, PB), device=dev)
    for i in range(n_post):
        inp = h if i == 0 else hp_post
        w = params[f"post_w{i}"][:EB, :PB] if i == 0 \
            else params[f"post_w{i}"][:PB, :PB]
        mask = width_mask(PB, hp["post_widths"][i], dev)
        z = torch.relu(linear(inp, w, params[f"post_b{i}"][:PB],
                              compute_dtype)) * mask
        hp_post = _dropout(z, hp["post_dropout"][i], gen, train, shard) * mask

    head_in = torch.cat([h * float(n_post == 0), hp_post * float(n_post > 0)],
                        dim=-1)
    # head rows follow the [E | P] concat layout; pick the bucketed rows of
    # each block so the slice matches head_in = [EB | PB]
    if params["head_w"].shape[0] == EB + PB:
        head_w = params["head_w"]
    else:
        head_w = torch.cat([params["head_w"][:EB], params["head_w"][E:E + PB]])
    logits = linear(head_in, head_w, params["head_b"], compute_dtype)
    return logits, new_bn_state
