"""Masked building blocks for architecture supernets (port of
``embracenet_tpu/models/layers.py``).

Every tunable architecture lives inside a fixed maximal shape: width menus
become feature masks, the kernel-size menu a centered tap mask over the
maximal kernel, and depth a pass-through selection.  Layouts follow the JAX
package: ``linear`` is ``x @ w`` with ``w[in, out]``, ``conv1d_ncw`` takes
``x[B, C, L]`` and ``w[O, I, K]``.

A population of T trials runs as one program, as ``jax.vmap`` runs it in
the JAX package: the vmapped axis is written out.  ``linear`` takes
``x[T, B, in] @ w[T, in, out]`` (a batched product), ``conv1d_trials``
every trial's convolution over ``x[B, T*C, L]`` (the CNN keeps its
activations as ``[B, T, C, L]``; float32 as batched products over im2col
windows, else one grouped convolution), ``batchnorm_trials`` per-trial
moments under a ``[T, B]`` row mask, ``width_mask`` / ``kernel_tap_mask``
take ``[T]`` tensors, and :class:`Draws` gives each trial its own random draws.
One trial runs as a population of one (:func:`one_trial`).

Precision contract (as ``layers.py:65-98`` of the JAX package):

  * ``compute_dtype=None``: true float32.  Matrix products (a
    population's convolutions among them) run at
    ``float32_matmul_precision("highest")`` and cuDNN convolutions with TF32
    off (cuDNN's default would round inputs to TF32's 10-bit mantissa).
  * ``compute_dtype=bfloat16``: ``linear`` rounds its operands to bf16 and
    accumulates in float32; ``conv1d_ncw`` runs wholly in bf16 and the
    result is upcast afterwards.

Initialisation parity: torch ``nn.Linear``/``nn.Conv1d`` default init is
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases; supernet
sub-blocks use the trial's *actual* fan-in.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from embracenet_tpu_torch.convert import tree_map
from embracenet_tpu_torch.utils.profiling import count


def as_dtype(compute_dtype) -> torch.dtype | None:
    """``None`` | a dtype name | a torch dtype -> the low-precision torch
    dtype, or None for the full float32 path (float32 itself included)."""
    if compute_dtype is not None and not isinstance(compute_dtype, torch.dtype):
        compute_dtype = getattr(torch, str(compute_dtype))
    return None if compute_dtype == torch.float32 else compute_dtype


@contextlib.contextmanager
def _highest_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@contextlib.contextmanager
def exact_float32():
    """Full float32 for everything run inside, backward passes included:
    cuDNN convolutions and RNNs with TF32 off and deterministic algorithms
    only, matmuls at "highest".  The settings are global and read when a
    kernel is picked, so a backward pass taken outside the forward's
    context (autograd runs it later) must be inside one of its own.
    Without TF32, cuDNN's heuristics may pick a weight-gradient algorithm
    that sums with atomics, and two runs of one fit would then differ."""
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    deterministic=True, allow_tf32=False), \
            _highest_matmul_precision():
        yield


#: set inside :func:`population_invariant`
_POPULATION_INVARIANT = False


@contextlib.contextmanager
def population_invariant():
    """Inside, a population of one trial takes its batched products as a
    population of two does (:func:`trial_matmul`, which its float32
    convolutions take too; and on the CPU its grouped convolutions,
    :func:`conv1d_trials`), so a trial's sums do not depend on how many
    trials share its program.  A product of one batch runs as
    one GEMM that may split its K (multithreaded on the CPU, a split-K
    kernel of cuBLAS on the card), a product of several batches as a
    batched GEMM that sums every batch alike for any count from 2 up; on
    the CPU a convolution's weight gradient of one group sums in another
    order than that of several.  ``engine.fit`` trains inside it; serving
    does not need it."""
    global _POPULATION_INVARIANT
    prev, _POPULATION_INVARIANT = _POPULATION_INVARIANT, True
    try:
        yield
    finally:
        _POPULATION_INVARIANT = prev


def trial_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of operands with a leading trial axis (a batched product);
    a lone trial inside :func:`population_invariant` computes as one of a
    population of two (its batch doubled by a broadcast view, the copy's
    result dropped: the backward pass adds an exact 0)."""
    if _POPULATION_INVARIANT and a.dim() == 3 and a.shape[0] == 1:
        return torch.matmul(a.expand(2, *a.shape[1:]),
                            b.expand(2, *b.shape[1:]))[:1]
    return torch.matmul(a, b)


class InitPlan:
    """A stand-in for the generator of a trial's init that records what
    :func:`torch_uniform_init` would draw from it, in stream order: each
    draw's shape and bound, and the placeholder leaf (a tensor on the meta
    device) the init puts where that draw goes.  The init's own code thus
    gives the plan that ``ops/mt19937.uniform_init`` draws on the card
    (``training/engine.init_population``)."""

    def __init__(self):
        self.shapes, self.bounds, self.leaves = [], [], []

    def draw(self, shape: tuple, bound: float) -> torch.Tensor:
        leaf = torch.empty(shape, device="meta")
        self.shapes.append(shape)
        self.bounds.append(bound)
        self.leaves.append(leaf)
        return leaf


def torch_uniform_init(generator: torch.Generator, shape, fan_in) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — torch Linear/Conv1d default.
    From an :class:`InitPlan` the draw is recorded, not made."""
    bound = 1.0 / max(float(fan_in), 1.0) ** 0.5
    if isinstance(generator, InitPlan):
        return generator.draw(tuple(int(d) for d in shape), bound)
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * 2.0 - 1.0) * bound


def width_mask(max_width: int, width, device=None) -> torch.Tensor:
    """[max_width] float mask with ones below ``width``; for a ``[T]``
    tensor of widths, ``[T, max_width]``."""
    idx = torch.arange(max_width, device=device)
    if isinstance(width, torch.Tensor) and width.dim() == 1:
        return (idx < width[:, None]).float()
    return (idx < int(width)).float()


def kernel_tap_mask(max_kernel: int, kernel, device=None) -> torch.Tensor:
    """Centered tap mask: a same-padded conv with ``max_kernel`` taps whose
    mask keeps the centered ``kernel`` taps computes exactly a same-padded
    ``kernel``-tap conv (both paddings are symmetric for odd sizes).  For
    a ``[T]`` tensor of kernel sizes, ``[T, max_kernel]``."""
    idx = torch.arange(max_kernel, device=device)
    if isinstance(kernel, torch.Tensor) and kernel.dim() == 1:
        lo = ((max_kernel - kernel) // 2)[:, None]
        return ((idx >= lo) & (idx < lo + kernel[:, None])).float()
    lo = (max_kernel - int(kernel)) // 2
    return ((idx >= lo) & (idx < lo + int(kernel))).float()


def default_generator(generator, device) -> torch.Generator:
    """``generator``, or where it is None the device's default generator
    (what ``torch.rand`` draws from without one)."""
    if generator is not None:
        return generator
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.default_generators[
            device.index if device.index is not None else torch.cuda.current_device()]
    return torch.default_generator


def rand(shape, generator: torch.Generator | None, device,
         shard=None) -> torch.Tensor:
    """``torch.rand(shape)``; for a ``shard`` of a batch
    (``parallel.mesh.BatchShard``) the draw of the whole batch cut to the
    shard's rows, so a data-sharded step draws what the unsharded step
    draws for those rows."""
    if shard is None:
        return torch.rand(shape, generator=generator, device=device)
    return shard.rand(shape, generator, device)


class Draws:
    """The random draws of one step of a population of T trials.

    Trial t draws from its own generator ``gens[t]`` (None: it draws
    nothing in this step, as in the padded batches of a shorter plan) at
    its own shape: ``rows[t]`` batch rows and the trailing shape a fit of
    it alone has (its own width bucket), so that it draws exactly what that
    fit draws.  For a ``shard`` of the batch the draw is the whole batch's
    cut to the shard's rows (:func:`rand`).  Each draw is one
    ``torch.rand`` per drawing trial: a draw site costs T small launches
    (and one to assemble them, or a fill and a copy a trial where the
    shapes differ), counted by the ``draws.launches`` counter."""

    def __init__(self, gens, rows, device, shard=None):
        self.gens, self.rows = list(gens), [int(r) for r in rows]
        self.device, self.shard = device, shard

    @classmethod
    def one(cls, generator, rows: int, device, shard=None) -> "Draws":
        """One trial's draws from ``generator`` for a batch of ``rows`` rows
        (this shard's; the whole batch is ``shard.total`` of them)."""
        return cls([generator], [shard.total if shard is not None else rows],
                   device, shard)

    def __len__(self):
        return len(self.gens)

    def _trial_shard(self, t):
        return None if self.shard is None else self.shard._replace(
            total=self.rows[t])

    def rand(self, b: int, own, out, live=None) -> torch.Tensor:
        """``[T, b, *out]`` uniforms: trial t's draw of ``(rows[t],
        *own[t])`` values (its rows of this step; ``own[t]`` fits in
        ``out``) in the leading corner, zeros elsewhere and for a trial that
        does not draw (``live[t]`` False, or no generator)."""
        out = tuple(out)
        draws = []
        for t, gen in enumerate(self.gens):
            if gen is None or (live is not None and not live[t]):
                draws.append(None)
                continue
            # without a shard, the trial's own rows; with one, this rank's
            # b rows of the trial's whole batch (zeros past it)
            rows = b if self.shard is not None else self.rows[t]
            draws.append(rand((rows,) + tuple(own[t]), gen, self.device,
                              self._trial_shard(t)))
        drawn = sum(d is not None for d in draws)
        if all(d is not None and d.shape == (b,) + out for d in draws):
            count("draws.launches", drawn + 1)
            return torch.stack(draws)
        count("draws.launches", 2 * drawn + 1)
        u = torch.zeros((len(self), b) + out, device=self.device)
        for t, d in enumerate(draws):
            if d is not None:
                u[(t,) + tuple(slice(0, n) for n in d.shape)] = d
        return u

    def scalar(self) -> torch.Tensor:
        """``[T]``: one uniform per drawing trial (0 for the others)."""
        count("draws.launches", len(self) + 1)
        return torch.stack([
            torch.rand((), generator=g, device=self.device) if g is not None
            else torch.zeros((), device=self.device) for g in self.gens])

    def seeds(self) -> torch.Tensor:
        """``[T]`` int64 kernel keys, one ``randint`` per drawing trial (as
        the JAX package draws the fused kernel's seed from its key)."""
        count("draws.launches", len(self) + 1)
        return torch.stack([
            torch.randint(0, 2 ** 31 - 1, (), generator=g, device=self.device)
            if g is not None else torch.zeros((), dtype=torch.int64,
                                              device=self.device)
            for g in self.gens])


def stack_hps(hp_list, device=None) -> dict:
    """Per-trial concrete hyperparameter dicts -> one dict of ``[T, ...]``
    tensors on ``device`` (the JAX engine's ``stack_trials(hp_list)``, the
    form a vmapped ``apply`` reads them in)."""
    return tree_map(lambda *xs: torch.as_tensor(
        np.stack([np.asarray(x) for x in xs]), device=device), *hp_list)


@dataclasses.dataclass(frozen=True)
class Trials:
    """A population's hyperparameters as one program reads them: ``hp``
    stacked ``[T, ...]`` on the device (:func:`stack_hps`), ``hps`` the
    same per trial on the host (the static decisions: how deep the
    population runs, which trials draw at a layer), ``own`` the statics a
    fit of each trial alone has (its draw shapes; None: the population's),
    and ``draws`` the step's :class:`Draws` (None outside training)."""
    hps: list
    hp: dict
    own: list | None = None
    draws: Draws | None = None

    def __len__(self):
        return len(self.hps)

    def sub(self, key: str) -> "Trials":
        """The trials' sub-dict ``key`` (a branch's hyperparameters)."""
        return dataclasses.replace(self, hps=[h[key] for h in self.hps],
                                   hp=self.hp[key])

    def ints(self, key: str) -> list:
        return [int(h[key]) for h in self.hps]

    def own_shapes(self, key: str, pop, full, shape) -> list:
        """Per trial, ``shape(v)`` of the width its fit alone draws at: its
        own static ``key``, ``full`` (the supernet's) where that fit has
        none, and ``pop`` for all trials where ``own`` is None."""
        if self.own is None:
            return [shape(pop)] * len(self)
        return [shape(o.get(key) or full) for o in self.own]


def one_trial(hp, rows: int, device, generator, train: bool, shard=None):
    """One trial as a population of one, the form every one-trial forward
    and step runs in: ``(trials, stack, unstack)``.  ``trials`` holds
    ``hp`` stacked ``[1, ...]`` on ``device`` and, in training only, the
    trial's :class:`Draws` for a batch of ``rows`` rows (this ``shard``'s)
    from ``generator``: a ``torch.Generator``, an int that seeds one on
    ``device``, or None for the device's default generator.  ``stack``
    puts a tree (tensors or arrays; None stays None) on ``device`` with a
    leading trial axis of one, and ``unstack`` takes the trial out of a
    stacked tree."""
    draws = None
    if train:
        if generator is not None and not isinstance(generator, torch.Generator):
            generator = torch.Generator(device).manual_seed(int(generator))
        draws = Draws.one(default_generator(generator, device), rows, device,
                          shard)

    def stack(tree):
        return None if tree is None else tree_map(
            lambda a: torch.as_tensor(a, device=device)[None], tree)

    def unstack(tree):
        return None if tree is None else tree_map(lambda a: a[0], tree)

    return Trials([hp], stack_hps([hp], device), None, draws), stack, unstack


def dropout_trials(x: torch.Tensor, rate: torch.Tensor, u, train: bool,
                   trial_dim: int = 0) -> torch.Tensor:
    """Inverted dropout of a population's ``x`` (trial axis at
    ``trial_dim``) with per-trial ``rate`` ``[T]`` and uniforms ``u``
    (:meth:`Draws.rand`, laid out as ``x``): the JAX ``dropout`` under
    ``vmap``, ``keep = 1 - rate`` in float32."""
    if not train:
        return x
    shape = [1] * x.dim()
    shape[trial_dim] = -1
    keep = (1.0 - rate.float()).reshape(shape)
    return torch.where(u < keep, x / torch.clamp(keep, min=1e-8),
                       torch.zeros_like(x))


def dropout(x: torch.Tensor, rate, generator: torch.Generator | None,
            train: bool, shard=None) -> torch.Tensor:
    """Inverted dropout, torch semantics, drawn from ``generator`` (a
    ``torch.Generator`` on ``x``'s device) by global row (:func:`rand`)."""
    if not train:
        return x
    keep = 1.0 - float(rate)
    mask = rand(x.shape, generator, x.device, shard) < keep
    return torch.where(mask, x / max(keep, 1e-8), torch.zeros_like(x))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           compute_dtype=None) -> torch.Tensor:
    """y = x @ w + b with the precision contract of the module docstring;
    for a population, ``x[T, B, in] @ w[T, in, out] + b[T, out]`` (one
    batched product).

    In bf16 mode the operands are rounded to bf16 and the product is taken
    in float32: a bf16 x bf16 product is exact in float32, so this is bf16
    operands with float32 accumulation, the JAX
    ``preferred_element_type=float32`` form."""
    dt = as_dtype(compute_dtype)
    if dt is not None:
        x = x.to(dt).float()
        w = w.to(dt).float()
    with _highest_matmul_precision():
        # w.to(x.dtype): bf16 live weights (TrainConfig.param_dtype) promote
        # to float32, as JAX promotes a mixed product
        y = trial_matmul(x, w.to(x.dtype))
    return y + (b[:, None, :] if w.dim() == 3 else b)


def conv1d_ncw(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Same-padded 1-D conv, NCW layout (x: [B,C,L], w: [O,I,K]): one trial
    of :func:`conv1d_trials`."""
    return conv1d_trials(x, w[None], compute_dtype)


def _windows(x: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """im2col of a population: ``x[B, T*C, L]`` -> ``[T, C*K, B*L]``, row
    ``c*K + j`` of trial t holding tap j of channel c at every (row,
    position), zero-padded by ``(K-1)//2`` on each side (``w``'s ``(c,
    k)`` order, so ``w[T, O, C*K] @`` it is the convolution).  One pad and
    one gathering copy."""
    b, _, length = x.shape
    pad = (k - 1) // 2
    x = F.pad(x, (pad, pad)).view(b, t, -1, length + 2 * pad)
    return x.unfold(3, k, 1).permute(1, 2, 4, 0, 3).flatten(1, 2).flatten(2)


class _TrialConvGemm(torch.autograd.Function):
    """The float32 convolution of a population as three batched GEMMs a
    trial over im2col windows (:func:`_windows`), all through
    :func:`trial_matmul` at "highest" precision:

    * forward ``y[T, O, B*L] = w[T, O, C*K] @ cols[T, C*K, B*L]``;
    * weight gradient ``dw[T, O, C*K] = dy[T, O, B*L] @ cols^T``, from the
      windows the forward saved (gathering them again was slower on the
      card at every block, PERF.md);
    * input gradient, only where ``x`` needs one: ``dcols[T, C*K, B*L] =
      w^T @ dy`` folded back onto the positions (``F.fold``: each input
      sums its K taps in one fixed order; on the card it took fewer
      launches and less time over the CNN's blocks than the convolution
      of ``dy``'s windows with the flipped weight, PERF.md).

    Every product is a batched GEMM whose per-trial sums cuBLAS takes
    alike for any trial count from 2 up, and a lone trial inside
    :func:`population_invariant` runs as one of two, forward and backward
    alike, so a trial's sums do not depend on its population."""

    @staticmethod
    def forward(ctx, x, w):
        t, o, c, k = w.shape
        b = x.shape[0]
        cols = _windows(x, t, k)
        with _highest_matmul_precision():
            y = trial_matmul(w.reshape(t, o, c * k), cols)
        ctx.invariant, ctx.length = _POPULATION_INVARIANT, x.shape[-1]
        ctx.save_for_backward(cols, w)
        return y.view(t, o, b, -1).permute(2, 0, 1, 3).reshape(b, t * o, -1)

    @staticmethod
    def backward(ctx, dy):
        cols, w = ctx.saved_tensors
        t, o, c, k = w.shape
        b = dy.shape[0]
        dy = dy.reshape(b, t, o, -1).permute(1, 2, 0, 3).reshape(t, o, -1)
        dx = dw = None
        with _highest_matmul_precision(), (population_invariant()
                                           if ctx.invariant else
                                           contextlib.nullcontext()):
            if ctx.needs_input_grad[1]:
                dw = trial_matmul(dy, cols.transpose(1, 2)).view(w.shape)
            if ctx.needs_input_grad[0]:
                dcols = trial_matmul(w.reshape(t, o, c * k).transpose(1, 2),
                                     dy)
                dx = F.fold(dcols, (b, ctx.length), (1, k),
                            padding=(0, (k - 1) // 2))       # [T, C, B, L]
                dx = dx.permute(2, 0, 1, 3).reshape(b, t * c, -1)
        return dx, dw


#: the least window depth C*K a float32 population convolution takes as
#: GEMMs: below it (the one-hot input's 4 channels x 15 taps is 60) the
#: weight gradient is a thin C*K x O product summed over every position,
#: which cuBLAS takes at a few % of peak, and cuDNN's own kernels were
#: faster on the card in both directions (PERF.md)
_GEMM_MIN_DEPTH = 128


def conv1d_trials(x: torch.Tensor, w: torch.Tensor,
                  compute_dtype=None) -> torch.Tensor:
    """:func:`conv1d_ncw` of every trial at once: ``x[B, T*C, L]`` (trial
    t's channels at ``[t*C, (t+1)*C)``) and ``w[T, O, C, K]`` -> ``[B,
    T*O, L]`` under the same precision contract.

    A float32 population (T > 1, or a lone trial inside
    :func:`population_invariant`) whose windows are at least
    ``_GEMM_MIN_DEPTH`` deep (``C*K``) runs as per-trial batched
    GEMMs over im2col windows (:class:`_TrialConvGemm`, counted by
    ``conv.gemm``): cuDNN's grouped convolution is slow there, its
    deterministic float32 backward most of all.  Every other call (one
    model's serving, every bf16 call, a thin first block) is one grouped
    convolution (``F.conv1d``, ``groups=T``: cuDNN on the card)."""
    t, o, c, k = w.shape
    dt = as_dtype(compute_dtype)
    if (dt is None and (t > 1 or _POPULATION_INVARIANT)
            and c * k >= _GEMM_MIN_DEPTH):
        count("conv.gemm")
        return _TrialConvGemm.apply(x, w.to(x.dtype))
    if _POPULATION_INVARIANT and t == 1 and x.device.type == "cpu":
        # a lone trial as one of two groups: the CPU's weight gradient of
        # one group sums in another order than that of several
        return conv1d_trials(x.repeat(1, 2, 1), w.expand(2, *w.shape[1:]),
                             compute_dtype)[:, :o]
    w = w.reshape(t * o, c, k)
    pad = (k - 1) // 2
    if dt is not None:
        return F.conv1d(x.to(dt), w.to(dt), padding=pad, groups=t).float()
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        return F.conv1d(x, w.to(x.dtype), padding=pad, groups=t)


def maxpool1d(x: torch.Tensor, kernel: int = 10, stride: int = 2) -> torch.Tensor:
    """torch MaxPool1d(kernel, stride), floor mode. x: [B, C, L]."""
    return F.max_pool1d(x, kernel_size=kernel, stride=stride)


# ---------------------------------------------------------------------------
# BatchNorm1d with torch semantics + padding-row masking
# ---------------------------------------------------------------------------

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def batchnorm_init(n_channels: int):
    params = {"scale": torch.ones(n_channels), "bias": torch.zeros(n_channels)}
    state = {"mean": torch.zeros(n_channels), "var": torch.ones(n_channels)}
    return params, state


def batchnorm_apply(x, params, state, train: bool, row_mask=None, shard=None):
    """BatchNorm1d over [B, C, L] (stats over B and L per channel).

    ``row_mask`` ([B]) excludes padded rows from the batch statistics so a
    padded static batch normalises identically to a ragged one.  For a
    ``shard`` of a data-sharded batch the moments are sums over the data
    axis (differentiable all-reduces, as SyncBatchNorm's).  Running stats
    use the unbiased variance, torch-style.  Returns (y, new_state).  One
    trial of :func:`batchnorm_trials`.
    """
    y, new = batchnorm_trials(
        x[:, None], {k: v[None] for k, v in params.items()},
        {k: v[None] for k, v in state.items()}, train,
        None if row_mask is None else row_mask[None], shard)
    return y[:, 0], {k: v[0] for k, v in new.items()}


def batchnorm_trials(x, params, state, train: bool, row_mask=None,
                     shard=None):
    """BatchNorm1d of every trial at once over ``x[B, T, C, L]`` (stats
    over B and L per trial and channel); ``params`` / ``state`` leaves are
    ``[T, C]`` and ``row_mask`` ``[T, B]``.  Per trial, what
    :func:`batchnorm_apply` computes; under a ``shard`` each moment is one
    sum over the data axis for all trials.  Returns (y, new_state)."""
    scale = params["scale"][None, :, :, None]
    bias = params["bias"][None, :, :, None]
    if not train:
        mean, var = state["mean"], state["var"]
        inv = torch.rsqrt(var + BN_EPS)
        y = (x - mean[None, :, :, None]) * inv[None, :, :, None]
        return y * scale + bias, state

    if row_mask is None:
        row_mask = torch.ones((x.shape[1], x.shape[0]), device=x.device)
    m = row_mask.float().t()[:, :, None, None]                  # [B, T, 1, 1]
    sum_x, count = (x * m).sum(dim=(0, 3)), m.sum(dim=(0, 2, 3))
    if shard is not None:
        sum_x, count = shard.sum(sum_x, count)
    n = torch.clamp(count * x.shape[-1], min=1.0)[:, None]      # [T, 1]
    mean = sum_x / n
    sq = (((x - mean[None, :, :, None]) ** 2) * m).sum(dim=(0, 3))
    if shard is not None:
        sq = shard.sum(sq)
    var = sq / n
    inv = torch.rsqrt(var + BN_EPS)
    y = (x - mean[None, :, :, None]) * inv[None, :, :, None]
    unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
    new_state = {
        "mean": (1 - BN_MOMENTUM) * state["mean"] + BN_MOMENTUM * mean,
        "var": (1 - BN_MOMENTUM) * state["var"] + BN_MOMENTUM * unbiased,
    }
    return y * scale + bias, new_state
