"""Device mesh and the collectives of a sharded fit (port of
``embracenet_tpu/parallel/mesh.py``).

The scale axes are the JAX package's:

  * ``trial`` — hyperparameter-population parallelism: each rank trains its
    block of the population; trials never communicate, so a fit sends
    nothing over this axis until it gathers the per-trial results.
  * ``data``  — batch parallelism inside each trial: a batch plan's columns
    are split over the ranks of the axis, and every reduction over the
    batch (INS loss weights and normaliser, masked BatchNorm moments,
    metric counts, the gradients) becomes a sum over the axis' group.
  * ``dcn``   — an optional leading axis across hosts; the population
    shards over ('dcn', 'trial'), so no collective of a training step
    crosses it.

Each rank is one process driving one device, and every rank runs the same
program (SPMD), the idiom of ``torch.distributed``: a mesh of more than one
rank needs an initialised process group (:func:`init_distributed`, or
``torchrun``) whose size is the mesh's.  A 1 x 1 mesh needs none.  Under a
process group, :class:`Mesh` wraps a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``
``("trial", "data")`` or ``("dcn", "trial", "data")``.

Stated divergence: every mesh here spans processes, so each rank holds the
whole population's hyperparameters and a population that the trial axes
do not divide is padded with copies of its last trial on any mesh (the JAX
package raises on a multi-process mesh).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from embracenet_tpu_torch.config import MeshConfig
from embracenet_tpu_torch.convert import tree_map


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None):
    """Join a world of processes (call before building a mesh).

    With no arguments it reads what ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as
    ``jax.distributed.initialize()`` discovers its world.
    ``coordinator_address`` is ``host:port``.  ``backend`` defaults to
    ``"nccl"`` where CUDA is available and ``"gloo"`` elsewhere; ``"gloo"``
    on CUDA serves several ranks on one card, which NCCL refuses.  A CUDA
    process first takes device ``LOCAL_RANK % device_count``."""
    env = os.environ
    try:
        if coordinator_address is None:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
    except KeyError as err:
        raise ValueError(f"init_distributed: {err.args[0]} is not set; pass "
                         "coordinator_address, num_processes and process_id, "
                         "or launch with torchrun") from None
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank(process_id) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def local_rank(rank: int | None = None) -> int:
    """This process' rank on its host: ``LOCAL_RANK`` where a launcher set
    it, else its global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is not None:
        return rank
    return dist.get_rank() if _distributed() else 0


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def mesh_shape(n: int, n_trial: int | None = None, n_data: int | None = None,
               n_dcn: int | None = None) -> dict:
    """``{axis: size}`` of a mesh over ``n`` ranks: the JAX ``make_mesh``'s
    defaults (all ranks on 'trial') and its ``ValueError`` s."""
    if n_dcn is not None and n_dcn > 1:
        per = n // n_dcn
        if n_dcn * per != n:
            raise ValueError(f"{n} devices not divisible by n_dcn={n_dcn}")
        if n_trial is None and n_data is None:
            n_trial, n_data = per, 1
        elif n_trial is None:
            n_trial = per // n_data
        elif n_data is None:
            n_data = per // n_trial
        if n_trial * n_data != per:
            raise ValueError(
                f"mesh dcn={n_dcn} x {n_trial}x{n_data} != {n} devices")
        return {"dcn": n_dcn, "trial": n_trial, "data": n_data}
    if n_trial is None and n_data is None:
        n_trial, n_data = n, 1
    elif n_trial is None:
        n_trial = n // n_data
    elif n_data is None:
        n_data = n // n_trial
    if n_trial * n_data != n:
        raise ValueError(f"mesh {n_trial}x{n_data} != {n} devices")
    return {"trial": n_trial, "data": n_data}


class Mesh:
    """Ranks laid out over named axes; this process is one of them.

    ``shape``: ``{axis: size}`` in axis order (as JAX's ``mesh.shape``);
    ``axis_names``; ``ranks``: the global ranks in that layout; ``rank`` and
    ``coords`` (``{axis: index}``) of this process; ``device``: the device
    it drives; ``group(axis)``: the process group of the ranks that share
    this process' other coordinates (None on a mesh without a process
    group)."""

    def __init__(self, ranks: np.ndarray, axis_names, device: torch.device,
                 device_mesh=None):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.rank = dist.get_rank() if device_mesh is not None else 0
        where = np.argwhere(self.ranks == self.rank)[0]
        self.coords = dict(zip(self.axis_names, (int(i) for i in where)))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def group(self, axis: str):
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)


def make_mesh(n_trial: int | None = None, n_data: int | None = None,
              devices=None, n_dcn: int | None = None,
              device_type: str | None = None) -> Mesh:
    """Build a ('trial', 'data') — or ('dcn', 'trial', 'data') — mesh.

    Defaults as the JAX function: all ranks on 'trial'; ``n_dcn`` > 1 adds
    a leading cross-host axis.  ``devices``: global ranks in mesh order
    (all ranks of the world by default; the mesh covers the whole world).
    ``device_type``: ``"cuda"`` (rank r drives ``cuda:{LOCAL_RANK %
    device_count}``) or ``"cpu"``; by default the card where there is one.
    Every rank of the world calls this at the same point (it creates the
    axes' process groups)."""
    asked = (n_trial or 1) * (n_data or 1) * (n_dcn or 1)
    if not _distributed() and (asked > 1 or len(devices or [0]) > 1):
        raise ValueError("a mesh of more than one rank needs a process group: "
                         "call parallel.mesh.init_distributed in every rank, "
                         "or launch with torchrun")
    world = dist.get_world_size() if _distributed() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    shape = mesh_shape(len(ranks), n_trial, n_data, n_dcn)
    if _distributed() and sorted(ranks) != list(range(world)):
        raise ValueError(f"the mesh's ranks {ranks} must be the world's "
                         f"{world} ranks, each once")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    device = (torch.device("cuda", local_rank() % torch.cuda.device_count())
              if device_type == "cuda" else torch.device(device_type))
    arr = np.asarray(ranks).reshape(tuple(shape.values()))
    dm = None
    if _distributed():
        from torch.distributed.device_mesh import DeviceMesh

        if device.type == "cuda":
            torch.cuda.set_device(device)
        dm = DeviceMesh(device.type, torch.as_tensor(arr),
                        mesh_dim_names=tuple(shape))
    return Mesh(arr, tuple(shape), device, dm)


def resolve_mesh(mesh, device=None):
    """Normalise a mesh argument as the JAX package's ``resolve_mesh``:
    None, a 1 x 1 :class:`MeshConfig` and ``"auto"`` in a world of one
    process -> None (the single-device path); ``"auto"`` in a larger world
    -> every rank on 'trial'; ``MeshConfig(t, d)`` -> ``make_mesh(t, d)``; a
    :class:`Mesh` passes through.  A ``device`` whose type is not the
    mesh's raises ``ValueError``."""
    want = None if device is None else torch.device(device).type
    if mesh is None:
        return None
    if mesh == "auto":
        world = dist.get_world_size() if _distributed() else 1
        mesh = make_mesh(world, 1, device_type=want) if world > 1 else None
    elif isinstance(mesh, MeshConfig):
        if mesh.trial_axis * mesh.data_axis <= 1:
            return None
        mesh = make_mesh(mesh.trial_axis, mesh.data_axis, device_type=want)
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: expected a Mesh, a MeshConfig, "
                        "'auto' or None")
    if mesh is not None and want is not None and mesh.device.type != want:
        raise ValueError(f"device={device!r} contradicts the mesh's device "
                         f"{mesh.device}")
    return mesh


def trial_axes(mesh: Mesh):
    """The axes the population shards over (('dcn','trial') on multi-host)."""
    return ("dcn", "trial") if "dcn" in mesh.axis_names else ("trial",)


def trial_device_count(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in trial_axes(mesh)]))


def trial_block(mesh: Mesh) -> int:
    """This rank's block index along the trial axes."""
    return mesh.coords.get("dcn", 0) * mesh.shape["trial"] + mesh.coords["trial"]


def trial_sharding(mesh: Mesh, n_trials: int) -> slice:
    """This rank's trials of a population of ``n_trials`` (a multiple of
    :func:`trial_device_count`)."""
    per, rem = divmod(n_trials, trial_device_count(mesh))
    if rem:
        raise ValueError(f"population size {n_trials} not divisible by mesh "
                         f"trial axes {trial_device_count(mesh)}")
    b = trial_block(mesh)
    return slice(b * per, (b + 1) * per)


def batch_sharding(mesh: Mesh, width: int) -> slice:
    """This rank's columns of a batch-plan row of ``width``: the width is
    padded to a multiple of the 'data' axis, so the slice may reach past
    ``width`` (the caller pads the plan with masked columns)."""
    n = mesh.shape["data"]
    per = -(-width // n)
    k = mesh.coords["data"]
    return slice(k * per, (k + 1) * per)


def replicated(mesh: Mesh, tree):
    """Data every rank holds whole: the tree itself."""
    del mesh
    return tree


def shard_population(mesh: Mesh | None, *args):
    """Each argument cut to this rank's trials (all of them without a
    mesh): a sequence with one entry per trial (list, array, tensor), or a
    tree of nested dicts and lists whose leaves are stacked over trials
    (lists inside a tree are nodes, as in ``convert.tree_map``)."""
    if mesh is None:
        return args

    def cut(a):
        return a[trial_sharding(mesh, len(a))]
    return tuple(tree_map(cut, a) if isinstance(a, dict) else cut(a)
                 for a in args)


def global_from_host_local(tree, mesh: Mesh, axis: str | None = None):
    """This rank's piece of ``tree``, which every process holds whole: its
    trials along the leading axis where ``axis == "trial"``, its batch
    columns along the last axis where ``axis == "data"`` (padded with zeros
    to the data axis' multiple), the whole tree where ``axis`` is None."""
    if axis is None:
        return replicated(mesh, tree)
    if axis == "trial":
        return shard_population(mesh, tree)[0]
    if axis != "data":
        raise ValueError(f"axis {axis!r}: 'trial', 'data' or None")

    def cols(a):
        a = torch.as_tensor(a)
        c = batch_sharding(mesh, a.shape[-1])
        pad = c.stop - a.shape[-1]
        if pad > 0:
            a = torch.nn.functional.pad(a, (0, pad))
        return a[..., c]
    if isinstance(tree, dict):
        return {k: global_from_host_local(v, mesh, axis) for k, v in tree.items()}
    return cols(tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; its gradient is the same sum of the
    incoming gradients (as SyncBatchNorm's reductions)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(group, *xs):
    """The sums over ``group`` of the tensors ``xs`` (of one dtype) in one
    all-reduce, differentiable: one tensor, or a tuple for several.  Every
    rank of the group calls it with tensors of the same shapes."""
    if len(xs) == 1:
        return _AllReduceSum.apply(xs[0], group)
    flat = _AllReduceSum.apply(torch.cat([x.reshape(-1) for x in xs]), group)
    return tuple(o.view(x.shape) for o, x in
                 zip(flat.split([x.numel() for x in xs]), xs))


class BatchShard(NamedTuple):
    """One rank's rows ``[lo, lo + b)`` of a batch of ``total`` rows split
    ``n`` ways over the data axis' ``group`` (the last shards may reach
    past ``total``: masked padding).  A model's random draws and batch
    reductions go through it, so a shard computes what the whole batch
    computes for its rows.  A population's stacked step sums each of its
    quantities (``[T, ...]``: every local trial's) in one all-reduce, and
    each trial draws at its own batch rows (``models.layers.Draws`` gives
    this shard a copy with ``total`` = the trial's rows)."""
    lo: int
    total: int
    n: int
    group: Any

    def rand(self, shape, generator, device) -> torch.Tensor:
        """``torch.rand(shape)`` for the shard's rows: drawn at the whole
        batch's shape (``total`` rows, so the generator advances as the
        unsharded draw does) and cut to rows ``[lo, lo + shape[0])``; rows
        past ``total`` are zeros."""
        b = shape[0]
        u = torch.rand((self.total,) + tuple(shape[1:]), generator=generator,
                       device=device)[self.lo:self.lo + b]
        if u.shape[0] < b:
            u = torch.cat([u, u.new_zeros((b - u.shape[0],) + u.shape[1:])])
        return u

    def sum(self, *xs):
        """:func:`all_reduce_sum` over the data axis."""
        return all_reduce_sum(self.group, *xs)

    def gather(self, *xs):
        """The whole batch's rows (``total`` of them, padding dropped) of
        each equally long per-shard tensor: an all-reduce of zero-filled
        copies (gloo's CUDA support has no all-gather; adding zeros is
        exact)."""
        b = xs[0].shape[0]
        buf = torch.zeros((len(xs), self.n * b) + tuple(xs[0].shape[1:]),
                          dtype=torch.float32, device=xs[0].device)
        for i, x in enumerate(xs):
            buf[i, self.lo:self.lo + b] = x.float()
        with torch.no_grad():
            dist.all_reduce(buf, group=self.group)
        out = tuple(buf[i, :self.total].to(x.dtype) for i, x in enumerate(xs))
        return out if len(out) > 1 else out[0]


def gather_trials(mesh: Mesh, local) -> list:
    """Every trial block's ``local`` (anything picklable) in trial order,
    from the ranks at data coordinate 0, on every rank.  Tensors travel as
    host copies: the caller gives and gets CPU data."""
    if mesh.size == 1:
        return [local]
    out = [None] * mesh.size
    dist.all_gather_object(out, local)
    return [out[int(r)] for r in mesh.ranks.reshape(-1, mesh.shape["data"])[:, 0]]


def is_writer(mesh) -> bool:
    """Whether this process writes files: always without a mesh; rank 0
    alone under one."""
    return mesh is None or mesh.rank == 0


def barrier(mesh):
    """Every rank of the mesh waits here (nothing without a process group)."""
    if mesh is not None and mesh.size > 1:
        dist.barrier()


def broadcast(mesh, obj):
    """Rank 0's ``obj`` (anything picklable) on every rank of the mesh."""
    if mesh is None or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ---------------------------------------------------------------------------
# launching a world of processes on one host
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port of this host that nothing listens on (for the world's
    rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(argv, nprocs: int, timeout: float, env: dict | None = None,
                 cwd: str | None = None) -> list:
    """Run ``python argv...`` as ranks 0..nprocs-1 of one world on this
    host, as ``torchrun --nproc-per-node nprocs`` would (``MASTER_ADDR``,
    ``MASTER_PORT`` on a free port, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), and wait for all of them.  Returns each rank's
    ``(returncode, stdout, stderr)``.  A rank that fails raises
    ``RuntimeError`` with its errors; a world still running after
    ``timeout`` seconds, or whose other ranks wait for a failed one, is
    killed first."""
    port = free_port()
    procs, logs = [], []
    for r in range(nprocs):
        e = dict(os.environ, **(env or {}), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), WORLD_SIZE=str(nprocs), RANK=str(r),
                 LOCAL_RANK=str(r))
        # files, not pipes: a rank that prints more than a pipe holds
        # would block before it exits
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        logs.append((out, err))
        procs.append(subprocess.Popen([sys.executable, *argv], env=e, cwd=cwd,
                                      stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout

    def result(r):
        out, err = logs[r]
        out.seek(0)
        err.seek(0)
        return procs[r].returncode, out.read(), err.read()
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() is not None and p.returncode != 0]
            if failed:
                # a rank died: the others would wait for it at a collective
                time.sleep(2.0)
                if any(p.poll() is None for p in procs):
                    code, _, err = result(failed[0])
                    raise RuntimeError(f"rank {failed[0]} of {nprocs} failed "
                                       f"(exit {code}):\n{err[-4000:]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"a world of {nprocs} processes ran past "
                                   f"its {timeout:.0f} s limit: killed")
            time.sleep(0.05)
        outs = [result(r) for r in range(nprocs)]
        for r, (code, _, err) in enumerate(outs):
            if code != 0:
                raise RuntimeError(f"rank {r} of {nprocs} failed (exit {code}):"
                                   f"\n{err[-4000:]}")
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out, err in logs:
            out.close()
            err.close()
