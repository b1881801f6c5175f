#!/usr/bin/env python
"""Multi-device sweep on the PyTorch port: the production path over a mesh
of processes (the port of ``examples/multichip_sweep.py``).

The reference trains its cells x tasks x models grid sequentially on one
GPU; here every K-fold CV's HPO population and retrain shard over a
``('trial', 'data')`` mesh whose ranks are processes, one per device
(``embracenet_tpu_torch/parallel/mesh.py``):

  torchrun --nproc-per-node N examples/torch_multichip_sweep.py
      # N GPUs of one host, NCCL; add --backend gloo for N ranks on one card
  python examples/torch_multichip_sweep.py --cpu-procs 4
      # a gloo world of 4 processes on the CPU

``mesh="auto"`` puts every rank on the 'trial' axis, and ``KfoldCV``
prefers the fold-fused path under a mesh, so the population the mesh
shards is every fold's.  Every rank runs the same sweep; rank 0 alone
writes results, studies and checkpoints, and prints.
"""

import argparse
import os
import sys
import tempfile
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

TASK = "active_P_vs_inactive_P"


def data_fn(cell, task):
    """Synthetic stand-in for pipelines from ``sweep.preprocess_all(root)``
    (the JAX example's data, seeded by a digest of the cell and task)."""
    r = np.random.default_rng(zlib.crc32(f"{cell}/{task}".encode()) % 2 ** 31)
    n, d = 400, 16
    y = (r.random(n) < 0.3).astype(np.int64)
    w = r.normal(size=d)
    x = (r.normal(size=(n, d)) + np.outer(y * 2.0 - 1.0, w) * 0.7).astype(np.float32)
    return {"ffnn": x, "y": y}


def run_rank(args) -> int:
    """One rank of the world that ``torchrun`` (or ``--cpu-procs``) set up."""
    import torch
    import torch.distributed as dist

    from embracenet_tpu_torch import sweep
    from embracenet_tpu_torch.config import CVConfig, TrainConfig
    from embracenet_tpu_torch.parallel.mesh import init_distributed

    init_distributed(backend=args.backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    if rank == 0:
        print(f"world: {world} ranks, backend {dist.get_backend()}, {device}",
              flush=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        results = sweep.run_sweep(
            data_fn=data_fn, cells=args.cells, tasks=[TASK], models=("FFNN",),
            cv_cfg=CVConfig(n_folds=3, n_trials=4, sampler="random",
                            fuse_folds=None),      # mesh => fused
            train_cfg=TrainConfig(num_epochs=3, epoch_chunk=3,
                                  batch_size=100, width_buckets=True),
            results_path=os.path.join(td, "results_dict.json"),
            storage=os.path.join(td, "study.db"),
            checkpoint_dir=td, verbose=rank == 0,
            mesh="auto", device=device)           # all ranks on 'trial'
        if rank == 0:
            for cell in args.cells:
                entry = results.get(cell, TASK, "FFNN")
                print(f"{cell}: average_CV_AUPRC="
                      f"{entry['average_CV_AUPRC']:.4f}", flush=True)
    if rank == 0:
        print(f"done in {time.time() - t0:.1f}s", flush=True)
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="*", default=["K562", "GM12878"])
    ap.add_argument("--cpu-procs", type=int, default=0,
                    help="spawn a gloo world of this many CPU processes")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl on CUDA, "
                         "gloo on the CPU)")
    ap.add_argument("--device", default=None,
                    help="device type of every rank (default: the card)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds before a spawned world is killed")
    args = ap.parse_args(argv)
    if not args.cpu_procs:
        return run_rank(args)
    from embracenet_tpu_torch.parallel.mesh import launch_local

    outs = launch_local([os.path.abspath(__file__), "--cells", *args.cells,
                         "--backend", "gloo", "--device", "cpu"],
                        args.cpu_procs, args.timeout)
    print(outs[0][1], end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
