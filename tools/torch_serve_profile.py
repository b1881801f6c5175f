#!/usr/bin/env python
"""Where does a serving request of the PyTorch port spend its time on the
card?

Builds the widest EmbraceNetMultimodal of the search space (the model
``chip_smoke.py`` serves: random weights from seed 0, 566 tabular
features), saves it, and for each serving variant

  fused / unfused   docking + embracement in the CUDA kernel, or as two
                    cuBLAS products and a torch select
  float32 / bf16    ``compute_dtype`` None or "bfloat16"

times ``load_model`` and a loaded model's call on 10,000 windows (host
clock, after a warm-up call), then profiles one call with
``torch.profiler`` and sums device time by kernel family (convolution,
matrix product, the fused embrace kernel, other).  The device's busy share
is the summed kernel time over the unprofiled call's wall.  One JSON line
per variant, with the card's name and power limit.

    python3 tools/torch_serve_profile.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from embracenet_tpu_torch.benchkit import (IN_FEATURES, nvidia_smi,  # noqa: E402
                                           widest_flat_params)
from embracenet_tpu_torch.hpo import space  # noqa: E402
from embracenet_tpu_torch.models import embracenet  # noqa: E402
from embracenet_tpu_torch.models.reload import load_model  # noqa: E402
from embracenet_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402

N_WINDOWS = 10_000
FAMILIES = (("embrace", ("embrace_fused_fwd",)),
            ("conv", ("conv", "fprop", "implicit", "winograd", "fft")),
            ("matmul", ("gemm", "sgemm", "cutlass", "matmul", "xmma")))


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def device_times(prof) -> dict:
    """Milliseconds of device activity (kernels, copies) by family."""
    out: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        fam = family(evt.key)
        out[fam] = out.get(fam, 0.0) + us / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    card = nvidia_smi()
    rng = np.random.default_rng(0)
    data = {"ffnn": rng.normal(size=(N_WINDOWS, IN_FEATURES)).astype(np.float32),
            "cnn": rng.integers(0, 4, size=(N_WINDOWS, 256), dtype=np.uint8)}
    flat = widest_flat_params(0.5)
    hp = space.params_to_hp("EmbraceNetMultimodal", flat)
    params, bn = embracenet.init(torch.Generator().manual_seed(0), hp, IN_FEATURES)
    build = os.path.join(REPO, "embracenet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as workdir:
        path = os.path.join(workdir, "embracenet")
        save_checkpoint(path, {"params": params, "bn_state": bn},
                        {"model": "EmbraceNetMultimodal", "model_params": flat})
        for compute_dtype in (None, "bfloat16"):
            for fused in (True, False):
                t0 = time.perf_counter()
                model = load_model(path, compute_dtype=compute_dtype,
                                   fused_embrace=fused)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                model(data)
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    model(data)
                    walls.append(time.perf_counter() - t0)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    model(data)
                dev = device_times(prof)
                wall = min(walls)
                print(json.dumps({
                    "variant": {"fused": fused,
                                "compute_dtype": compute_dtype or "float32"},
                    "windows": N_WINDOWS, "load_s": load_s,
                    "call_s": walls, "windows_per_s": N_WINDOWS / wall,
                    "device_ms": dev, "device_ms_total": sum(dev.values()),
                    "busy_share": sum(dev.values()) / 1e3 / wall,
                    "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
