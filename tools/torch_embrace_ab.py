"""Device time of one checkout's fused embrace kernels, for comparing two
commits on one card and the full-E kernel's cluster widths.

    python3 tools/torch_embrace_ab.py [--root DIR] [--label NAME]
        [--batches 4096,1920] [--bm 128] [--widths]

Imports ``embracenet_tpu_torch`` from the checkout at ``DIR`` (this one by
default), builds its kernels there, and prints one JSON line per shape and
operand type: the tiled kernel's device time (``fused_embrace``, 20 calls
replayed from a CUDA graph, ``benchkit.graph_ms``) and, where the checkout
has a full-E plan (``ops.embrace.fulle_plan``), the full-E kernel's, each
with its launch plan.  The shapes are those of ``chip_smoke.py``'s kernel
phase, or with ``--batches`` those batches at D0=256, D1=7936, E=1024.
``--bm`` sets both kernels' tile rows (the tiled kernel unsplit); with
``--widths`` the full-E kernel is also timed at every cluster width of 8 or
less that divides its column tiles (``fulle_c{c}_device_ms``).  To compare
two checkouts, run it for each in turns (parent, change, change, parent) in
one call on one card.  Every line also carries a SHA-256 digest of one
call's ``out`` and ``choose`` (``tiled_digest``, ``fulle_digest``; inputs and
seed are fixed), so two checkouts are held equal bit for bit by comparing
digests.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

# the kernel phase's shapes (B, D0, D1, E): serving, ragged, training,
# evaluation, engine_bench's batches and 1024, and three edge shapes
SHAPES = ((4096, 256, 7936, 1024), (100, 200, 5568, 768), (100, 256, 7936, 1024),
          (200, 256, 7936, 1024), (800, 256, 7936, 1024), (1024, 256, 7936, 1024),
          (2048, 256, 7936, 1024), (1, 4, 1024, 512), (63, 16, 3200, 768),
          (65, 64, 1000, 768))


def digest(outs) -> str:
    """SHA-256 of the bytes of a call's ``(out, choose)``."""
    import torch

    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package is timed")
    ap.add_argument("--label", default="", help="tag of every line printed")
    ap.add_argument("--batches", help="comma-separated B at D0=256, D1=7936, "
                    "E=1024 in place of the kernel phase's shapes")
    ap.add_argument("--bm", type=int, choices=(64, 128),
                    help="tile rows of both kernels (the tiled one unsplit)")
    ap.add_argument("--widths", action="store_true",
                    help="time the full-E kernel at every cluster width too")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from embracenet_tpu_torch.benchkit import graph_ms, nvidia_smi
    from embracenet_tpu_torch.ops import embrace as K

    if not torch.cuda.is_available():
        print("torch_embrace_ab: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    index = torch.cuda.current_device()
    card = nvidia_smi()
    fulle = hasattr(K, "fulle_plan")
    tiled_plan, fulle_plan, width = K.card_plan, getattr(K, "card_fulle_plan", None), {}
    if args.bm:
        def rows(plan, B):
            return plan._replace(bm=args.bm, row_tiles=-(-B // args.bm))
        K.card_plan = lambda B, *a: rows(tiled_plan(B, *a), B)._replace(split=1)
        if fulle:
            K.card_fulle_plan = lambda B, *a: rows(fulle_plan(B, *a), B)
    if fulle:
        chosen = K.card_fulle_plan
        K.card_fulle_plan = lambda *a: chosen(*a)._replace(
            cluster=width.get("c") or chosen(*a).cluster)
    shapes = (tuple((int(b), 256, 7936, 1024) for b in args.batches.split(","))
              if args.batches else SHAPES)
    for B, D0, D1, E in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(0)

            def randn(*s, scale=1.0):
                return torch.randn(*s, generator=gen, device=dev) * scale

            ins = (torch.relu(randn(B, D0)).to(dtype),
                   torch.relu(randn(B, D1)).to(dtype),
                   randn(D0, E, scale=D0 ** -0.5).to(dtype), randn(E, scale=0.1),
                   randn(D1, E, scale=D1 ** -0.5).to(dtype), randn(E, scale=0.1),
                   torch.rand(B, generator=gen, device=dev), torch.ones(E, device=dev))
            plan = K.card_plan(B, E, D0, D1, dtype, index)
            row = {"label": args.label, "shape": [B, D0, D1, E],
                   "dtype": str(dtype).split(".")[-1],
                   "tiled_plan": [plan.bm, plan.split],
                   "tiled_digest": digest(K.fused_embrace(*ins, 3)),
                   "tiled_device_ms": graph_ms(lambda: K.fused_embrace(*ins, 3))}
            if fulle:
                fplan = K.card_fulle_plan(B, E, D0, D1, dtype, index)
                row["fulle_plan"] = [fplan.bm, fplan.cluster]
                row["fulle_digest"] = digest(K.fused_embrace_fulle(*ins, 3))
                row["fulle_device_ms"] = graph_ms(
                    lambda: K.fused_embrace_fulle(*ins, 3))
                for c in range(1, K.MAX_SPLIT + 1) if args.widths else ():
                    if fplan.col_tiles % c == 0:
                        width["c"] = c
                        row[f"fulle_c{c}_device_ms"] = graph_ms(
                            lambda: K.fused_embrace_fulle(*ins, 3))
                width.clear()
            row["card"] = card
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
