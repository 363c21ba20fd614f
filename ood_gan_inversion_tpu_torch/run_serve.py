"""Micro-batching inference server CLI of the port (counterpart of
run_serve.py):

python -m ood_gan_inversion_tpu_torch.run_serve \
    --opt options/test/E4E_Face_test.yml [--weights state_dict.pt] \
    [--device cuda] [--host 127.0.0.1] [--port 8471] [--max-batch 8] \
    [--max-wait-ms 5] [--split-below N] [--max-inflight 2] [--warmup]

POST /invert with a raw float32 (H, W, 3) [0, 1] body and an `x-shape`
header; GET /stats for the batching counters (serve.py). Without --weights
the weights are drawn from a seed. The arch's dtype is the option file's
`network_g: dtype`, e.g. bfloat16.
"""

import argparse
import asyncio

import torch

from .infer import InversionEngine
from .serve import BatchingServer
from .utils.options import load_yaml

# Below this group size a coalesced group is decoded request by request
# rather than as one padded batch (BatchingServer's split_below). From the
# batch curve on an NVIDIA H100 80GB HBM3 at 700 W, bfloat16, 1024px, with
# the batched forward bit for bit the lone requests' (chip_smoke.py:
# phase_batched, PERF.md section 5): no batch size lost to separate batch-1
# calls (b = 2: 152.0 against 176.9 ms), so the policy is off.
SPLIT_BELOW = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", required=True)
    ap.add_argument("--weights", default=None,
                    help="a torch.save'd state_dict of the arch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8471)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--split-below", type=int, default=SPLIT_BELOW,
                    help="decode coalesced groups smaller than this request by "
                         "request (0 disables; the default comes from the "
                         "card's batch curve, PERF.md)")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="coalesced batches in flight at once; 2 overlaps the "
                         "host's work on one batch with the card's on the "
                         "previous one (1 = lockstep); above 1 implies --warmup")
    ap.add_argument("--warmup", action="store_true",
                    help="run every batch shape once before taking traffic")
    args = ap.parse_args(argv)
    with open(args.opt) as f:
        opt = load_yaml(f)
    params = (torch.load(args.weights, map_location="cpu", weights_only=True)
              if args.weights else None)
    engine = InversionEngine(opt, params=params, device=args.device)
    srv = BatchingServer(engine, max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         split_below=args.split_below,
                         max_inflight=args.max_inflight)
    if args.warmup or args.max_inflight > 1:
        print(f"warmed batch shapes: {srv.warmup()}", flush=True)
    print(f"serving on {args.host}:{args.port} (max_batch={args.max_batch}, "
          f"wait={args.max_wait_ms} ms, dtype={engine.dtype}, "
          f"samm_body0={engine.samm_body0}, device={engine.device})", flush=True)
    asyncio.run(srv.serve_http(args.host, args.port))


if __name__ == "__main__":
    main()
