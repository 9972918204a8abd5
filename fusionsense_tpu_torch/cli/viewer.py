"""fs-viewer in the port: serve a trained model in the embedded WebGL splat
viewer.

    python -m fusionsense_tpu_torch.cli.viewer --ply outputs/scene/splat.ply
    python -m fusionsense_tpu_torch.cli.viewer --checkpoint outputs/scene/ckpt_15000
    python -m fusionsense_tpu_torch.cli.train ... --viewer   # live while training

The flags are those of fusionsense_tpu's fs-viewer. The model is read onto
the card (a splat PLY through gaussians/io.import_splat_ply, a checkpoint
through train/checkpoint.load_for_inference) and packed on the host; the
server runs until interrupted.
"""
from __future__ import annotations

import argparse
import time


def build_parser():
    ap = argparse.ArgumentParser("fs-viewer")
    ap.add_argument("--ply", help="3DGS splat PLY to serve")
    ap.add_argument("--checkpoint", help="checkpoint dir to serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7007)
    ap.add_argument("--max-splats", type=int, default=400_000)
    return ap


def main(argv=None, device=None):
    """Parse argv, load the model on `device` (the card by default; the
    tests pass "cpu"), serve it and print its URL; Ctrl-C closes the
    server."""
    ap = build_parser()
    args = ap.parse_args(argv)

    from fusionsense_tpu_torch.device import resolve_device
    from fusionsense_tpu_torch.viewer import SplatViewerServer

    if not (args.ply or args.checkpoint):
        ap.error("need --ply or --checkpoint")
    dev = resolve_device(device)
    if args.ply:
        from fusionsense_tpu_torch.gaussians.io import import_splat_ply

        state = import_splat_ply(args.ply, device=dev)
    else:
        from fusionsense_tpu_torch.train.checkpoint import load_for_inference

        state, *_ = load_for_inference(args.checkpoint, device=dev)

    srv = SplatViewerServer(args.host, args.port)
    srv.update_from_state(state, step=0, max_splats=args.max_splats)
    # flushed: a parent process reads the URL from a pipe
    print(f"viewing {int(srv._state['num_splats'])} splats at {srv.url}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
