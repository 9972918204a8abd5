"""fs-touch in the port: Active Touch Selection (the reference's
scripts/VLM.py).

    python -m fusionsense_tpu_torch.cli.touch --mesh <mesh.ply> --high-grad <high_grad_pts.pcd> --offline

The flags, their defaults and choices are those of fusionsense_tpu's
fs-touch (`--mode {partname,touch}`, reference scripts/VLM.py:386-421):
- partname: query the VLM for the object class + ranked part names
- touch:    full next-best-touch proposal from an extracted mesh + the
            trainer's high_grad_pts.pcd
With `--glip-checkpoint` (a GLIP Swin-L .pth) and `--glip-vocab` (BERT's
vocab.txt) the parts are segmented by the port's GLIP detector on the
card; without, every point is one part.
"""
from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser("fs-touch", description=__doc__)
    p.add_argument("--mode", choices=["partname", "touch"], default="touch")
    p.add_argument("--mesh", help="extracted mesh .ply (touch mode)")
    p.add_argument("--high-grad", help="high_grad_pts.pcd from training")
    p.add_argument("--image", default=None, help="reference image for the VLM")
    p.add_argument("--quota", type=int, default=10)
    p.add_argument("--per-part", type=int, default=5)
    p.add_argument("--output", default="touch_proposals.pcd")
    p.add_argument("--vlm-model", default="gpt-4o")
    p.add_argument("--vlm-base-url", default="https://api.openai.com/v1")
    p.add_argument("--offline", action="store_true",
                   help="use the offline fixture VLM (no network)")
    p.add_argument("--parts", nargs="*", default=None,
                   help="bypass the VLM with an explicit ranked part list")
    p.add_argument("--glip-checkpoint", default=None,
                   help="torch GLIP Swin-L .pth; enables the real grounded "
                        "detector for part segmentation")
    p.add_argument("--glip-vocab", default=None,
                   help="bert-base-uncased vocab.txt for the tokenizer")
    p.add_argument("--glip-threshold", type=float, default=0.5)
    return p


def _detector(args, device):
    """The GLIP detector on `device` when a checkpoint is supplied
    (reference behavior: PartSlip/src/glip_inference.py:15-28), else None
    (every point one part)."""
    if not args.glip_checkpoint:
        return None
    from fusionsense_tpu_torch.detection import GLIPPredictor
    from fusionsense_tpu_torch.detection.convert import load_glip_checkpoint
    from fusionsense_tpu_torch.detection.tokenizer import WordPieceTokenizer

    net = load_glip_checkpoint(args.glip_checkpoint)
    tok = WordPieceTokenizer.from_vocab_file(args.glip_vocab)
    return GLIPPredictor(net, tok, confidence_threshold=args.glip_threshold,
                         device=device)


def _provider(args):
    from fusionsense_tpu_torch.touch_select.vlm import (
        OpenAICompatProvider, StaticPartProvider,
    )

    if args.parts:
        return StaticPartProvider(classification="object",
                                  parts=tuple(args.parts))
    key = os.environ.get("OPENAI_API_KEY")
    if args.offline or not key:
        return StaticPartProvider()
    return OpenAICompatProvider(api_key=key, model=args.vlm_model,
                                base_url=args.vlm_base_url)


def main(argv=None, device=None):
    """Parse argv and run the mode; returns the VLM's PartResponse
    (partname) or the TouchSelectionResult (touch). `device` is where the
    renders and the detector run (the card by default; the tests pass
    "cpu")."""
    from fusionsense_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(device)
    provider = _provider(args)

    if args.mode == "partname":
        resp = provider.part_names(args.image)
        print(json.dumps({"classification": resp.classification,
                          "parts": resp.parts}, indent=2))
        return resp

    from fusionsense_tpu_torch.touch_select.select import next_best_touches

    res = next_best_touches(
        args.mesh, args.high_grad, part_provider=provider,
        detector=_detector(args, dev),
        reference_image=args.image, quota=args.quota,
        per_part=args.per_part, out_path=args.output, device=dev)
    print(f"object: {res.classification}; parts: {res.part_names}")
    for i, (p, pr, gr) in enumerate(zip(res.proposals.points,
                                        res.proposals.part_rank,
                                        res.proposals.grad_rank)):
        print(f"touch {i}: ({p[0]:.4f}, {p[1]:.4f}, {p[2]:.4f})  "
              f"part_rank={int(pr)} grad_rank={int(gr)}")
    print(f"proposals -> {args.output}")
    return res


if __name__ == "__main__":
    main()
