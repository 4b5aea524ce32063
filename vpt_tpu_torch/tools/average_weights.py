"""Average several ``.weights`` checkpoints into one, in the PyTorch port
(counterpart of the root tools/average_weights.py):

    python -m vpt_tpu_torch.tools.average_weights out.weights in1.weights in2.weights [...] [--device cuda]

Each tensor is the mean of its inputs, summed in float64 on the device and
cast back to its dtype (``checkpoint.averaging``), then written on the
host.  Tail-averaging BC fine-tunes typically buys a small generalization
bump.  Runs on CUDA unless ``--device cpu`` is given.
"""

import argparse

import torch

from vpt_tpu_torch.checkpoint.averaging import load_average
from vpt_tpu_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description="Average several .weights checkpoints into one.")
    ap.add_argument("out", help="the averaged .weights file to write")
    ap.add_argument("inputs", nargs="+", help="the .weights files to average")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    sd = load_average(args.inputs, device=resolve_device(args.device))
    torch.save({k: v.cpu() for k, v in sd.items()}, args.out)
    print(f"averaged {len(args.inputs)} checkpoints ({len(sd)} tensors) → {args.out}")
    return sd


if __name__ == "__main__":
    main()
