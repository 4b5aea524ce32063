"""Held-out BC loss of a policy checkpoint over a contractor dataset
directory, in the PyTorch port (counterpart of the root tools/eval_loss.py):

    python -m vpt_tpu_torch.tools.eval_loss --in-model M.model --in-weights M.weights --data-dir data/ \\
        [--batch-size 8] [--chunk-len 128] [--max-batches N] [--compute-dtype float32] [--device cuda]

Prints one JSON line: ``{"nll_per_frame": ..., "frames": ..., "batches":
...}``, the mask-weighted negative log-likelihood a frame
(``BCTrainer.evaluate``).  Compare runs at the same ``--batch-size``: the
loader's partition of trajectories over streams depends on it.  Reading
the videos needs libav; runs on CUDA unless ``--device cpu`` is given.
"""

import argparse
import json

from vpt_tpu_torch.training.bc import BCHyperparams, BCTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in-model", required=True)
    ap.add_argument("--in-weights", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--chunk-len", type=int, default=128)
    ap.add_argument("--max-batches", type=int, default=0)
    ap.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    hp = BCHyperparams(batch_size=args.batch_size, chunk_len=args.chunk_len)
    trainer = BCTrainer.from_files(args.in_model, args.in_weights, hp=hp, compute_dtype=args.compute_dtype,
                                   device=args.device)
    report = trainer.evaluate(args.data_dir, max_batches=args.max_batches or None)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
