"""Train an inverse dynamics model on contractor recordings with the PyTorch
port (counterpart of the root inverse_dynamics_train.py):

    python -m vpt_tpu_torch.inverse_dynamics_train --data-dir DIR --in-model IDM.model \\
        --out-weights OUT.weights [--in-weights IDM.weights] [--val-dir DIR] [--batch-size 8] \\
        [--window 128] [--epochs 2] [--compute-dtype float32] [--remat] [--cnn-scan-chunks N] \\
        [--qat-dense] [--checkpoint-dir DIR --checkpoint-every N [--resume]] [--device cuda] \
        [--fsdp N] [--sp N] [--tp N]

Under ``torchrun`` it trains on every rank as the BC command does
(``--batch-size`` the global batch; ``--fsdp``, ``--sp``, ``--tp`` the mesh).
Takes BC's dataset layout (mp4 + jsonl pairs).  ``--in-weights`` warm-starts
from existing IDM weights, else training starts from random weights;
``--val-dir`` reports held-out NLL and argmax exact-match rates after
training.  ``--checkpoint-dir`` keeps mid-run checkpoints (every
``--checkpoint-every`` steps, and on SIGTERM or SIGINT); ``--resume`` goes on
from the newest one there.  Runs on CUDA unless ``--device cpu`` is given.
"""

from argparse import ArgumentParser

from vpt_tpu_torch.parallel.mesh import cli_mesh
from vpt_tpu_torch.training.idm import IDMHyperparams, IDMTrainer


def inverse_dynamics_train(data_dir, in_model, out_weights, in_weights=None, batch_size=8, window=128, epochs=2,
                           compute_dtype="float32", device=None, remat=False, cnn_scan_chunks=0, val_dir=None,
                           qat_dense=False, checkpoint_dir=None, checkpoint_every=0, resume=False, fsdp=1, sp=1,
                           tp=1):
    hp = IDMHyperparams(batch_size=batch_size, window=window, epochs=epochs, checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every)
    mesh = cli_mesh(device, fsdp=fsdp, sp=sp, tp=tp)
    trainer = IDMTrainer.from_files(in_model, in_weights, hp=hp, compute_dtype=compute_dtype, remat=remat,
                                    cnn_scan_chunks=cnn_scan_chunks, qat_dense=qat_dense, device=device, mesh=mesh)
    steps = trainer.train(data_dir, out_weights, resume_dir=checkpoint_dir if resume else None)
    print(f"Finished: {steps} optimizer steps → {out_weights}")
    if val_dir:
        print("held-out:", trainer.evaluate(val_dir))
    return trainer


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--data-dir", type=str, required=True, help="Directory of labeled recordings (mp4 + jsonl) to train on")
    parser.add_argument("--in-model", required=True, type=str, help="Path to the IDM '.model' file (architecture kwargs)")
    parser.add_argument("--in-weights", type=str, default=None, help="Optional '.weights' to warm-start from")
    parser.add_argument("--out-weights", required=True, type=str, help="Path where trained IDM weights will be saved")
    parser.add_argument("--val-dir", type=str, default=None, help="Held-out recordings: report NLL and exact-match after training")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--window", type=int, default=128, help="Frames a training window (the published IDM's geometry)")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--compute-dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--remat", action="store_true", help="Recompute activations in the backward (memory for FLOPs)")
    parser.add_argument("--cnn-scan-chunks", type=int, default=0,
                        help="Run the CNN over N frame chunks to bound its activation memory")
    parser.add_argument("--qat-dense", action="store_true",
                        help="Quantization-aware training: the forward sees the int8 dense weights of quantize_dense labeling")
    parser.add_argument("--checkpoint-dir", type=str, default=None, help="Mid-run checkpoint directory")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="Steps between mid-run checkpoints (0 = only on SIGTERM/SIGINT)")
    parser.add_argument("--resume", action="store_true", help="Resume from the latest checkpoint in --checkpoint-dir")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    parser.add_argument("--fsdp", type=int, default=1, help="Ranks that shard the parameters and Adam's moments (FSDP2)")
    parser.add_argument("--sp", type=int, default=1, help="Ranks that split each window's time axis")
    parser.add_argument("--tp", type=int, default=1, help="Ranks that split the attention and MLP layers (tensor parallel)")
    args = parser.parse_args(argv)
    return inverse_dynamics_train(args.data_dir, args.in_model, args.out_weights, in_weights=args.in_weights,
                           batch_size=args.batch_size, window=args.window, epochs=args.epochs,
                           compute_dtype=args.compute_dtype, device=args.device, remat=args.remat,
                           cnn_scan_chunks=args.cnn_scan_chunks, val_dir=args.val_dir, qat_dense=args.qat_dense,
                           checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
                           resume=args.resume, fsdp=args.fsdp, sp=args.sp, tp=args.tp)


if __name__ == "__main__":
    main()
