"""Fine-tune a VPT policy on contractor recordings with the PyTorch port
(counterpart of the root behavioural_cloning.py; reference
behavioural_cloning.py):

    python -m vpt_tpu_torch.behavioural_cloning --data-dir DIR --in-model M.model \\
        --in-weights M.weights --out-weights OUT.weights [--batch-size 8] [--chunk-len 128] \\
        [--epochs 2] [--compute-dtype float32] [--remat] [--cnn-scan-chunks N] [--labels-dir DIR] \\
        [--qat-dense] [--checkpoint-dir DIR --checkpoint-every N [--resume]] [--device cuda] \
        [--fsdp N] [--sp N] [--tp N]

Under ``torchrun --nproc_per_node=N`` it trains on every rank (NCCL on the
card, gloo with ``--device cpu``): ``--batch-size`` is the global batch,
data-parallel over the ranks ``--fsdp``, ``--sp`` and ``--tp`` leave
(parallel/mesh.py), and rank 0 writes the weights.  ``--checkpoint-dir`` keeps mid-run checkpoints (every ``--checkpoint-every``
steps, and on SIGTERM or SIGINT); ``--resume`` goes on from the newest one
there.  Runs on CUDA unless ``--device cpu`` is given.
"""

from argparse import ArgumentParser

from vpt_tpu_torch.parallel.mesh import cli_mesh
from vpt_tpu_torch.training.bc import BCHyperparams, BCTrainer


def behavioural_cloning_train(data_dir, in_model, in_weights, out_weights, batch_size=8, chunk_len=128,
                              epochs=2, compute_dtype="float32", device=None, remat=False, cnn_scan_chunks=0,
                              labels_dir=None, qat_dense=False, checkpoint_dir=None, checkpoint_every=0,
                              resume=False, fsdp=1, sp=1, tp=1):
    hp = BCHyperparams(batch_size=batch_size, chunk_len=chunk_len, epochs=epochs,
                       checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
    mesh = cli_mesh(device, fsdp=fsdp, sp=sp, tp=tp)
    trainer = BCTrainer.from_files(in_model, in_weights, hp=hp, compute_dtype=compute_dtype, remat=remat,
                                   cnn_scan_chunks=cnn_scan_chunks, qat_dense=qat_dense, device=device, mesh=mesh)
    steps = trainer.train(data_dir, out_weights, labels_dir=labels_dir,
                          resume_dir=checkpoint_dir if resume else None)
    print(f"Finished: {steps} optimizer steps → {out_weights}")


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--data-dir", type=str, required=True, help="Path to the directory containing recordings to be trained on")
    parser.add_argument("--in-model", required=True, type=str, help="Path to the .model file to be finetuned")
    parser.add_argument("--in-weights", required=True, type=str, help="Path to the .weights file to be finetuned")
    parser.add_argument("--out-weights", required=True, type=str, help="Path where finetuned weights will be saved")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--chunk-len", type=int, default=128, help="Sequence window length (1 = reference single-step mode)")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--compute-dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--remat", action="store_true", help="Recompute activations in the backward (memory for FLOPs)")
    parser.add_argument("--cnn-scan-chunks", type=int, default=0,
                        help="Run the CNN over N frame chunks to bound its activation memory")
    parser.add_argument("--labels-dir", type=str, default=None,
                        help="Train on IDM pseudo-labels: a directory of <video_id>.jsonl files "
                             "instead of the jsonl beside each video")
    parser.add_argument("--qat-dense", action="store_true",
                        help="Quantization-aware training: the forward sees the int8 dense weights of quantize_dense serving")
    parser.add_argument("--checkpoint-dir", type=str, default=None, help="Mid-run checkpoint directory")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="Steps between mid-run checkpoints (0 = only on SIGTERM/SIGINT)")
    parser.add_argument("--resume", action="store_true", help="Resume from the latest checkpoint in --checkpoint-dir")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    parser.add_argument("--fsdp", type=int, default=1, help="Ranks that shard the parameters and Adam's moments (FSDP2)")
    parser.add_argument("--sp", type=int, default=1, help="Ranks that split each chunk's time axis")
    parser.add_argument("--tp", type=int, default=1, help="Ranks that split the attention and MLP layers (tensor parallel)")
    args = parser.parse_args(argv)
    behavioural_cloning_train(args.data_dir, args.in_model, args.in_weights, args.out_weights,
                              batch_size=args.batch_size, chunk_len=args.chunk_len, epochs=args.epochs,
                              compute_dtype=args.compute_dtype, device=args.device, remat=args.remat,
                              cnn_scan_chunks=args.cnn_scan_chunks, labels_dir=args.labels_dir,
                              qat_dense=args.qat_dense, checkpoint_dir=args.checkpoint_dir,
                              checkpoint_every=args.checkpoint_every, resume=args.resume, fsdp=args.fsdp,
                              sp=args.sp, tp=args.tp)


if __name__ == "__main__":
    main()
