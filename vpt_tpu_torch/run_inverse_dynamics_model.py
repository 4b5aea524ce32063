"""Label a video with the inverse dynamics model, in the PyTorch port
(counterpart of the root run_inverse_dynamics_model.py's streaming mode):

    python -m vpt_tpu_torch.run_inverse_dynamics_model --model M.model --weights M.weights \\
        --video-path V.mp4 [--n-frames 128] [--stride 64] [--window-batch 4] [--out labels.jsonl] \\
        [--no-strict-resolution] [--device cuda]

Windows of ``--n-frames`` slide by ``--stride`` (default: disjoint windows)
and each frame takes its label from the window where it is most central
(``StreamingIDMLabeler``); ``--window-batch`` windows go through one
forward.  ``--out`` writes one ``{"frame": i, "action": {...}}`` row a
frame, the format ``--labels-dir`` of ``python -m
vpt_tpu_torch.behavioural_cloning`` reads.  Runs on CUDA unless ``--device
cpu`` is given.
"""

import json
import time
from argparse import ArgumentParser

import numpy as np

from vpt_tpu_torch.agent import IDM_REQUIRED_RESOLUTION, IDMAgent, StreamingIDMLabeler, action_jsonl_row
from vpt_tpu_torch.checkpoint import load_model_parameters
from vpt_tpu_torch.data.loader import DECODE_BATCH
from vpt_tpu_torch.data.video import VideoReader


def label_video(agent, video_path, n_frames=128, stride=None, window_batch=1, out=None, strict_resolution=True):
    """Label every frame of the video; returns the number of frames labeled."""
    labeler = StreamingIDMLabeler(agent, window=n_frames, stride=stride, window_batch=window_batch)
    resolution = (agent.cfg.img_shape[1], agent.cfg.img_shape[0])
    total, t0 = 0, time.time()
    out_f = open(out, "w") if out else None

    def emit(labels):
        nonlocal total
        for idx, action in labels:
            total += 1
            row = action_jsonl_row(action)
            if out_f:
                out_f.write(json.dumps({"frame": idx, "action": row}) + "\n")
            if idx < 3:
                pressed = [k for k, v in row.items() if k != "camera" and v == 1]
                print(f"frame {idx}: predicted={pressed} camera={np.round(row['camera'], 2)}")

    try:
        with VideoReader(video_path) as cap:
            if strict_resolution and (cap.width, cap.height) != IDM_REQUIRED_RESOLUTION:
                raise ValueError(f"Video must be of resolution {IDM_REQUIRED_RESOLUTION}, got {(cap.width, cap.height)}")
            while True:  # decode and resize natively, DECODE_BATCH frames a call
                got, frames = cap.read_batch(DECODE_BATCH, resolution)
                for frame in frames[:got]:
                    emit(labeler.feed_resized(frame))
                if got < DECODE_BATCH:
                    break
        emit(labeler.finish())
    finally:
        if out_f:
            out_f.close()
    dt = time.time() - t0
    if total:
        print(f"Labeled {total} frames in {dt:.2f}s → {total / dt:.1f} frames/sec "
              f"(window {n_frames}, stride {labeler.stride}, {window_batch}-window batches)")
    return total


def main(argv=None):
    parser = ArgumentParser("Run the IDM on a Minecraft recording.")
    parser.add_argument("--weights", type=str, required=True, help="Path to the '.weights' file to be loaded.")
    parser.add_argument("--model", type=str, required=True, help="Path to the '.model' file to be loaded.")
    parser.add_argument("--video-path", type=str, required=True, help="Path to a .mp4 file (Minecraft recording).")
    parser.add_argument("--n-frames", type=int, default=128, help="Frames a window.")
    parser.add_argument("--stride", type=int, default=None,
                        help="Slide windows by this many frames (default: --n-frames, disjoint windows).")
    parser.add_argument("--window-batch", type=int, default=1, help="Windows labeled a forward (batch axis).")
    parser.add_argument("--out", type=str, default=None, help="Write predicted actions to this JSONL file.")
    parser.add_argument("--no-strict-resolution", action="store_true", help="Accept videos that are not 640x360.")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    net_kwargs, pi_head_kwargs = load_model_parameters(args.model)
    agent = IDMAgent(net_kwargs, pi_head_kwargs, device=args.device)
    agent.load_weights(args.weights)
    label_video(agent, args.video_path, n_frames=args.n_frames, stride=args.stride, window_batch=args.window_batch,
                out=args.out, strict_resolution=not args.no_strict_resolution)


if __name__ == "__main__":
    main()
