"""Bulk IDM labeling: a directory of gameplay videos into action jsonl, in
the PyTorch port (counterpart of the root tools/label_videos.py):

    python -m vpt_tpu_torch.tools.label_videos --model 4x_idm.model --weights 4x_idm.weights \\
        --video-dir contractor_videos/ --out-dir labels/ [--n-frames 128 --stride 64 --window-batch 8] \\
        [--no-strict-resolution] [--no-resume] [--device cuda]

One loaded agent labels every ``*.mp4`` under ``--video-dir`` through the
overlap-stitched ``StreamingIDMLabeler`` (every frame gets bidirectional
context).  Each video is decoded and resized natively, 64 frames a call
(``VideoReader.read_batch``), and the chunks feed :func:`label_frames`,
which takes frames from anywhere.

Restartable: each video writes ``<out-dir>/<id>.jsonl.tmp`` and renames it
on completion, so a rerun skips finished videos (unless ``--no-resume``)
and redoes at most one partial file.  Rows are ``{"frame": i, "action":
{...}}``, the format of ``python -m vpt_tpu_torch.run_inverse_dynamics_model
--out``.  Decoding needs libav; runs on CUDA unless ``--device cpu`` is
given.
"""

import argparse
import glob
import json
import os
import sys
import time

from vpt_tpu_torch.agent import IDM_REQUIRED_RESOLUTION, IDMAgent, StreamingIDMLabeler, action_jsonl_row
from vpt_tpu_torch.checkpoint import load_model_parameters
from vpt_tpu_torch.data.loader import DECODE_BATCH


def label_frames(agent, batches, out_path, window, stride, window_batch):
    """Label the frames of ``batches`` (an iterable of (N, h, w, 3) uint8
    batches at the agent's resolution) into ``out_path``: the rows go to
    ``out_path + ".tmp"``, renamed to ``out_path`` once every frame is
    labeled.  Returns the number of frames."""
    labeler = StreamingIDMLabeler(agent, window=window, stride=stride, window_batch=window_batch)
    n = 0
    with open(out_path + ".tmp", "w") as out:

        def emit(labels):
            for idx, action in labels:
                out.write(json.dumps({"frame": idx, "action": action_jsonl_row(action)}) + "\n")

        for frames in batches:
            for frame in frames:
                n += 1
                emit(labeler.feed_resized(frame))
        emit(labeler.finish())
    os.replace(out_path + ".tmp", out_path)  # completion marker: the final name
    return n


def video_batches(video_path, resolution, strict_resolution=True, decode_batch=DECODE_BATCH):
    """The video's frames, decoded and resized natively to ``resolution``
    (width, height), ``decode_batch`` a batch."""
    from vpt_tpu_torch.data.video import VideoReader

    with VideoReader(video_path) as cap:
        if strict_resolution and (cap.width, cap.height) != IDM_REQUIRED_RESOLUTION:
            raise ValueError(f"{video_path}: resolution {(cap.width, cap.height)} != {IDM_REQUIRED_RESOLUTION} "
                             f"(pass --no-strict-resolution to accept)")
        while True:
            got, frames = cap.read_batch(decode_batch, resolution)
            yield frames[:got]
            if got < decode_batch:
                return


def label_one(agent, video_path, out_path, window, stride, window_batch, strict_resolution=True,
              decode_batch=DECODE_BATCH):
    """Label one video into ``out_path``; returns (n_frames, seconds)."""
    t0 = time.time()
    resolution = (agent.cfg.img_shape[1], agent.cfg.img_shape[0])
    n = label_frames(agent, video_batches(video_path, resolution, strict_resolution, decode_batch), out_path,
                     window, stride, window_batch)
    return n, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser("Label every video in a directory with IDM actions.")
    ap.add_argument("--model", required=True, help="Path to the IDM '.model' file.")
    ap.add_argument("--weights", required=True, help="Path to the IDM '.weights' file.")
    ap.add_argument("--video-dir", required=True, help="Directory of .mp4 recordings.")
    ap.add_argument("--out-dir", required=True, help="Write <id>.jsonl files here.")
    ap.add_argument("--n-frames", type=int, default=128, help="Window length.")
    ap.add_argument("--stride", type=int, default=64,
                    help="Window slide (< --n-frames overlap-stitches so every label has bidirectional context).")
    ap.add_argument("--window-batch", type=int, default=8, help="Windows labeled per forward.")
    ap.add_argument("--no-strict-resolution", action="store_true", help="Accept videos that are not 640x360.")
    ap.add_argument("--no-resume", action="store_true", help="Re-label videos even when their output exists.")
    ap.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    videos = sorted(glob.glob(os.path.join(args.video_dir, "*.mp4")))
    if not videos:
        raise SystemExit(f"no .mp4 files under {args.video_dir}")
    os.makedirs(args.out_dir, exist_ok=True)

    net_kwargs, pi_head_kwargs = load_model_parameters(args.model)
    agent = IDMAgent(net_kwargs, pi_head_kwargs, device=args.device)
    agent.load_weights(args.weights)
    # a configuration error (window past the model's timesteps, stride out of
    # range) fails here once, not once a video below
    StreamingIDMLabeler(agent, window=args.n_frames, stride=args.stride, window_batch=args.window_batch)

    total_frames, t_start, skipped, failed = 0, time.time(), 0, []
    for i, vp in enumerate(videos):
        vid = os.path.splitext(os.path.basename(vp))[0]
        out_path = os.path.join(args.out_dir, vid + ".jsonl")
        if not args.no_resume and os.path.exists(out_path):
            skipped += 1
            continue
        try:
            n, dt = label_one(agent, vp, out_path, args.n_frames, args.stride, args.window_batch,
                              strict_resolution=not args.no_strict_resolution)
        except (OSError, ValueError) as e:
            # one bad recording does not stop the corpus; its .tmp stays for inspection and a retry
            print(f"[{i + 1}/{len(videos)}] {vid}: FAILED — {e}", flush=True)
            failed.append(vid)
            continue
        total_frames += n
        print(f"[{i + 1}/{len(videos)}] {vid}: {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)", flush=True)
    dt_all = time.time() - t_start
    done = len(videos) - skipped - len(failed)
    print(f"Labeled {done} video(s) ({skipped} already done, {len(failed)} failed), "
          f"{total_frames} frames in {dt_all:.1f}s → {total_frames / max(dt_all, 1e-9):.1f} frames/sec")
    if failed:
        print("failed:", ", ".join(failed))
        sys.exit(1)


if __name__ == "__main__":
    main()
