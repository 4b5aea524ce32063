"""Label a video with the inverse dynamics model, in the PyTorch port
(counterpart of the root run_inverse_dynamics_model.py; reference
run_inverse_dynamics_model.py):

    python -m vpt_tpu_torch.run_inverse_dynamics_model --model M.model --weights M.weights \\
        --video-path V.mp4 [--jsonl-path V.jsonl] [--n-frames 128] [--n-batches N] [--out labels.jsonl] \\
        [--out-video pred.mp4] [--stride 64 --window-batch 4] [--metrics] [--no-strict-resolution] [--device cuda]

Two modes, as in the JAX script:

  * print mode (no ``--stride``, or one of at least ``--n-frames``): batches
    of ``--n-frames`` frames, ``--n-batches`` of them (default 10), through
    ``IDMAgent.predict_actions`` with the attention state carried from
    batch to batch; each frame's prediction is printed beside the recorded
    action of ``--jsonl-path``, and ``--out-video`` draws both on the frames;
  * streaming mode (``--stride`` < ``--n-frames``): windows slide by the
    stride and each frame takes its label from the window where it is most
    central (``StreamingIDMLabeler``), ``--window-batch`` windows a forward;
    the whole video unless ``--n-batches`` caps it.

``--out`` writes one ``{"frame": i, "action": {...}}`` row a frame, the
format ``--labels-dir`` of ``python -m vpt_tpu_torch.behavioural_cloning``
reads; ``--metrics`` prints the agreement with the recorded actions
(``AgreementMeter``).  The device work takes frame batches
(:func:`predict_batches`, :func:`label_resized`), apart from the decode, so
it runs on frames from anywhere.  Decoding needs libav; runs on CUDA unless
``--device cpu`` is given.
"""

import json
import time
from argparse import ArgumentParser

import numpy as np

from vpt_tpu_torch.actions.json_actions import json_action_to_env_action
from vpt_tpu_torch.agent import IDM_REQUIRED_RESOLUTION, IDMAgent, StreamingIDMLabeler, action_jsonl_row
from vpt_tpu_torch.checkpoint import load_model_parameters
from vpt_tpu_torch.data.loader import DECODE_BATCH, _load_jsonl
from vpt_tpu_torch.utils.metrics import AgreementMeter

PRINT_MODE_BATCHES = 10  # the reference's default --n-batches (run_inverse_dynamics_model.py:200)


def _check_resolution(cap, strict_resolution):
    if strict_resolution and (cap.width, cap.height) != IDM_REQUIRED_RESOLUTION:
        raise ValueError(f"Video must be of resolution {IDM_REQUIRED_RESOLUTION}, got {(cap.width, cap.height)}")


def _recorded(json_data, idx):
    if json_data is None or idx >= len(json_data):
        return None
    return json_action_to_env_action(json_data[idx])[0]


def _preview(idx, row, rec):
    pressed = [k for k, v in row.items() if k != "camera" and v == 1]
    rec_pressed = [k for k, v in (rec or {}).items() if k != "camera" and v == 1]
    print(f"frame {idx}: predicted={pressed} camera={np.round(row['camera'], 2)} | recorded={rec_pressed}")


def predict_batches(agent, batches, json_data=None, out_f=None, writer_path=None, meter=None):
    """Print mode's device work: each (N, H, W, 3) raw frame batch of
    ``batches`` through ``agent.predict_actions``, the state carried from
    batch to batch; yields (frame index, jsonl action row) in order, writes
    the rows to ``out_f``, the annotated frames to a video at
    ``writer_path``, and the agreement with ``json_data`` to ``meter``."""
    writer = None
    start = 0
    try:
        for frames in batches:
            print("=== Predicting actions ===")
            predicted = agent.predict_actions(frames)
            for i in range(len(frames)):
                idx = start + i
                row = action_jsonl_row({name: arr[0, i] for name, arr in predicted.items()})
                rec = _recorded(json_data, idx)
                if out_f:
                    out_f.write(json.dumps({"frame": idx, "action": row}) + "\n")
                if meter is not None and rec is not None:
                    meter.add(row, rec)
                if writer_path:
                    from vpt_tpu_torch.data.annotate import action_rows, annotate_frame
                    from vpt_tpu_torch.data.video import VideoWriter

                    if writer is None:
                        writer = VideoWriter(writer_path, frames.shape[2], frames.shape[1], fps=20)
                    pred_i = {k: np.asarray(v[0, i]) for k, v in predicted.items()}
                    writer.write(annotate_frame(frames[i], action_rows(pred_i, rec)))
                if i < 3:  # terminal preview
                    _preview(idx, row, rec)
                yield idx, row
            start += len(frames)
    finally:
        if writer is not None:
            writer.close()


def _frame_batches(cap, n_frames, n_batches):
    """Up to ``n_batches`` batches of ``n_frames`` raw frames from ``cap``."""
    for _ in range(n_batches):
        frames = []
        for _ in range(n_frames):
            frame = cap.read()
            if frame is None:
                break
            frames.append(frame)
        if not frames:
            return
        yield np.stack(frames)


def print_main(agent, video_path, json_data, n_frames, n_batches, out=None, out_video=None, strict_resolution=True,
               metrics=False):
    """Print mode over a video; returns the number of frames labeled."""
    from vpt_tpu_torch.data.video import VideoReader

    meter = AgreementMeter() if (metrics and json_data is not None) else None
    out_f = open(out, "w") if out else None
    total, t0 = 0, time.time()
    try:
        with VideoReader(video_path) as cap:
            _check_resolution(cap, strict_resolution)
            for _ in predict_batches(agent, _frame_batches(cap, n_frames, n_batches), json_data, out_f, out_video,
                                     meter):
                total += 1
    finally:
        if out_f:
            out_f.close()
    dt = time.time() - t0
    if total:
        print(f"Labeled {total} frames in {dt:.2f}s → {total / dt:.1f} frames/sec")
    if meter is not None:
        print("metrics:", json.dumps(meter.summary()))
    return total


def label_resized(labeler, batches, json_data=None, out_f=None, meter=None):
    """Streaming mode's device work: each (N, h, w, 3) batch of frames at
    the agent's resolution through ``labeler`` (a ``StreamingIDMLabeler``),
    then its tail; yields (frame index, jsonl action row) in order, writes
    the rows to ``out_f`` and the agreement with ``json_data`` to ``meter``."""

    def emit(labels):
        for idx, action in labels:
            row = action_jsonl_row(action)
            if out_f:
                out_f.write(json.dumps({"frame": idx, "action": row}) + "\n")
            rec = _recorded(json_data, idx)
            if meter is not None and rec is not None:
                meter.add(row, rec)
            if idx < 3:
                _preview(idx, row, rec)
            yield idx, row

    for frames in batches:
        for frame in frames:
            yield from emit(labeler.feed_resized(frame))
    yield from emit(labeler.finish())


def streaming_main(agent, video_path, json_data, n_frames, stride, window_batch, out=None, max_frames=None,
                   strict_resolution=True, metrics=False):
    """Overlap-stitched labeling over a video of any length; returns the
    number of frames labeled."""
    from vpt_tpu_torch.data.video import VideoReader

    labeler = StreamingIDMLabeler(agent, window=n_frames, stride=stride, window_batch=window_batch)
    resolution = (agent.cfg.img_shape[1], agent.cfg.img_shape[0])
    meter = AgreementMeter() if (metrics and json_data is not None) else None
    out_f = open(out, "w") if out else None
    total, t0 = 0, time.time()
    try:
        with VideoReader(video_path) as cap:
            _check_resolution(cap, strict_resolution)
            state = {"read": 0}

            def batches():  # decode and resize natively, DECODE_BATCH frames a call
                while max_frames is None or state["read"] < max_frames:
                    want = DECODE_BATCH if max_frames is None else min(DECODE_BATCH, max_frames - state["read"])
                    got, frames = cap.read_batch(want, resolution)
                    state["read"] += got
                    yield frames[:got]
                    if got < want:
                        return

            for _ in label_resized(labeler, batches(), json_data, out_f, meter):
                total += 1
            if max_frames is not None and state["read"] == max_frames and cap.read() is not None:
                print(f"WARNING: stopped at --n-batches cap ({max_frames} frames) before end of video; "
                      f"omit --n-batches to label the whole recording.")
    finally:
        if out_f:
            out_f.close()
    dt = time.time() - t0
    if total:
        print(f"Labeled {total} frames in {dt:.2f}s → {total / dt:.1f} frames/sec "
              f"(window {n_frames}, stride {labeler.stride}, {window_batch}-window batches)")
    if meter is not None:
        print("metrics:", json.dumps(meter.summary()))
    return total


def main(argv=None):
    parser = ArgumentParser("Run IDM on MineRL recordings.")
    parser.add_argument("--weights", type=str, required=True, help="Path to the '.weights' file to be loaded.")
    parser.add_argument("--model", type=str, required=True, help="Path to the '.model' file to be loaded.")
    parser.add_argument("--video-path", type=str, required=True, help="Path to a .mp4 file (Minecraft recording).")
    parser.add_argument("--jsonl-path", type=str, required=False, default=None,
                        help="Path to a .jsonl file (Minecraft recording).")
    parser.add_argument("--n-frames", type=int, default=128, help="Number of frames to process at a time.")
    parser.add_argument("--n-batches", type=int, default=None,
                        help="Number of batches (n-frames) to process. Default: 10 for visualization mode, "
                             "unlimited (whole video) for streaming --stride mode.")
    parser.add_argument("--out", type=str, default=None, help="Write predicted actions to this JSONL file.")
    parser.add_argument("--out-video", type=str, default=None, help="Write an annotated prediction video here.")
    parser.add_argument("--no-strict-resolution", action="store_true", help="Accept videos that are not 640x360.")
    parser.add_argument("--stride", type=int, default=None,
                        help="Slide windows by this many frames (< --n-frames enables overlap-stitched streaming "
                             "labeling; boundary frames get bidirectional context).")
    parser.add_argument("--window-batch", type=int, default=1,
                        help="Streaming mode: windows labeled per forward (batch axis).")
    parser.add_argument("--metrics", action="store_true",
                        help="With --jsonl-path: print predicted-vs-recorded agreement "
                             "(per-button accuracy, exact-match rate, camera MAE in degrees).")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    net_kwargs, pi_head_kwargs = load_model_parameters(args.model)
    agent = IDMAgent(net_kwargs, pi_head_kwargs, device=args.device)
    agent.load_weights(args.weights)
    json_data = _load_jsonl(args.jsonl_path) if args.jsonl_path else None
    strict = not args.no_strict_resolution
    if args.stride is not None and args.stride < args.n_frames:
        max_frames = args.n_batches * args.n_frames if args.n_batches is not None else None
        return streaming_main(agent, args.video_path, json_data, args.n_frames, args.stride, args.window_batch,
                              out=args.out, max_frames=max_frames, strict_resolution=strict, metrics=args.metrics)
    n_batches = PRINT_MODE_BATCHES if args.n_batches is None else args.n_batches
    return print_main(agent, args.video_path, json_data, args.n_frames, n_batches, out=args.out,
                      out_video=args.out_video, strict_resolution=strict, metrics=args.metrics)


if __name__ == "__main__":
    main()
