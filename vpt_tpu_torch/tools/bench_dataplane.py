"""Host data-plane throughput of the PyTorch port: decode, fixups, cursor
and bit-exact resize (counterpart of the root tools/bench_dataplane.py):

    python -m vpt_tpu_torch.tools.bench_dataplane [--frames 600] [--batches 1 16 64]
    python -m vpt_tpu_torch.tools.bench_dataplane --stages [--frames 600]
    python -m vpt_tpu_torch.tools.bench_dataplane --bakeoff --reference-checkout DIR \\
        [--workers 8] [--traj 16] [--frames 400] [--chunk 32]

Three modes:

* default: single-stream ``trajectory_steps`` of the port's loader at
  several ``batch_frames`` settings (1 approximates a per-frame native call,
  64 is the loader's batched call);
* ``--stages``: the native pixel path on one stream, stage by stage, by
  differencing timed ``read_batch`` calls: decode only, then the resize,
  then the cursor composite;
* ``--bakeoff``: the reference's own ``DataLoader``, imported from the
  checkout at ``--reference-checkout`` and driven, against the port's
  ``DataLoader`` at the same geometry and its ``SequenceDataLoader``: the
  same corpus, the same worker count, the loaders alone, each in a fresh
  subprocess after a warm pass.  It raises without the checkout.

All of it runs on the host (libav through data/video.py's native library):
no device, so no ``--device``.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import numpy as np

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_fixture(tmp, n_frames: int):
    from vpt_tpu_torch.data.video import VideoWriter

    video_path = os.path.join(tmp, "traj.mp4")
    json_path = os.path.join(tmp, "traj.jsonl")
    rng = np.random.default_rng(0)
    with VideoWriter(video_path, 640, 360, fps=20) as w:
        base = rng.integers(0, 255, (360, 640, 3), dtype=np.uint8)
        for i in range(n_frames):
            frame = np.roll(base, i * 3, axis=1)  # cheap motion, encodes fast
            w.write(frame)
    steps = []
    for i in range(n_frames):
        gui = (i // 40) % 2 == 1  # alternate GUI segments → cursor composite
        steps.append({
            "mouse": {"x": 320.0 + (i % 50), "y": 180.0 + (i % 30),
                      "dx": 1.0, "dy": 0.5, "buttons": [0] if i % 7 == 0 else [],
                      "newButtons": [0] if i % 7 == 0 else []},
            "keyboard": {"keys": ["key.keyboard.w"] if i % 3 else []},
            "hotbar": i % 9,
            "isGuiOpen": gui,
        })
    with open(json_path, "w") as f:
        for s in steps:
            f.write(json.dumps(s) + "\n")
    return video_path, json_path


def build_corpus(root: str, n_traj: int, n_frames: int) -> None:
    """Bakeoff corpus: n_traj contractor-style recordings, EVERY step
    non-null (the reference skips null actions; identical-by-construction
    emitted counts make the two loaders' fps directly comparable), with GUI
    segments so both cursor-composite paths run."""
    from vpt_tpu_torch.data.video import VideoWriter

    keys = ["key.keyboard.w", "key.keyboard.a", "key.keyboard.s", "key.keyboard.d"]
    rng = np.random.default_rng(7)
    pool = [rng.integers(0, 255, (360, 640, 3), dtype=np.uint8) for _ in range(8)]
    for j in range(n_traj):
        base = os.path.join(root, f"traj{j}")
        with VideoWriter(base + ".mp4", 640, 360, fps=20) as w:
            for i in range(n_frames):
                w.write(pool[(i + j) % len(pool)])
        with open(base + ".jsonl", "w") as f:
            for i in range(n_frames):
                row = {"keyboard": {"keys": [keys[(i + j) % len(keys)]]},
                       "mouse": {"x": 320.0, "y": 180.0, "dx": float(i % 5 - 2),
                                 "dy": 1.0, "buttons": [], "newButtons": []},
                       "hotbar": 0, "isGuiOpen": (i // 40) % 4 == 3}
                f.write(json.dumps(row) + "\n")


_REF_LOADER_SCRIPT = textwrap.dedent("""
    import json, sys, time, types
    sys.path.insert(0, %(package_root)r)
    import vpt_tpu_torch.spaces as spaces

    # the reference's imports this loader does not use: gym3's type algebra
    # (vpt_tpu_torch.spaces), gym and minerl (inert)
    g, t = types.ModuleType("gym3"), types.ModuleType("gym3.types")
    t.DictType, t.TensorType, t.Discrete, t.Real, t.ValType = (spaces.DictType, spaces.TensorType,
                                                                 spaces.Discrete, spaces.Real, object)
    g.types = t
    gym, gs = types.ModuleType("gym"), types.ModuleType("gym.spaces")
    gs.Discrete = gs.Box = gs.Dict = type("Space", (), {"__init__": lambda self, *a, **k: None})
    gym.spaces = gs
    mc = types.ModuleType("minerl.herobraine.hero.mc")
    mc.MINERL_ITEM_MAP = {}
    sys.modules.update({"gym3": g, "gym3.types": t, "gym": gym, "gym.spaces": gs,
                        "minerl": types.ModuleType("minerl"),
                        "minerl.herobraine": types.ModuleType("minerl.herobraine"),
                        "minerl.herobraine.hero": types.ModuleType("minerl.herobraine.hero"),
                        "minerl.herobraine.hero.mc": mc})
    sys.path.insert(0, %(reference)r)
    import data_loader as ref_dl
    ref_dl.QUEUE_TIMEOUT = 120

    def drain():
        loader = ref_dl.DataLoader(dataset_dir=%(corpus)r, n_workers=%(workers)d,
                                   batch_size=%(workers)d, n_epochs=1)
        n = 0
        t0 = time.perf_counter()
        for frames, actions, ids in loader:
            n += len(frames)
        return n, time.perf_counter() - t0

    drain()                      # warm: page cache, worker start-up
    n, dt = drain()
    print(json.dumps({"frames": n, "seconds": dt, "fps": n / dt}))
""")

_OUR_STEP_LOADER_SCRIPT = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, %(package_root)r)

    if __name__ == "__main__":   # spawned workers re-import this script
        from vpt_tpu_torch.data import loader as vl
        vl.QUEUE_TIMEOUT = 120

        def drain():
            loader = vl.DataLoader(%(corpus)r, n_workers=%(workers)d,
                                   batch_size=%(workers)d, n_epochs=1)
            n = 0
            t0 = time.perf_counter()
            for frames, actions, ids in loader:
                n += len(frames)
            dt = time.perf_counter() - t0
            loader.close()
            return n, dt

        drain()
        n, dt = drain()
        print(json.dumps({"frames": n, "seconds": dt, "fps": n / dt}))
""")

_OUR_SEQ_LOADER_SCRIPT = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, %(package_root)r)

    if __name__ == "__main__":
        from vpt_tpu_torch.data import loader as vl
        vl.QUEUE_TIMEOUT = 120

        def drain():
            loader = vl.SequenceDataLoader(%(corpus)r, batch_size=%(workers)d,
                                           chunk_len=%(chunk)d, n_epochs=1, seed=0)
            n = 0
            t0 = time.perf_counter()
            for b in loader:
                n += int(b["mask"].sum())      # real (non-padding) frames
            dt = time.perf_counter() - t0
            loader.close()
            return n, dt

        drain()
        n, dt = drain()
        print(json.dumps({"frames": n, "seconds": dt, "fps": n / dt}))
""")


def _run_leg(script_body: str, tmp: str, name: str) -> dict:
    path = os.path.join(tmp, f"leg_{name}.py")
    with open(path, "w") as f:
        f.write(script_body)
    out = subprocess.run([sys.executable, path], capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        return {"error": out.stderr.strip().splitlines()[-1][:300] if out.stderr else "failed"}
    return json.loads(out.stdout.strip().splitlines()[-1])


def bakeoff(n_traj: int, n_frames: int, workers: int, chunk: int, reference: str) -> dict:
    if not reference or not os.path.isfile(os.path.join(reference, "data_loader.py")):
        raise FileNotFoundError(f"--bakeoff drives the reference's data_loader.py from a checkout of it: "
                                f"none at --reference-checkout {reference!r}")
    tmp = tempfile.mkdtemp(prefix="vpt_dataplane_bakeoff_")
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus, exist_ok=True)
    build_corpus(corpus, n_traj, n_frames)
    sub = {"package_root": PACKAGE_ROOT, "reference": os.path.abspath(reference), "corpus": corpus,
           "workers": workers, "chunk": chunk}
    results = {
        "geometry": {"trajectories": n_traj, "frames_per_traj": n_frames, "workers": workers, "chunk_len": chunk},
        # the reference's own DataLoader (cv2 decode, a worker a stream, single-step batches)
        "reference_loader": _run_leg(_REF_LOADER_SCRIPT % sub, tmp, "ref"),
        # the port's at the same geometry: single-step batches, the same workers, native batched decode
        "ours_step_loader": _run_leg(_OUR_STEP_LOADER_SCRIPT % sub, tmp, "step"),
        # the port's at the training geometry: T-step windows a stream
        "ours_sequence_loader": _run_leg(_OUR_SEQ_LOADER_SCRIPT % sub, tmp, "seq"),
    }
    ref_fps = results["reference_loader"].get("fps")
    for k in ("ours_step_loader", "ours_sequence_loader"):
        fps = results[k].get("fps")
        if fps and ref_fps:
            results[k]["vs_reference"] = fps / ref_fps
    return results


def stages(n_frames: int) -> dict:
    """Per-stage native pixel-path profile by differencing: decode-only
    (emit=0) → +bit-exact resize (emit=1) → +cursor composite (every frame
    composited).  One stream, no workers — the per-core story."""
    from vpt_tpu_torch.data.cursor import default_cursor
    from vpt_tpu_torch.data.video import VideoReader

    tmp = tempfile.mkdtemp(prefix="vpt_dataplane_stages_")
    video_path, _ = build_fixture(tmp, n_frames)
    cursor = default_cursor()
    bf = 64

    def timed(emit_val: int, with_cursor: bool) -> float:
        def one_pass() -> float:
            t0 = time.perf_counter()
            with VideoReader(video_path) as v:
                done = 0
                while done < n_frames:
                    k = min(bf, n_frames - done)
                    emit = np.full(k, emit_val, np.uint8)
                    xy = np.full((k, 2), VideoReader.CURSOR_NONE, np.int32)
                    if with_cursor:
                        xy[:] = (300, 170)
                    got, _ = v.read_batch(k, (128, 128), emit=emit,
                                          cursor_xy=xy, cursor=cursor)
                    if got == 0:
                        break
                    done += got
            return time.perf_counter() - t0

        one_pass()  # warm
        return one_pass()

    t_decode = timed(0, False)
    t_resize = timed(1, False)
    t_full = timed(1, True)
    return {
        "frames": n_frames,
        "decode_only_fps": n_frames / t_decode,
        "decode_resize_fps": n_frames / t_resize,
        "decode_resize_composite_fps": n_frames / t_full,
        "stage_ms_per_frame": {
            "decode": 1e3 * t_decode / n_frames,
            "resize": 1e3 * (t_resize - t_decode) / n_frames,
            "composite": 1e3 * (t_full - t_resize) / n_frames,
        },
    }


def batch_sweep(n_frames: int, batches) -> dict:
    """Single-stream ``trajectory_steps`` frames/s at each ``batch_frames``."""
    from vpt_tpu_torch.data.loader import trajectory_steps

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        video_path, json_path = build_fixture(tmp, n_frames)
        for bf in batches:
            sum(1 for _ in trajectory_steps(video_path, json_path, batch_frames=bf))  # warm
            t0 = time.perf_counter()
            n = sum(1 for _ in trajectory_steps(video_path, json_path, batch_frames=bf))
            dt = time.perf_counter() - t0
            results[f"batch_{bf}_fps"] = n / dt
            results[f"batch_{bf}_frames"] = n
    if len(batches) > 1:
        results["speedup"] = results[f"batch_{batches[-1]}_fps"] / results[f"batch_{batches[0]}_fps"]
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16, 64])
    ap.add_argument("--bakeoff", action="store_true", help="reference DataLoader vs ours, same corpus/workers")
    ap.add_argument("--reference-checkout", type=str, default=None,
                    help="--bakeoff: the directory of a checkout of the reference (its data_loader.py)")
    ap.add_argument("--stages", action="store_true", help="native pixel path per-stage profile")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--traj", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=32)
    args = ap.parse_args(argv)

    if args.bakeoff:
        frames = args.frames if args.frames != 600 else 400
        results = bakeoff(args.traj, frames, args.workers, args.chunk, args.reference_checkout)
    elif args.stages:
        results = stages(args.frames)
    else:
        results = batch_sweep(args.frames, args.batches)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
