"""Contractor-data pipeline: mp4 + jsonl → sequence-chunked training batches
(counterpart of vpt_tpu/data/loader.py ``trajectory_steps`` and
``SequenceDataLoader``).

Every fixup branch of the reference loader (data_loader.py:48-128):
stuck-attack detection, scroll-wheel hotbar tracking, jsonl step → env
action, null-action skipping, cursor compositing onto GUI frames at the
recorded mouse position, and the cv2-exact resize to the agent resolution
(the last two in the native library, data/video.py).

IDM pseudo-labels (``{"frame": i, "action": {...}}`` rows, as
``python -m vpt_tpu_torch.run_inverse_dynamics_model --out`` writes them) go
through ``pseudo_label_steps``; ``steps_for`` picks the step generator by the
jsonl's format, so one corpus may mix both, and ``labels_dir`` reads the
labels from a directory of their own.

``DataLoader`` yields the reference's single-step batches (frames, env
actions, episode ids), one sample per worker round-robin.
``SequenceDataLoader`` yields B parallel streams of contiguous T-step
windows with the actions already factored into the joint categorical space.
Each stream has one worker process that owns whole trajectories.  Workers
start from the forkserver (or spawn) context, never by forking the parent:
a parent that has initialised CUDA cannot be forked safely.  Under spawn
the program that builds a loader must be importable (a script with an
``if __name__ == "__main__"`` guard).

``state()`` is the exact resume cursor, each stream's (trajectory position,
chunks consumed); a loader built with ``resume_state=`` that cursor goes on
from each stream's first unconsumed chunk, the workers fast-forwarding with
``skip_steps``, so nothing is skipped or repeated.  Unlike the JAX
package's loader, whose consumer restarts a resumed stream from a fresh
recurrent state, the first chunk of a resumed stream is marked first only
where it starts its trajectory: the port's trainers restore the recurrent
state they were trained with.

``shard_id``/``num_shards`` split the global stream grid over data-parallel
ranks: with ``batch_size`` local streams, local stream i is global stream
``shard_id·batch_size + i`` of a ``batch_size·num_shards``-stream loader,
so the shards together serve exactly what one loader of the global batch
would.  ``state()`` records the shard, and a resume checks it.
"""

from __future__ import annotations

import glob
import json
import multiprocessing
import os
import queue as queue_mod
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from vpt_tpu_torch.actions.buttons import Buttons
from vpt_tpu_torch.actions.json_actions import json_action_to_env_action
from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
from vpt_tpu_torch.actions.transformer import ActionTransformer
from vpt_tpu_torch.config import ACTION_TRANSFORMER_KWARGS, AGENT_RESOLUTION
from vpt_tpu_torch.data.cursor import default_cursor

try:
    _mp = multiprocessing.get_context("forkserver")
except ValueError:  # platform without forkserver
    _mp = multiprocessing.get_context("spawn")

# seconds a queue get may wait; raise it on slow or contended hosts
QUEUE_TIMEOUT = float(os.environ.get("VPT_QUEUE_TIMEOUT", 10))

MINEREC_ORIGINAL_HEIGHT_PX = 720  # reference: data_loader.py:21
DECODE_BATCH = 64  # frames per native decode/composite/resize call

# GUI-open mouse-delta scalers per recorder version (reference:
# data_loader.py:25-31).  The reference defines them but its worker never
# applies them; trajectory_steps applies them only with apply_version_scalers.
MINEREC_VERSION_SPECIFIC_SCALERS = {
    "5.7": 0.5,
    "5.8": 0.5,
    "6.7": 2.0,
    "6.8": 2.0,
    "6.9": 2.0,
}


def _load_jsonl(json_path: str):
    with open(json_path) as f:
        lines = f.readlines()
    return json.loads("[" + ",".join(lines) + "]")


def trajectory_steps(
    video_path: str,
    json_path: str,
    resolution: Tuple[int, int] = AGENT_RESOLUTION,
    cursor=None,
    apply_version_scalers: bool = False,
    quit_event=None,
    skip_steps: int = 0,
    batch_frames: int = DECODE_BATCH,
):
    """Generator of (frame uint8 RGB at ``resolution`` (w, h), env_action)
    for one recording, with all reference fixups applied and null actions
    skipped.  ``apply_version_scalers`` scales the mouse deltas of GUI-open
    steps by ``MINEREC_VERSION_SPECIFIC_SCALERS`` of their ``dataVersion``
    (off by default, as in the reference's worker).

    The sequential action fixups run over the whole jsonl first; then the
    pixels (decode, cursor composite, resize) go through the native library
    ``batch_frames`` frames per call.  ``skip_steps`` passes over the first
    that many non-null steps without yielding them (a resumed trajectory):
    the fixups still run and every frame is still decoded, to stay in step.
    """
    from vpt_tpu_torch.data.video import VideoReader

    cursor = cursor if cursor is not None else default_cursor()
    json_data = _load_jsonl(json_path)
    video = VideoReader(video_path)
    try:
        attack_is_stuck = False
        last_hotbar = 0
        emitted = 0
        scale = video.height / MINEREC_ORIGINAL_HEIGHT_PX
        steps = []  # (env_action, emit, cursor_xy or None)
        for i, step_data in enumerate(json_data):
            # a recording may start with attack held down, stuck until the
            # player really presses it (reference data_loader.py:64-69)
            if i == 0:
                if step_data["mouse"]["newButtons"] == [0]:
                    attack_is_stuck = True
            elif attack_is_stuck and 0 in step_data["mouse"]["newButtons"]:
                attack_is_stuck = False
            if attack_is_stuck:
                step_data["mouse"]["buttons"] = [b for b in step_data["mouse"]["buttons"] if b != 0]
            if apply_version_scalers and step_data.get("isGuiOpen", False):
                scaler = MINEREC_VERSION_SPECIFIC_SCALERS.get(str(step_data.get("dataVersion", "1")), 1.0)
                if scaler != 1.0:
                    step_data["mouse"]["dx"] *= scaler
                    step_data["mouse"]["dy"] *= scaler

            action, is_null_action = json_action_to_env_action(step_data)

            # scroll-wheel hotbar switches are not recorded as key presses
            # (reference data_loader.py:99-103)
            current_hotbar = step_data["hotbar"]
            if current_hotbar != last_hotbar:
                action[f"hotbar.{current_hotbar + 1}"] = 1
            last_hotbar = current_hotbar

            emit = not is_null_action and emitted >= skip_steps
            emitted += not is_null_action
            xy = None
            if emit and step_data.get("isGuiOpen", False):
                xy = (int(step_data["mouse"]["x"] * scale), int(step_data["mouse"]["y"] * scale))
            steps.append((action, emit, xy))
        yield from _emit_resized_frames(video, steps, resolution, cursor, quit_event, video_path, batch_frames)
    finally:
        video.close()


def _emit_resized_frames(video, steps, resolution, cursor, quit_event, video_path, batch_frames=DECODE_BATCH):
    """The pixel phase of a step plan ``[(action, emit, cursor_xy or None)]``:
    decode, cursor composite and resize ``batch_frames`` frames a native
    call, yielding (frame, action) for the emitting steps."""
    from vpt_tpu_torch.data.video import VideoReader

    pos = 0
    while pos < len(steps):
        if quit_event is not None and quit_event.is_set():
            break
        chunk = steps[pos:pos + batch_frames]
        n = len(chunk)
        emit_mask = np.fromiter((s[1] for s in chunk), np.uint8, n)
        xy = np.full((n, 2), VideoReader.CURSOR_NONE, np.int32)
        for j, (_, _, cxy) in enumerate(chunk):
            if cxy is not None:
                xy[j] = cxy
        got, frames = video.read_batch(n, resolution, emit=emit_mask, cursor_xy=xy, cursor=cursor)
        for j in range(got):
            if chunk[j][1]:
                yield frames[j], chunk[j][0]
        if got < n:  # video shorter than the jsonl (reference data_loader.py:122-123)
            print(f"Could not read frame from video {video_path}")
            break
        pos += got


def _is_pseudo_label_file(json_path: str) -> bool:
    """True for IDM pseudo-label jsonl (rows ``{"frame": i, "action": {...}}``),
    False for recorder-format contractor jsonl."""
    with open(json_path) as f:
        for line in f:
            line = line.strip()
            if line:
                row = json.loads(line)
                return "action" in row and "frame" in row
    return False


def pseudo_label_steps(
    video_path: str,
    json_path: str,
    resolution: Tuple[int, int] = AGENT_RESOLUTION,
    cursor=None,
    quit_event=None,
    skip_steps: int = 0,
):
    """Generator of (frame, env_action) for an IDM pseudo-labeled recording.

    Rows are already env actions, so none of the recorder fixups apply (no
    stuck attack, no hotbar tracking, no cursor: the IDM predicts no GUI
    state).  Null actions (all buttons 0 and a zero camera, which the IDM's
    centre camera bin decodes to exactly) are skipped as on the contractor
    path (reference data_loader.py:109-111).  Frames without a label row are
    decoded, to stay in step, but not emitted; ``skip_steps`` counts
    non-null steps, as in :func:`trajectory_steps`.
    """
    from vpt_tpu_torch.data.video import VideoReader

    by_frame: Dict[int, dict] = {}
    for row in _load_jsonl(json_path):
        by_frame[int(row["frame"])] = row["action"]
    video = VideoReader(video_path)
    try:
        steps = []  # (env_action, emit, None)
        emitted = 0
        for i in range(max(by_frame, default=-1) + 1):
            raw = by_frame.get(i)
            if raw is None:
                steps.append((None, False, None))
                continue
            action, is_null = {}, True
            for k, v in raw.items():
                if k == "camera":
                    action[k] = np.asarray(v, np.float32).reshape(2)
                    is_null = is_null and bool(np.all(action[k] == 0.0))
                else:
                    action[k] = int(np.asarray(v).reshape(-1)[0])
                    is_null = is_null and action[k] == 0
            steps.append((action, not is_null and emitted >= skip_steps, None))
            emitted += not is_null
        yield from _emit_resized_frames(video, steps, resolution, cursor if cursor is not None else default_cursor(),
                                        quit_event, video_path)
    finally:
        video.close()


def steps_for(video_path: str, json_path: str, **kw):
    """The step generator for a recording's jsonl format: contractor data
    through :func:`trajectory_steps` (every fixup), IDM pseudo-labels
    through :func:`pseudo_label_steps`."""
    if _is_pseudo_label_file(json_path):
        return pseudo_label_steps(video_path, json_path, **kw)
    return trajectory_steps(video_path, json_path, **kw)


def _discover(dataset_dir: str, labels_dir: Optional[str] = None) -> List[Tuple[str, str]]:
    """Each ``*.mp4`` of the directory, sorted by id, with its ``.jsonl``:
    beside it, or in ``labels_dir`` where given (pseudo-labels kept apart
    from the videos), where videos not labeled yet are skipped with a
    notice."""
    unique_ids = sorted({os.path.basename(x).split(".")[0] for x in glob.glob(os.path.join(dataset_dir, "*.mp4"))})
    pairs = [(os.path.abspath(os.path.join(dataset_dir, uid + ".mp4")),
              os.path.abspath(os.path.join(labels_dir or dataset_dir, uid + ".jsonl"))) for uid in unique_ids]
    if labels_dir is None:
        return pairs
    labeled = [(v, j) for v, j in pairs if os.path.exists(j)]
    if len(labeled) < len(pairs):
        print(f"[vpt_tpu_torch] {len(pairs) - len(labeled)}/{len(pairs)} videos in {dataset_dir} have "
              f"no label file in {labels_dir}; skipped")
    return labeled


def _robust_put(q, item, quit_event) -> bool:
    """Put that survives consumer pauses: retry until the quit event fires.
    Returns False when the consumer is shutting down."""
    while True:
        try:
            q.put(item, timeout=1.0)
            return True
        except queue_mod.Full:
            if quit_event.is_set():
                return False


def _step_worker(tasks_queue, output_queue, quit_event):
    """Emit (trajectory_id, frame, env_action) for every non-null step of
    each task ``(trajectory_id, video_path, json_path)``."""
    cursor = default_cursor()
    while True:
        task = tasks_queue.get()
        if task is None:
            break
        trajectory_id, video_path, json_path = task
        try:
            for frame, action in trajectory_steps(video_path, json_path, cursor=cursor, quit_event=quit_event):
                if not _robust_put(output_queue, (trajectory_id, frame, action), quit_event):
                    return
        except Exception as e:  # unreadable recording: report and move on
            print(f"Error in trajectory {video_path}: {e!r}")
        if quit_event.is_set():
            break
    output_queue.put(None)


class DataLoader:
    """Single-step batches, one sample per worker round-robin (reference:
    data_loader.py:130-222).  Yields (frames, env_actions, episode_ids),
    lists of ``batch_size``.

    Each worker has its own task queue, filled round-robin with whole
    trajectories (a shared queue, as in the reference, lets the first
    worker to start take every task and an idle sibling end the epoch);
    the first worker to run out ends the stream, keeping batches diverse
    (reference data_loader.py:204-211).
    """

    def __init__(self, dataset_dir, n_workers=8, batch_size=8, n_epochs=1, max_queue_size=16,
                 seed: Optional[int] = None):
        from vpt_tpu_torch.data.video import build

        if n_workers < batch_size:
            raise ValueError("Number of workers must be equal or greater than batch size")
        build()  # once here, not once per worker
        self.n_workers = n_workers
        self.batch_size = batch_size
        demonstration_tuples = _discover(dataset_dir)
        if n_workers > len(demonstration_tuples):
            raise ValueError(f"n_workers should be lower or equal than number of demonstrations "
                             f"{len(demonstration_tuples)}")
        rng = random.Random(seed)
        self.demonstration_tuples = []
        for _ in range(n_epochs):
            shuffled = list(demonstration_tuples)
            rng.shuffle(shuffled)
            self.demonstration_tuples += shuffled
        self.task_queues = [_mp.Queue() for _ in range(n_workers)]
        self.n_steps_processed = 0
        for trajectory_id, task in enumerate(self.demonstration_tuples):
            self.task_queues[trajectory_id % n_workers].put((trajectory_id, *task))
        for q in self.task_queues:
            q.put(None)
        self.output_queues = [_mp.Queue(maxsize=max_queue_size) for _ in range(n_workers)]
        self.quit_workers_event = _mp.Event()
        self.processes = [_mp.Process(target=_step_worker, args=(tq, q, self.quit_workers_event), daemon=True)
                          for tq, q in zip(self.task_queues, self.output_queues)]
        for p in self.processes:
            p.start()

    def __iter__(self):
        return self

    def __next__(self):
        batch_frames, batch_actions, batch_episode_id = [], [], []
        for _ in range(self.batch_size):
            qi = self.n_steps_processed % self.n_workers
            try:
                workitem = self.output_queues[qi].get(timeout=QUEUE_TIMEOUT)
            except queue_mod.Empty:
                if not self.processes[qi].is_alive():
                    raise RuntimeError(f"data worker {qi} died (exitcode {self.processes[qi].exitcode})") from None
                raise RuntimeError(f"data worker {qi} produced nothing within {QUEUE_TIMEOUT}s "
                                   "(raise VPT_QUEUE_TIMEOUT on a slow host)") from None
            if workitem is None:
                raise StopIteration()
            trajectory_id, frame, action = workitem
            batch_frames.append(frame)
            batch_actions.append(action)
            batch_episode_id.append(trajectory_id)
            self.n_steps_processed += 1
        return batch_frames, batch_actions, batch_episode_id

    def close(self):
        self.quit_workers_event.set()
        for p in self.processes:
            p.terminate()
            p.join()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _factor_actions(transformer, mapper, acts) -> Tuple[np.ndarray, np.ndarray]:
    """Env actions of a chunk → joint (buttons, camera) indices, in one
    batched call each."""
    n = len(acts)
    env_batch = {"camera": np.stack([np.asarray(a["camera"]) for a in acts])}
    for k in Buttons.ALL:
        env_batch[k] = np.fromiter((a.get(k, 0) for a in acts), np.int64, n)
    joint = mapper.from_factored(transformer.env2policy(env_batch))
    return joint["buttons"][:, 0].astype(np.int32), joint["camera"][:, 0].astype(np.int32)


def _sequence_worker(tasks_queue, output_queue, quit_event, chunk_len, resolution):
    """Emit fixed-length windows of consecutive non-null steps of each task
    ``(trajectory_id, video_path, json_path, skip_chunks)``, from chunk
    ``skip_chunks`` on (a resumed trajectory); the trailing partial window
    is zero-padded and carries its count of valid steps.  Each item carries
    its chunk's index within the trajectory, for the consumer's cursor."""
    cursor = default_cursor()
    mapper = CameraHierarchicalMapping(n_camera_bins=11)
    transformer = ActionTransformer(**ACTION_TRANSFORMER_KWARGS)
    while True:
        task = tasks_queue.get()
        if task is None:
            break
        trajectory_id, video_path, json_path, skip_chunks = task
        frames, acts = [], []
        chunk_index = skip_chunks
        try:
            for frame, action in steps_for(video_path, json_path, resolution=resolution, cursor=cursor,
                                           quit_event=quit_event, skip_steps=skip_chunks * chunk_len):
                frames.append(frame)
                acts.append(action)
                if len(frames) == chunk_len:
                    buttons, cameras = _factor_actions(transformer, mapper, acts)
                    item = (trajectory_id, np.stack(frames), buttons, cameras, chunk_index == 0, chunk_len,
                            chunk_index)
                    if not _robust_put(output_queue, item, quit_event):
                        return
                    frames, acts = [], []
                    chunk_index += 1
        except Exception as e:  # unreadable recording: report and move on
            print(f"Error in trajectory {video_path}: {e!r}")
        if frames and not quit_event.is_set():
            n = len(frames)
            pad = chunk_len - n
            buttons, cameras = _factor_actions(transformer, mapper, acts)
            frames += [np.zeros_like(frames[0])] * pad
            item = (trajectory_id, np.stack(frames), np.pad(buttons, (0, pad)), np.pad(cameras, (0, pad)),
                    chunk_index == 0, n, chunk_index)
            _robust_put(output_queue, item, quit_event)
        if quit_event.is_set():
            break
    output_queue.put(None)


class SequenceDataLoader:
    """B parallel streams of T-step windows for sequence-chunked BC.

    Yields dict batches:
      frames  (B, T, H, W, 3) uint8
      buttons (B, T) int32   joint 8641-way indices
      camera  (B, T) int32   joint 121-way indices
      firsts  (B, T) bool    True at step 0 of a trajectory's first window
      mask    (B, T) bool    False on zero-padded tail steps
      episode_ids (B,) int64

    Stream i owns the positions i, i + B, i + 2B, ... of the (per-epoch
    shuffled) trajectory list; the first stream to run out ends the epoch.
    ``labels_dir`` reads each video's jsonl from there (pseudo-labels kept
    apart from the videos); each jsonl's format is detected either way.
    ``resume_state`` is a :meth:`state` of a loader over the same data,
    seed and epochs: each stream goes on from its first unconsumed chunk.
    A state written at another batch size or shard has stream cursors that
    mean other global streams: the loader drops them (with a notice) and
    starts from ``start_trajectory``, the coarse whole-trajectory cursor
    (each stream at its first owned position at or past it).
    ``shard_id``/``num_shards``: this loader serves the ``batch_size``
    streams of shard ``shard_id`` of a global batch of
    ``batch_size·num_shards`` streams (the same ``seed`` on every shard).
    """

    def __init__(self, dataset_dir, batch_size=8, chunk_len=128, n_epochs=1, max_queue_size=8,
                 resolution: Tuple[int, int] = AGENT_RESOLUTION, seed: Optional[int] = None,
                 labels_dir: Optional[str] = None, start_trajectory: int = 0,
                 resume_state: Optional[Dict] = None, shard_id: int = 0, num_shards: int = 1):
        from vpt_tpu_torch.data.video import build

        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside num_shards {num_shards}")
        build()  # once here, not once per worker
        demonstration_tuples = _discover(dataset_dir, labels_dir)
        global_streams = batch_size * num_shards
        if global_streams > len(demonstration_tuples):
            raise ValueError(f"global stream count {global_streams} (batch_size {batch_size} x num_shards "
                             f"{num_shards}) should be <= number of demonstrations {len(demonstration_tuples)}")
        rng = random.Random(seed)
        self.demonstration_tuples = []
        for _ in range(n_epochs):
            shuffled = list(demonstration_tuples)
            rng.shuffle(shuffled)
            self.demonstration_tuples += shuffled
        self.chunk_len = chunk_len
        self.batch_size = batch_size
        self.shard_id, self.num_shards = shard_id, num_shards
        # global stream g owns list positions g, g + G, ...; its cursor is (position, chunks consumed)
        streams = [(-1, 0)] * batch_size
        self.n_trajectories_dispatched = start_trajectory
        if resume_state is not None and resume_state.get("streams"):
            shard = list(resume_state.get("shard", [0, 1]))
            if len(resume_state["streams"]) == batch_size and shard == [shard_id, num_shards]:
                streams = [(int(p), int(c)) for p, c in resume_state["streams"]]
                self.n_trajectories_dispatched = int(resume_state.get("n_trajectories_dispatched", start_trajectory))
            else:
                print(f"[vpt_tpu_torch] resume: stream cursor ({len(resume_state['streams'])} streams, shard {shard}) "
                      f"does not match batch_size={batch_size} shard=[{shard_id}, {num_shards}]; using the coarse "
                      f"trajectory cursor {start_trajectory}")
        self._stream_cursor = list(streams)

        self.task_queues = [_mp.Queue() for _ in range(batch_size)]
        for i in range(batch_size):
            g = shard_id * batch_size + i
            # without a stream cursor: the first owned position at or past start_trajectory
            first_pos = g + (max(start_trajectory - g, 0) + global_streams - 1) // global_streams * global_streams
            skip_chunks = 0
            if streams[i][0] >= 0:
                first_pos, skip_chunks = streams[i]
            for pos in range(first_pos, len(self.demonstration_tuples), global_streams):
                self.task_queues[i].put((pos, *self.demonstration_tuples[pos], skip_chunks if pos == first_pos else 0))
            self.task_queues[i].put(None)
        self.output_queues = [_mp.Queue(maxsize=max_queue_size) for _ in range(batch_size)]
        self.quit_workers_event = _mp.Event()
        self.processes = [
            _mp.Process(target=_sequence_worker, args=(tq, q, self.quit_workers_event, chunk_len, resolution),
                        daemon=True)
            for tq, q in zip(self.task_queues, self.output_queues)
        ]
        for p in self.processes:
            p.start()
        self._done = False

    def state(self) -> Dict:
        """The exact resume cursor: each stream's (trajectory position,
        chunks consumed), and the trajectories dispatched so far.  Feed it
        back as ``resume_state=`` to go on with nothing skipped or repeated."""
        return {"n_trajectories_dispatched": self.n_trajectories_dispatched,
                "streams": [list(c) for c in self._stream_cursor],
                "shard": [self.shard_id, self.num_shards]}

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration()
        items = []
        for i in range(self.batch_size):
            try:
                item = self.output_queues[i].get(timeout=QUEUE_TIMEOUT)
            except queue_mod.Empty:
                if not self.processes[i].is_alive():
                    raise RuntimeError(f"data worker {i} died (exitcode {self.processes[i].exitcode})") from None
                raise RuntimeError(f"data worker {i} produced no chunk within {QUEUE_TIMEOUT}s "
                                   "(raise VPT_QUEUE_TIMEOUT on a slow host)") from None
            if item is None:
                self._done = True
                raise StopIteration()
            items.append(item)
        for i, item in enumerate(items):
            self._stream_cursor[i] = (item[0], item[6] + 1)
            self.n_trajectories_dispatched = max(self.n_trajectories_dispatched, item[0] + 1)
        T = self.chunk_len
        firsts = np.zeros((self.batch_size, T), bool)
        firsts[:, 0] = [it[4] for it in items]
        return {
            "frames": np.stack([it[1] for it in items]),
            "buttons": np.stack([it[2] for it in items]),
            "camera": np.stack([it[3] for it in items]),
            "firsts": firsts,
            "mask": np.arange(T)[None] < np.asarray([it[5] for it in items])[:, None],
            "episode_ids": np.asarray([it[0] for it in items], np.int64),
        }

    def close(self):
        self.quit_workers_event.set()
        for p in self.processes:
            p.terminate()
            p.join()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
