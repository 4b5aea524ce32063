"""Fetch VPT contractor data and published checkpoints, in the PyTorch port
(counterpart of the root tools/download_dataset.py):

    # a training corpus: N segments from a version index into one flat dir
    python -m vpt_tpu_torch.tools.download_dataset --index all_8xx_Jun_29.json \\
        --out-dir data/ --limit 200 --workers 8

    # published checkpoints by name (see --list-models)
    python -m vpt_tpu_torch.tools.download_dataset --models foundation-model-1x 4x-idm \\
        --out-dir checkpoints/

The reference documents its dataset as per-version index files (reference
README.md:330-343: ``{"basedir": <url>, "relpaths": [...]}``, one
``<relpath>.mp4`` + ``<relpath>.jsonl`` pair a 5-minute segment) and its
models as a table of blob URLs (README.md:39-87), and ships no code for
either.  Segments land flat (basename only), so ``--out-dir`` is directly a
``--data-dir`` of ``python -m vpt_tpu_torch.behavioural_cloning``: the
loader pairs each ``*.mp4`` with the jsonl beside it.  Downloads are atomic
(``.part`` + rename), resumable (complete pairs are skipped), parallel and
retried with backoff; segments that still fail are recorded in
``<out-dir>/failed.txt`` and skipped (the reference notes missing chunks
are normal, README.md:321-325).  The index may be a local path or a URL;
``--relpath-filter`` selects segments by substring.

It moves files and runs no model, so it takes no ``--device``; it needs
the network (or a local server) that the URLs name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed

# Published checkpoints (reference README.md:39-87).  ".model" files carry
# the architecture kwargs, ".weights" the torch state_dict; both load through
# vpt_tpu_torch.checkpoint.
_BLOB = "https://openaipublic.blob.core.windows.net/minecraft-rl"
MODELS = {
    # foundation policies (one .model per width; weights share it)
    "foundation-model-1x": (f"{_BLOB}/models/foundation-model-1x.model",
                            f"{_BLOB}/models/foundation-model-1x.weights"),
    "foundation-model-2x": (f"{_BLOB}/models/2x.model",
                            f"{_BLOB}/models/foundation-model-2x.weights"),
    "foundation-model-3x": (f"{_BLOB}/models/foundation-model-3x.model",
                            f"{_BLOB}/models/foundation-model-3x.weights"),
    # behavioural-cloning fine-tunes
    "bc-early-game-2x": (f"{_BLOB}/models/2x.model",
                         f"{_BLOB}/models/bc-early-game-2x.weights"),
    "bc-early-game-3x": (f"{_BLOB}/models/foundation-model-3x.model",
                         f"{_BLOB}/models/bc-early-game-3x.weights"),
    "bc-house-3x": (f"{_BLOB}/models/foundation-model-3x.model",
                    f"{_BLOB}/models/bc-house-3x.weights"),
    # RL fine-tunes (all 2x)
    "rl-from-foundation-2x": (f"{_BLOB}/models/2x.model",
                              f"{_BLOB}/models/rl-from-foundation-2x.weights"),
    "rl-from-early-game-2x": (f"{_BLOB}/models/2x.model",
                              f"{_BLOB}/models/rl-from-early-game-2x.weights"),
    "rl-from-house-2x": (f"{_BLOB}/models/2x.model",
                         f"{_BLOB}/models/rl-from-house-2x.weights"),
    # inverse dynamics model
    "4x-idm": (f"{_BLOB}/idm/4x_idm.model", f"{_BLOB}/idm/4x_idm.weights"),
}

# Dataset index files per recorder version / BASALT task (README.md:144-457)
INDEXES = {
    "6.x": f"{_BLOB}/snapshots/all_6xx_Jun_29.json",
    "7.x": f"{_BLOB}/snapshots/all_7xx_Apr_6.json",
    "8.x": f"{_BLOB}/snapshots/all_8xx_Jun_29.json",
    "9.x": f"{_BLOB}/snapshots/all_9xx_Jun_29.json",
    "10.x": f"{_BLOB}/snapshots/all_10xx_Jun_29.json",
    "find-cave": f"{_BLOB}/snapshots/find-cave-Jul-28.json",
    "waterfall": f"{_BLOB}/snapshots/waterfall-Jul-28.json",
    "pen-animals": f"{_BLOB}/snapshots/pen-animals-Jul-28.json",
    "build-house": f"{_BLOB}/snapshots/build-house-Jul-28.json",
}


def _fetch(url: str, dest: str, retries: int = 3, timeout: float = 60.0) -> None:
    """Atomic single-file download: .part + rename, retry with backoff."""
    part = dest + ".part"
    last: Exception | None = None
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, open(part, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(part, dest)
            return
        except Exception as e:  # noqa: BLE001 — any transport error retries
            last = e
            if os.path.exists(part):
                os.remove(part)
            time.sleep(2.0 ** attempt)
    raise RuntimeError(f"{url}: {last}") from last


def _read_index(index: str) -> dict:
    """Index json from a local path or URL."""
    if urllib.parse.urlparse(index).scheme in ("http", "https", "file"):
        with urllib.request.urlopen(index) as r:
            return json.loads(r.read().decode())
    with open(index) as f:
        return json.load(f)


def download_segment(basedir: str, relpath: str, out_dir: str,
                     retries: int = 3) -> str:
    """One contractor segment = its .mp4 + .jsonl pair, flat into out_dir.
    Returns 'done' | 'skipped' (both files already complete) — raises on
    persistent failure of either file."""
    base = os.path.basename(relpath)
    mp4 = os.path.join(out_dir, base + ".mp4")
    jsonl = os.path.join(out_dir, base + ".jsonl")
    if all(os.path.exists(p) and os.path.getsize(p) > 0 for p in (mp4, jsonl)):
        return "skipped"
    root = basedir.rstrip("/") + "/" + relpath.lstrip("/")
    # jsonl first: it is small, so a dead segment fails fast before the video
    _fetch(root + ".jsonl", jsonl, retries=retries)
    _fetch(root + ".mp4", mp4, retries=retries)
    return "done"


def download_dataset(index: str, out_dir: str, limit: int | None = None,
                     workers: int = 4, retries: int = 3,
                     relpath_filter: str = "") -> dict:
    """Fetch segments from an index into ``out_dir``; returns counts."""
    spec = _read_index(index)
    basedir, relpaths = spec["basedir"], spec["relpaths"]
    if relpath_filter:
        relpaths = [r for r in relpaths if relpath_filter in r]
    if limit is not None:
        relpaths = relpaths[:limit]
    os.makedirs(out_dir, exist_ok=True)
    counts = {"done": 0, "skipped": 0, "failed": 0}
    failed_log = os.path.join(out_dir, "failed.txt")
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {
            pool.submit(download_segment, basedir, rp, out_dir, retries): rp
            for rp in relpaths
        }
        for fut in as_completed(futures):
            rp = futures[fut]
            try:
                counts[fut.result()] += 1
            except Exception as e:  # noqa: BLE001 — log and continue the corpus
                counts["failed"] += 1
                with open(failed_log, "a") as f:
                    f.write(f"{rp}\t{e}\n")
                print(f"FAILED {rp}: {e}", file=sys.stderr)
    return counts


def download_models(names, out_dir: str, retries: int = 3) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        if name not in MODELS:
            raise SystemExit(
                f"unknown model {name!r}; one of: {', '.join(sorted(MODELS))}"
            )
        for url in MODELS[name]:
            dest = os.path.join(out_dir, os.path.basename(url))
            if os.path.exists(dest) and os.path.getsize(dest) > 0:
                print(f"skip {dest} (exists)")
                continue
            print(f"fetch {url}")
            _fetch(url, dest, retries=retries)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        "Download VPT contractor segments and/or published checkpoints."
    )
    ap.add_argument("--index",
                    help="Dataset index: a json path/URL, or a shorthand "
                         f"({', '.join(INDEXES)})")
    ap.add_argument("--models", nargs="*", default=None,
                    help="Published checkpoint names (see --list-models)")
    ap.add_argument("--list-models", action="store_true")
    ap.add_argument("--out-dir", help="Destination directory")
    ap.add_argument("--limit", type=int, default=None,
                    help="First N segments only")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--retries", type=int, default=3)
    ap.add_argument("--relpath-filter", default="",
                    help="Keep only relpaths containing this substring")
    args = ap.parse_args(argv)

    if args.list_models:
        for name, (model, weights) in sorted(MODELS.items()):
            print(f"{name}: {model} + {weights}")
        return
    if not args.out_dir:
        ap.error("--out-dir is required")
    if args.models:
        download_models(args.models, args.out_dir, retries=args.retries)
    if args.index:
        index = INDEXES.get(args.index, args.index)
        counts = download_dataset(
            index, args.out_dir, limit=args.limit, workers=args.workers,
            retries=args.retries, relpath_filter=args.relpath_filter,
        )
        print(json.dumps(counts))
    if not args.models and not args.index:
        ap.error("nothing to do: pass --index and/or --models")


if __name__ == "__main__":
    main()
