"""Rendered-dataset reader and host loader for diffusion training.

The port's own copy of ``genima_tpu/data/dataset.py`` (``Sample``,
``index_rendered_dataset``, ``_resize_center_crop``, ``DiffusionDataLoader``),
which replaces the reference's HF ``rlbench_dataset`` loading script and torch
DataLoader:

* index the rendered dataset tree (tasks -> variation -> episodes) pairing
  ``image_type`` targets with ``conditioning_image_type`` conditions: tiled
  mode pairs ``tiled_rgb_rendered[i]`` with ``tiled_rgb[i]`` and drops the
  last frame, non-tiled mode iterates cameras;
* prompt templates: "tiled perspectives of a robot arm executing '<desc>'"
  / "a robot arm executing '<desc>' from <camera> perspective";
* ``num_demos`` cap with natural episode ordering; ``predict_future`` pairs
  observation t with frame t + horizon;
* the loader shuffles per epoch, decodes PNGs, resizes / center-crops,
  and tokenizes prompts, emitting NHWC numpy batches (uint8 with
  ``emit_uint8``; the trainer normalises on the device). With
  ``use_native`` (the default on hosts with 4 or more cores) a batch goes
  through the C++ decoder (``genima_torch.native``, plain bilinear with no
  antialiasing, as the JAX package's); where that library is unavailable
  or a decode fails, the batch is decoded with PIL in a thread pool.
  ``decoded`` counts the batches each decoder made, so a fallback shows.

Under several processes (``core.distributed``) each rank decodes the
strided slice ``order[rank::world]`` of the same shuffled order, and with
``drop_last`` yields as many batches as the smallest slice holds (also
``len``), so every rank takes the same number of steps. ``DevicePrefetcher``
copies each batch to the device from pinned memory without blocking, one
or two batches ahead of the step.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import queue
import random
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch
from PIL import Image

from genima_torch.core.distributed import process_count, process_index


def _natsort_key(name: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


@dataclasses.dataclass
class Sample:
    image_path: str
    conditioning_image_path: str
    text: str


def _pairs(render_path: Path, rgb_path: Path, n: int, predict_future: bool,
           horizon: int, text: str) -> list[Sample]:
    out = []
    for i in range(n):
        tgt = min(i + horizon, n - 1) if predict_future else i
        out.append(Sample(str(render_path / f"{tgt}.png"), str(rgb_path / f"{i}.png"), text))
    return out


def index_rendered_dataset(
    data_path: str | Path,
    tasks: list[str],
    variation: int = 0,
    num_demos: int = 100,
    image_type: str = "tiled_rgb_rendered",
    conditioning_image_type: str = "tiled_rgb",
    cameras: list[str] | None = None,
    tiled: bool = True,
    predict_future: bool = False,
    predict_future_horizon: int = 20,
    rng: random.Random | None = None,
) -> list[Sample]:
    rng = rng or random.Random(0)
    data_path = Path(data_path)
    samples: list[Sample] = []
    for task in tasks:
        var_dir = f"variation{variation}" if variation != -1 else "all_variations"
        eps_folder = data_path / task / var_dir / "episodes"
        desc_file = data_path / task / var_dir / "variation_descriptions.pkl"
        if desc_file.exists():
            # a file of the rendered dataset this program wrote
            with open(desc_file, "rb") as f:
                descriptions = pickle.load(f)
        else:
            descriptions = [task.replace("_", " ")]
        episodes = sorted(
            (d for d in eps_folder.iterdir() if d.is_dir()),
            key=lambda p: _natsort_key(p.name),
        )[:num_demos]
        for ep in episodes:
            if tiled:
                render_path = ep / image_type
                text = (
                    "tiled perspectives of a robot arm executing "
                    f"'{rng.choice(list(descriptions))}'"
                )
                n = len(list(render_path.glob("*.png"))) - 1  # drop last frame
                samples += _pairs(render_path, ep / conditioning_image_type, n,
                                  predict_future, predict_future_horizon, text)
            else:
                for camera in cameras or []:
                    render_path = ep / f"{camera}_{image_type}"
                    text = (
                        f"a robot arm executing "
                        f"'{rng.choice(list(descriptions))}' from {camera} "
                        "perspective"
                    )
                    n = len(list(render_path.glob("*.png")))
                    samples += _pairs(render_path, ep / f"{camera}_{conditioning_image_type}",
                                      n, predict_future, predict_future_horizon, text)
    return samples


def _resize_center_crop(img: Image.Image, resolution: int) -> Image.Image:
    """transforms.Resize(resolution) + CenterCrop(resolution), bilinear."""
    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.Resampling.BILINEAR)
    w, h = img.size
    left, top = (w - resolution) // 2, (h - resolution) // 2
    return img.crop((left, top, left + resolution, top + resolution))


class DiffusionDataLoader:
    """Epoch loader: shuffle -> threaded PNG decode -> NHWC numpy batches.

    Emits the reference collate layout: ``pixel_values`` in [-1, 1],
    ``conditioning_pixel_values`` in [0, 1] (or both uint8 with
    ``emit_uint8``), ``input_ids`` (B, 77).
    """

    def __init__(
        self,
        samples: list[Sample],
        tokenizer,
        batch_size: int = 4,
        resolution: int = 512,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        drop_last: bool = True,
        proportion_empty_prompts: float = 0.0,
        use_native: bool | None = None,
        emit_uint8: bool = False,
    ):
        self.samples = samples
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.resolution = resolution
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.proportion_empty_prompts = proportion_empty_prompts
        self.num_workers = num_workers
        self.emit_uint8 = emit_uint8
        self._rng = np.random.RandomState(seed)
        if use_native is None:
            # the C++ decoder wins through threading; single-core hosts are
            # better served by PIL's SIMD decode
            use_native = (os.cpu_count() or 1) >= 4
        self.use_native = use_native
        self.decoded: collections.Counter = collections.Counter()  # batches by decoder

    def __len__(self) -> int:
        """Batches per epoch on this process."""
        count = process_count()
        n_samples = len(self.samples) // count if count > 1 else len(self.samples)
        n = n_samples // self.batch_size
        if not self.drop_last and n_samples % self.batch_size:
            n += 1
        return n

    def _load_batch_native(self, batch_samples: list[Sample]):
        """The threaded C++ decode of one batch; None -> the PIL path."""
        from genima_torch.native import decode_png_batch, decode_png_batch_u8

        try:
            img_bytes = [Path(s.image_path).read_bytes() for s in batch_samples]
            cond_bytes = [Path(s.conditioning_image_path).read_bytes() for s in batch_samples]
        except OSError:
            return None
        if self.emit_uint8:
            pixels = decode_png_batch_u8(img_bytes, self.resolution, n_threads=self.num_workers)
            conds = decode_png_batch_u8(cond_bytes, self.resolution, n_threads=self.num_workers)
        else:
            pixels = decode_png_batch(img_bytes, self.resolution, mode=1,
                                      n_threads=self.num_workers)
            conds = decode_png_batch(cond_bytes, self.resolution, mode=0,
                                     n_threads=self.num_workers)
        if pixels is None or conds is None:
            return None
        return list(zip(pixels, conds))

    def _load_one(self, sample: Sample) -> tuple[np.ndarray, np.ndarray]:
        with Image.open(sample.image_path) as img, Image.open(sample.conditioning_image_path) as cnd:
            img = _resize_center_crop(img.convert("RGB"), self.resolution)
            cond = _resize_center_crop(cnd.convert("RGB"), self.resolution)
        if self.emit_uint8:
            return np.asarray(img, np.uint8), np.asarray(cond, np.uint8)
        pixel = np.asarray(img, np.float32) / 127.5 - 1.0  # [-1, 1]
        cond = np.asarray(cond, np.float32) / 255.0  # [0, 1]
        return pixel, cond

    def __iter__(self):
        order = np.arange(len(self.samples))
        if self.shuffle:
            self._rng.shuffle(order)
        count = process_count()
        if count > 1:
            n_full = len(order) // count  # the smallest rank's slice
            order = order[process_index()::count]
            if self.drop_last:
                order = order[:n_full - n_full % self.batch_size]
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                idx = order[start : start + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    return
                batch_samples = [self.samples[i] for i in idx]
                native = self._load_batch_native(batch_samples) if self.use_native else None
                decoded = native if native is not None else list(
                    pool.map(self._load_one, batch_samples))
                self.decoded["native" if native is not None else "pil"] += 1
                texts = [
                    "" if self._rng.rand() < self.proportion_empty_prompts else s.text
                    for s in batch_samples
                ]
                yield {
                    "pixel_values": np.stack([d[0] for d in decoded]),
                    "conditioning_pixel_values": np.stack([d[1] for d in decoded]),
                    "input_ids": np.asarray(self.tokenizer(texts), np.int32),
                }


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: through pinned memory and a
    non-blocking copy on the card (ordered on the current stream before the
    step that reads it)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class DevicePrefetcher:
    """A producer thread decodes the next batches and starts their copies to
    the device while the consumer steps on the current one; at most
    ``depth`` batches wait in between. An error in the producer is raised
    in the consumer."""

    def __init__(self, loader, device: Any, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self.loader:
                    if not put(to_device(batch, self.device)):
                        return
            except Exception as e:  # raised again in the consumer
                err.append(e)
            finally:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while (item := q.get()) is not None:
                yield item
        finally:
            stop.set()  # the consumer may stop early: let the producer exit
            thread.join(timeout=60)
        if err:
            raise err[0]
