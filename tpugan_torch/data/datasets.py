"""Dataset loading (port of ``tpugan/data/datasets.py``): MNIST, CIFAR-10,
CelebA and any image folder, plus the deterministic ``synthetic`` dataset.

A loader returns ``dict(images=uint8 NHWC array, labels=int32 array)``;
per-batch normalization to [-1, 1] and augmentation happen in the train
step.  The readers are the JAX package's, so both packages train on the
same pixels:

- MNIST: the idx files (``train-images-idx3-ubyte[.gz]``, labels beside).
- CIFAR-10: the python-pickle batches (``cifar-10-batches-py/data_batch_*``).
- CelebA: a folder of JPEG/PNG files, center-cropped to a square and
  resized (bilinear), with the ``Male`` column of ``list_attr_celeba.txt``
  as the label.  ``streaming`` ("on" | "off" | "auto") keeps a folder that
  would not fit ``max_ram_mb`` on disk as a ``StreamingImageFolder``, which
  decodes each batch's files when the pipeline draws it.
- ``load_image_folder``: any folder, the two-folder FID workflow's reader.

Decoding, cropping and resizing run through Pillow (imported where it is
used), exactly as the JAX package does: the machine with the card has it,
so the two packages' pixels agree bit for bit.  A missing dataset raises
``FileNotFoundError``; ``synthetic`` is deterministic in (name, size, seed).
"""

from __future__ import annotations

import gzip
import hashlib
import os
import pickle
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

DATASETS = ("mnist", "cifar10", "celeba", "synthetic")


def load_dataset(name: str, data_dir: str, *, image_size: int,
                 channels: int, synthetic_size: int = 10_000,
                 seed: int = 0, n_classes: int = 0,
                 streaming: str = "auto",
                 max_ram_mb: int = 4096) -> Dict[str, np.ndarray]:
    """``streaming`` selects the larger-than-RAM path for the CelebA
    folder: "auto" streams when the decoded dataset would exceed
    ``max_ram_mb``.  A streaming dataset's ``images`` is a
    ``StreamingImageFolder`` (array-like: len / slice / gather)."""
    if name == "mnist":
        return _fit_geometry(_load_mnist(data_dir), image_size, channels,
                             "mnist")
    if name == "cifar10":
        return _fit_geometry(_load_cifar10(data_dir), image_size, channels,
                             "cifar10")
    if name == "celeba":
        return _load_celeba(data_dir, image_size, streaming=streaming,
                            max_ram_mb=max_ram_mb)
    if name == "synthetic":
        return make_synthetic(image_size, channels, synthetic_size,
                              seed=seed, n_classes=n_classes)
    raise ValueError(f"unknown dataset {name!r}; available: {DATASETS}")


def _fit_geometry(data: Dict[str, np.ndarray], image_size: int,
                  channels: int, name: str) -> Dict[str, np.ndarray]:
    """Resize (PIL bilinear) and convert channels (1 -> 3 by repetition,
    3 -> 1 by the ITU-R 601 luma) to the model's geometry."""
    imgs = data["images"]  # uint8 NHWC
    n, h, _, c = imgs.shape
    if h != image_size:
        from PIL import Image

        mode = "L" if c == 1 else "RGB"
        out = np.empty((n, image_size, image_size, c), np.uint8)
        for i in range(n):
            a = imgs[i, :, :, 0] if c == 1 else imgs[i]
            r = Image.fromarray(a, mode).resize(
                (image_size, image_size), Image.BILINEAR)
            out[i] = np.asarray(r)[..., None] if c == 1 else np.asarray(r)
        imgs = out
    if c != channels:
        if c == 1 and channels == 3:
            imgs = np.repeat(imgs, 3, axis=-1)
        elif c == 3 and channels == 1:
            # ITU-R 601 luma, the PIL "L" formula
            imgs = np.clip(
                imgs[..., 0] * 0.299 + imgs[..., 1] * 0.587
                + imgs[..., 2] * 0.114, 0, 255).astype(np.uint8)[..., None]
        else:
            raise ValueError(
                f"{name}: cannot convert {c}-channel images to "
                f"{channels} channels")
    return {**data, "images": np.ascontiguousarray(imgs)}


# -- MNIST (idx format) -----------------------------------------------------

def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find(data_dir: str, names) -> Optional[str]:
    for root in (data_dir, os.path.join(data_dir, "MNIST", "raw"),
                 os.path.join(data_dir, "mnist")):
        for n in names:
            p = os.path.join(root, n)
            if os.path.exists(p):
                return p
    return None


def _load_mnist(data_dir: str) -> Dict[str, np.ndarray]:
    img_path = _find(data_dir, ["train-images-idx3-ubyte.gz",
                                "train-images-idx3-ubyte"])
    lbl_path = _find(data_dir, ["train-labels-idx1-ubyte.gz",
                                "train-labels-idx1-ubyte"])
    if img_path is None:
        raise FileNotFoundError(
            f"MNIST idx files not found under {data_dir!r}")
    images = _read_idx(img_path)[..., None]  # (N, 28, 28, 1)
    labels = (_read_idx(lbl_path).astype(np.int32)
              if lbl_path else np.zeros(len(images), np.int32))
    return {"images": images, "labels": labels}


# -- CIFAR-10 (python pickle batches) ---------------------------------------

def _load_cifar10(data_dir: str) -> Dict[str, np.ndarray]:
    for root in (os.path.join(data_dir, "cifar-10-batches-py"), data_dir):
        if os.path.exists(os.path.join(root, "data_batch_1")):
            xs, ys = [], []
            for i in range(1, 6):
                with open(os.path.join(root, f"data_batch_{i}"), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(d[b"data"])
                ys.extend(d[b"labels"])
            x = np.concatenate(xs).reshape(-1, 3, 32, 32)
            return {"images": np.ascontiguousarray(x.transpose(0, 2, 3, 1)),
                    "labels": np.asarray(ys, np.int32)}
    raise FileNotFoundError(f"CIFAR-10 batches not found under {data_dir!r}")


# -- CelebA and image folders -----------------------------------------------

def _decode(path: str, image_size: int, mode: str = "RGB") -> np.ndarray:
    """Center-crop to a square, then a bilinear resize (the reference
    transform chain)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert(mode)
        w, h = im.size
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        im = im.crop((left, top, left + side, top + side))
        im = im.resize((image_size, image_size), Image.BILINEAR)
        return np.asarray(im)


class StreamingImageFolder:
    """A larger-than-RAM image folder: each ``gather`` decodes its files in
    a thread pool (Pillow releases the interpreter lock while it decodes),
    so host memory holds only the batches in flight.  Array-like surface:
    ``len()``, ``gather(idx)``, int / slice / index-array ``[]``."""

    def __init__(self, root: str, files, image_size: int, workers: int = 8):
        self.root, self.files = root, list(files)
        self.image_size = int(image_size)
        self.workers = workers
        self.shape = (len(self.files), self.image_size, self.image_size, 3)
        self.dtype = np.dtype(np.uint8)
        self._pool: Optional[ThreadPoolExecutor] = None
        self.decoded_count = 0  # images decoded so far

    def __len__(self) -> int:
        return len(self.files)

    def fingerprint(self) -> str:
        """The dataset's identity without decoding: root, file list and
        geometry (the eval real-feature cache's key)."""
        h = hashlib.sha1()
        h.update(self.root.encode())
        for f in self.files:
            h.update(f.encode())
        h.update(str(self.image_size).encode())
        return h.hexdigest()

    def gather(self, idx) -> np.ndarray:
        idx = np.asarray(idx).reshape(-1)
        out = np.empty((len(idx), self.image_size, self.image_size, 3),
                       np.uint8)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers)

        def work(j_i):
            j, i = j_i
            out[j] = _decode(os.path.join(self.root, self.files[int(i)]),
                             self.image_size)

        list(self._pool.map(work, enumerate(idx)))
        self.decoded_count += len(idx)
        return out

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.gather([key])[0]
        if isinstance(key, slice):
            return self.gather(np.arange(len(self))[key])
        return self.gather(key)

    def close(self) -> None:
        """Stop the decode threads (a later ``gather`` starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def _load_celeba(data_dir: str, image_size: int, *, streaming: str = "auto",
                 max_ram_mb: int = 4096) -> Dict[str, np.ndarray]:
    files = []
    for root in (os.path.join(data_dir, "celeba", "img_align_celeba"),
                 os.path.join(data_dir, "img_align_celeba"), data_dir):
        if os.path.isdir(root):
            files = sorted(
                f for f in os.listdir(root)
                if f.lower().endswith((".jpg", ".jpeg", ".png")))
            if files:
                break
    if not files:
        raise FileNotFoundError(f"CelebA images not found under {data_dir!r}")

    labels = _load_celeba_attrs(data_dir, files)
    decoded_mb = len(files) * image_size * image_size * 3 / 2**20
    if streaming == "on" or (streaming == "auto" and decoded_mb > max_ram_mb):
        return {"images": StreamingImageFolder(root, files, image_size),
                "labels": labels}
    imgs = np.empty((len(files), image_size, image_size, 3), np.uint8)
    for i, fname in enumerate(files):
        imgs[i] = _decode(os.path.join(root, fname), image_size)
    return {"images": imgs, "labels": labels}


def _load_celeba_attrs(data_dir: str, files) -> np.ndarray:
    """The ``Male`` attribute as the 2-class conditioning label (0/1); all
    zero without the attribute file."""
    for cand in (os.path.join(data_dir, "celeba", "list_attr_celeba.txt"),
                 os.path.join(data_dir, "list_attr_celeba.txt")):
        if os.path.exists(cand):
            with open(cand) as f:
                f.readline()
                col = f.readline().split().index("Male")
                attr = {}
                for line in f:
                    parts = line.split()
                    attr[parts[0]] = 1 if parts[1 + col] == "1" else 0
            return np.asarray([attr.get(f, 0) for f in files], np.int32)
    return np.zeros(len(files), np.int32)


_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def load_image_folder(root: str, image_size: int, channels: int = 3,
                      limit: int = 0) -> np.ndarray:
    """Any folder of images (recursive) -> uint8 NHWC at one geometry:
    center-crop and bilinear resize as the CelebA reader, sorted file
    order, at most ``limit`` images (0: all)."""
    files = sorted(
        os.path.join(r, f)
        for r, _, fs in os.walk(root) for f in fs
        if f.lower().endswith(_IMG_EXTS))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images ({'/'.join(_IMG_EXTS)}) "
                                f"under {root!r}")
    mode = "L" if channels == 1 else "RGB"
    out = np.empty((len(files), image_size, image_size, channels), np.uint8)
    for i, path in enumerate(files):
        a = _decode(path, image_size, mode)
        out[i] = a[..., None] if channels == 1 else a
    return out


# -- synthetic (deterministic, offline) -------------------------------------

def make_synthetic(image_size: int, channels: int, n: int, *, seed: int = 0,
                   n_classes: int = 0) -> Dict[str, np.ndarray]:
    """Procedural images: per-class colored gaussian blobs on gradients,
    deterministic in the arguments (the JAX package's own generator, so
    both packages train on the same pixels)."""
    rng = np.random.default_rng(seed)
    k = max(n_classes, 1)
    labels = rng.integers(0, k, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    yy, xx = yy / image_size, xx / image_size
    imgs = np.empty((n, image_size, image_size, channels), np.uint8)
    centers = rng.uniform(0.25, 0.75, size=(n, 2)).astype(np.float32)
    widths = rng.uniform(0.05, 0.2, size=n).astype(np.float32)
    for i in range(n):
        cy, cx = centers[i]
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                      / (2 * widths[i] ** 2))
        base = 0.3 * xx + 0.2 * yy + 0.25
        phase = 2 * np.pi * labels[i] / k
        img = np.empty((image_size, image_size, channels), np.float32)
        for c in range(channels):
            gain = 0.5 + 0.5 * np.cos(phase + 2 * np.pi * c / max(channels, 1))
            img[..., c] = base + gain * blob
        imgs[i] = np.clip(img * 255, 0, 255).astype(np.uint8)
    return {"images": imgs, "labels": labels}
