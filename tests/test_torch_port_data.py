"""The port's dataset readers and host gather against the JAX package's:
MNIST idx, CIFAR-10 pickles, a CelebA folder with its attribute file (in
RAM, streaming, and through the Trainer), ``load_image_folder``, and the
C++ ``batch_gather`` / ``normalize_u8_f32`` against their numpy twins and
``tpugan.native``.

Tolerances: every reader decodes, crops and resizes through Pillow as the
JAX package does, so each array is held bit for bit, resized ones included.
"""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest
from PIL import Image

from tpugan import native as jax_native
from tpugan.data.datasets import load_dataset as jax_load
from tpugan.data.datasets import load_image_folder as jax_folder
from tpugan.data.pipeline import make_input_pipeline as jax_pipeline
from tpugan_torch.configs import get_preset
from tpugan_torch.data import native
from tpugan_torch.data.datasets import (StreamingImageFolder, load_dataset,
                                        load_image_folder)
from tpugan_torch.data.pipeline import make_input_pipeline
from tpugan_torch.train.trainer import Trainer


def _write_idx(path, arr, magic):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


@pytest.fixture
def mnist_dir(tmp_path):
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, size=(12, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, size=12).astype(np.uint8)
    _write_idx(str(tmp_path / "train-images-idx3-ubyte.gz"), imgs, 0x803)
    _write_idx(str(tmp_path / "train-labels-idx1-ubyte.gz"), labels, 0x801)
    return tmp_path, imgs, labels


@pytest.fixture
def celeba_dir(tmp_path):
    """Six 218 x 178 images (CelebA's aligned geometry), PNG and JPEG, and
    an attribute file whose Male column is the label."""
    rng = np.random.default_rng(2)
    root = tmp_path / "img_align_celeba"
    os.makedirs(root)
    names = []
    for i in range(6):
        arr = rng.integers(0, 256, size=(218, 178, 3)).astype(np.uint8)
        name = f"{i:06d}.{'png' if i % 2 else 'jpg'}"
        Image.fromarray(arr).save(root / name)
        names.append(name)
    with open(tmp_path / "list_attr_celeba.txt", "w") as f:
        f.write(f"{len(names)}\nSmiling Male Young\n")
        for i, n in enumerate(names):
            f.write(f"{n} -1 {1 if i % 3 == 0 else -1} 1\n")
    return tmp_path


@pytest.mark.parametrize("size,channels", [(28, 1), (64, 1), (32, 3),
                                           (64, 3)])
def test_mnist_reader_is_jaxs(mnist_dir, size, channels):
    """Bit for bit at 28 px, and through ``_fit_geometry`` (PIL bilinear,
    1 -> 3 channels) at the model's geometry."""
    path, imgs, labels = mnist_dir
    got = load_dataset("mnist", str(path), image_size=size,
                       channels=channels)
    ref = jax_load("mnist", str(path), image_size=size, channels=channels)
    assert got["images"].shape == (12, size, size, channels)
    np.testing.assert_array_equal(got["images"], ref["images"])
    np.testing.assert_array_equal(got["labels"], labels.astype(np.int32))
    if size == 28 and channels == 1:
        np.testing.assert_array_equal(got["images"][..., 0], imgs)


@pytest.mark.parametrize("size,channels", [(32, 3), (64, 1)])
def test_cifar10_reader_is_jaxs(tmp_path, size, channels):
    rng = np.random.default_rng(3)
    root = tmp_path / "cifar-10-batches-py"
    os.makedirs(root)
    xs, ys = [], []
    for i in range(1, 6):
        x = rng.integers(0, 256, size=(3, 3072)).astype(np.uint8)
        y = [int(v) for v in rng.integers(0, 10, size=3)]
        with open(root / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": x, b"labels": y}, f)
        xs.append(x)
        ys.extend(y)
    got = load_dataset("cifar10", str(tmp_path), image_size=size,
                       channels=channels)
    ref = jax_load("cifar10", str(tmp_path), image_size=size,
                   channels=channels)
    np.testing.assert_array_equal(got["images"], ref["images"])
    np.testing.assert_array_equal(got["labels"], np.asarray(ys, np.int32))
    if size == 32:
        np.testing.assert_array_equal(got["images"], np.concatenate(
            xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))


def test_celeba_in_ram_and_streaming_are_jaxs(celeba_dir):
    ref = jax_load("celeba", str(celeba_dir), image_size=32, channels=3,
                   streaming="off")
    ram = load_dataset("celeba", str(celeba_dir), image_size=32, channels=3,
                       streaming="off")
    np.testing.assert_array_equal(ram["images"], ref["images"])
    np.testing.assert_array_equal(ram["labels"], [1, 0, 0, 1, 0, 0])
    np.testing.assert_array_equal(ram["labels"], ref["labels"])
    st = load_dataset("celeba", str(celeba_dir), image_size=32, channels=3,
                      streaming="on")
    images = st["images"]
    assert isinstance(images, StreamingImageFolder)
    assert images.shape == (6, 32, 32, 3) and images.decoded_count == 0
    jst = jax_load("celeba", str(celeba_dir), image_size=32, channels=3,
                   streaming="on")["images"]
    assert images.fingerprint() == jst.fingerprint()
    np.testing.assert_array_equal(images.gather([4, 1]),
                                  ram["images"][[4, 1]])
    assert images.decoded_count == 2
    np.testing.assert_array_equal(images[2], ram["images"][2])
    np.testing.assert_array_equal(images[1:5:2], ram["images"][1:5:2])
    assert images.decoded_count == 5
    images.close()
    # "auto" streams once the decoded set would exceed max_ram_mb
    auto = load_dataset("celeba", str(celeba_dir), image_size=32,
                        channels=3, streaming="auto", max_ram_mb=0)
    assert isinstance(auto["images"], StreamingImageFolder)


def test_missing_files_raise(tmp_path):
    for name in ("mnist", "cifar10", "celeba"):
        with pytest.raises(FileNotFoundError):
            load_dataset(name, str(tmp_path), image_size=32, channels=3)
    with pytest.raises(FileNotFoundError):
        load_image_folder(str(tmp_path), 32)


@pytest.mark.parametrize("channels", [1, 3])
def test_image_folder_is_jaxs(celeba_dir, channels):
    got = load_image_folder(str(celeba_dir), 24, channels, limit=5)
    ref = jax_folder(str(celeba_dir), 24, channels, limit=5)
    assert got.shape == (5, 24, 24, channels)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,hw", [(7, 8), (128, 8), (64, 256)],
                         ids=["one_thread", "one_thread_128", "threaded"])
def test_batch_gather_is_numpy_and_jaxs(n, hw):
    """The C++ gather, with and without flips, negative indices wrapping:
    numpy's result and ``tpugan.native``'s; the last case (64 images of
    256 x 254 x 3, 11.9 MiB) runs on more than one thread."""
    rng = np.random.default_rng(n)
    images = rng.integers(0, 256, size=(300, hw, hw - 2, 3)).astype(np.uint8)
    idx = rng.integers(-300, 300, size=n)
    flip = rng.integers(0, 2, size=n).astype(np.uint8)
    assert (native._threads(n * hw * (hw - 2) * 3) > 1) == (hw == 256)
    for f in (None, flip):
        got = native.batch_gather(images, idx, f)
        np.testing.assert_array_equal(
            got, native.batch_gather_plain(images, idx, f))
        np.testing.assert_array_equal(got, jax_native.batch_gather(
            images, idx, f))
    np.testing.assert_array_equal(native.batch_gather(images, idx),
                                  images[idx])


def test_batch_gather_bounds_and_layout():
    images = np.zeros((5, 4, 4, 3), np.uint8)
    for fn in (native.batch_gather, native.batch_gather_plain):
        with pytest.raises(IndexError):
            fn(images, [0, 5])
        with pytest.raises(IndexError):
            fn(images, [-6])
    with pytest.raises(ValueError, match="C-contiguous"):
        native.batch_gather(images[:, :, ::2], [0])
    with pytest.raises(ValueError, match="uint8"):
        native.batch_gather(images.astype(np.float32), [0])


def test_normalize_is_bit_exact():
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    x = np.tile(x, (600, 16))  # 9.4 MiB of float32 out: two threads
    assert native._threads(x.size * 4) == 2
    got = native.normalize_u8_f32(x)
    np.testing.assert_array_equal(got, native.normalize_u8_f32_plain(x))
    np.testing.assert_array_equal(got, jax_native.normalize_u8_f32(x))
    np.testing.assert_array_equal(got[:16],
                                  x[:16].astype(np.float32) / 127.5 - 1.0)


def test_streaming_pipeline_decodes_only_drawn_batches(celeba_dir):
    """The pipeline over a streaming folder yields the in-RAM pipeline's
    batches (and the JAX pipeline's), decoding only the batches drawn."""
    ram = load_dataset("celeba", str(celeba_dir), image_size=16, channels=3,
                       streaming="off")
    st = load_dataset("celeba", str(celeba_dir), image_size=16, channels=3,
                      streaming="on")
    got = iter(make_input_pipeline(st, 2, seed=4, device="cpu"))
    ref = iter(make_input_pipeline(ram, 2, seed=4, device="cpu"))
    jref = iter(jax_pipeline(ram, 2, seed=4))
    for _ in range(4):  # 3 batches an epoch: across an epoch boundary
        g, r, j = next(got), next(ref), next(jref)
        np.testing.assert_array_equal(g["image"].numpy(), r["image"].numpy())
        np.testing.assert_array_equal(g["label"].numpy(), r["label"].numpy())
        np.testing.assert_array_equal(r["image"].numpy(),
                                      np.asarray(j["image"]))
    got.close()
    ref.close()
    # the prefetch draws at most two batches beyond the four consumed
    assert 8 <= st["images"].decoded_count <= 12


def test_trainer_reads_the_dataset_files(celeba_dir, tmp_path):
    """``Trainer._dataset`` passes data_dir, streaming and max_ram_mb; a
    streaming dataset trains, and is refused with device_resident."""
    over = {"data.dataset": "celeba", "data.data_dir": str(celeba_dir),
            "data.batch_size": 2, "model.ngf": 4, "model.ndf": 4,
            "model.nz": 8, "train.precision": "fp32", "train.log_every": 1,
            "train.sample_every": 0, "train.ckpt_every": 0,
            "train.out_dir": str(tmp_path / "out"),
            "train.ckpt_dir": str(tmp_path / "ckpt")}
    cfg = get_preset("dcgan_celeba64").override(
        {**over, "data.streaming": "on"})
    tr = Trainer(cfg, device="cpu")
    tr.train(2)
    assert tr.state.step == 2
    images = tr._dataset()["images"]
    assert isinstance(images, StreamingImageFolder)
    assert images.decoded_count >= 4
    with pytest.raises(ValueError, match="streaming"):
        Trainer(cfg.override({"data.device_resident": True}),
                device="cpu").train(1)
    ram = Trainer(get_preset("dcgan_celeba64").override(
        {**over, "data.streaming": "auto"}), device="cpu")
    assert isinstance(ram._dataset()["images"], np.ndarray)
