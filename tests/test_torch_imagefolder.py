"""The port's ImageFolder dataset, crop sampling and native library against
the JAX package's, on the CPU.

The tree is written here with PIL: 3 classes of 4 train and 3 val JPEGs
at 120x90 (``tools/image_folder.py``), plus, in one train class, a tall
JPEG, a grayscale JPEG, a PNG, a CMYK JPEG (both refused by libjpeg and
repaired in PIL) and a JPEG truncated to 100 bytes (refused by both:
quarantined).  Both packages build the library from the same
``native/*.cpp``, so the port's samples, crop parameters and decoded
batches must equal the JAX package's bit for bit; the native batch
against PIL's is held, as JAX ``tests/test_imagefolder.py:143`` holds it,
within one uint8 level divided by min(std), plus 1e-4.

The JAX package's library is built and loaded once in this process, under
a file lock (:func:`_load_jax_native`), before the comparisons with it:
its loader runs ``make`` and then ``ctypes.CDLL`` with no lock across
processes, and latches a failed load for the life of the process, so a
worker that loads while another builds would lose every comparison.
"""
import fcntl
import logging
import os
import pickle
import time

import numpy as np
import pytest
from PIL import Image

from pytorch_distributed_training_tpu import native as jnative
from pytorch_distributed_training_tpu.data import datasets as jds
from pytorch_distributed_training_tpu_torch import native as tnative
from pytorch_distributed_training_tpu_torch.data import DataLoader, DistributedShardSampler
from pytorch_distributed_training_tpu_torch.data import datasets as tds
from pytorch_distributed_training_tpu_torch.telemetry.registry import get_registry
from pytorch_distributed_training_tpu_torch.tools.image_folder import write_image_folder

SIZE = 32
REFUSED = ("zz.png", "cmyk.jpg", "trunc.jpg")  # by libjpeg
# every process of this file builds the JAX library under this lock (the
# port's build directory, ignored by git)
JAX_NATIVE_LOCK = os.path.join(tnative.BUILD_DIR, "jax-native.lock")


def _load_jax_native(attempts: int = 40, wait_s: float = 0.5) -> bool:
    """Build (``make``) and load the JAX package's native library under
    :data:`JAX_NATIVE_LOCK`.  A process that does not take the lock (another
    test file's) may run the same ``make`` at once and leave the library
    half-written; the JAX loader then fails and latches the failure, so this
    clears the latch and loads again, under the lock, until the other build
    has finished."""
    os.makedirs(tnative.BUILD_DIR, exist_ok=True)
    with open(JAX_NATIVE_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(attempts):
            if jnative.ensure_built():
                return True
            jnative._build_failed = False
            time.sleep(wait_s)
    return False


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library, built and loaded in this process."""
    assert _load_jax_native(), "the JAX package's native library did not build and load"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagefolder"))
    write_image_folder(root, classes=3, train=4, val=3, width=120, height=90, seed=3)
    rng = np.random.default_rng(7)
    d = os.path.join(root, "train", "n00000001")

    def noise(w, h):
        base = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
        return Image.fromarray(base).resize((w, h), Image.BILINEAR)

    noise(70, 200).save(os.path.join(d, "tall.JPEG"), "JPEG", quality=85)
    noise(64, 48).convert("L").save(os.path.join(d, "gray.JPEG"), "JPEG")
    noise(50, 40).save(os.path.join(d, "zz.png"))
    noise(60, 60).convert("CMYK").save(os.path.join(d, "cmyk.jpg"), "JPEG")
    trunc = os.path.join(d, "trunc.jpg")
    noise(100, 80).save(trunc, "JPEG")
    with open(trunc, "r+b") as fp:
        fp.truncate(100)
    return root


def _pair(root, split):
    return (tds.get_dataset("imagenet", root, split, image_size=SIZE),
            jds.get_dataset("imagenet", root, split, image_size=SIZE))


def _index(ds, name):
    return next(i for i, (p, _) in enumerate(ds.samples) if p.endswith(name))


@pytest.mark.parametrize("split,n", [("train", 17), ("val", 9)])
def test_listing_and_class_mapping_match_jax(tree, split, n):
    t, j = _pair(tree, split)
    assert isinstance(t, tds.ImageFolderDataset)
    assert t.class_to_idx == j.class_to_idx == {f"n{c:08d}": c for c in range(3)}
    assert t.samples == j.samples and len(t) == n
    assert t.train == j.train == (split == "train")
    np.testing.assert_array_equal(t.norm_mean, j.norm_mean)
    np.testing.assert_array_equal(t.norm_std, j.norm_std)


def test_missing_or_empty_root_raises(tmp_path):
    for get in (tds.get_dataset, jds.get_dataset):
        with pytest.raises(FileNotFoundError, match="split dir not found"):
            get("imagenet", str(tmp_path / "none"), "train")
    (tmp_path / "train").mkdir()
    with pytest.raises(FileNotFoundError, match="no class directories"):
        tds.get_dataset("imagenet", str(tmp_path), "train")


def _centre_fallback(w, h):
    """torchvision's box after 10 failed draws (no draw fits 33 x 1000)."""
    if w / h < 3 / 4:
        cw, ch = w, round(w / (3 / 4))
    elif w / h > 4 / 3:
        cw, ch = round(h * (4 / 3)), h
    else:
        cw, ch = w, h
    return float((w - cw) // 2), float((h - ch) // 2), float(cw), float(ch)


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_sample_crop_params_bitwise(train):
    sizes = [(500, 375), (375, 500), (64, 48), (33, 1000), (1000, 33), (224, 224), (17, 19),
             (4000, 3000)]
    fallbacks = 0
    for w, h in sizes:
        for seed, epoch, idx in [(0, 0, 0), (7, 3, 11), (2**32 + 5, 1, 123456), (1, 99, 7)]:
            for size in (224, SIZE):
                trng = tds.sample_rng(seed, epoch, idx) if train else None
                jrng = jds.sample_rng(seed, epoch, idx) if train else None
                got = tds.sample_crop_params(w, h, trng, train, size=size)
                want = jds.sample_crop_params(w, h, jrng, train, size=size)
                assert got == want and [type(x) for x in got] == [type(x) for x in want]
                fallbacks += train and got[:4] == _centre_fallback(w, h)
    if train:
        assert fallbacks > 0  # the centre-crop fallback of the extreme aspects ran too
        with pytest.raises(ValueError, match="RNG"):
            tds.sample_crop_params(10, 10, None, True)


@pytest.mark.parametrize("split", ["train", "val"])
def test_samples_and_crop_tasks_bitwise(tree, split):
    t, j = _pair(tree, split)
    for idx in range(len(t)):
        ti, tl = t.get_sample(idx, tds.sample_rng(5, 1, idx))
        ji, jl = j.get_sample(idx, jds.sample_rng(5, 1, idx))
        assert ti.dtype == np.uint8 and ti.shape == (SIZE, SIZE, 3)
        assert type(tl) is type(jl) is np.int64 and tl == jl
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(t[idx][0], j[idx][0])
        assert t.crop_task(idx, tds.sample_rng(2, 0, idx)) == j.crop_task(
            idx, jds.sample_rng(2, 0, idx))
        assert t.image_dims(idx) == j.image_dims(idx)


def _batch_args(ds):
    tasks = [ds.crop_task(i, tds.sample_rng(0, 0, i)) for i in range(len(ds))]
    return ([t[0] for t in tasks], np.asarray([t[2][:4] for t in tasks]),
            np.asarray([t[2][4] for t in tasks], np.uint8))


@pytest.mark.parametrize("dct", [1, 2, 0])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_decode_jpeg_batch_matches_jax(tree, jax_native, dtype, dct):
    ds, _ = _pair(tree, "train")
    paths, boxes, flips = _batch_args(ds)
    norm = (None, None) if dtype == "uint8" else (ds.norm_mean, ds.norm_std)
    got, status = tnative.decode_jpeg_batch(paths, boxes, flips, SIZE, *norm, dct_denom=dct,
                                            n_threads=3)
    want, jstatus = jnative.decode_jpeg_batch(paths, boxes, flips, SIZE, *norm, dct_denom=dct,
                                              n_threads=2)
    assert got.dtype == np.dtype(dtype) and got.shape == (len(paths), SIZE, SIZE, 3)
    np.testing.assert_array_equal(status, jstatus)
    refused = [i for i, p in enumerate(paths) if p.endswith(REFUSED)]
    assert sorted(np.nonzero(status)[0]) == refused
    ok = status == 0
    np.testing.assert_array_equal(got[ok], want[ok])
    # the caller's buffer, written in place
    buf = np.zeros_like(got)
    out, _ = tnative.decode_jpeg_batch(paths, boxes, flips, SIZE, *norm, out=buf,
                                       dct_denom=dct)
    assert out is buf
    np.testing.assert_array_equal(buf[ok], got[ok])


def test_decode_rejects_bad_arguments(tree):
    ds, _ = _pair(tree, "val")
    paths, boxes, flips = _batch_args(ds)
    with pytest.raises(ValueError, match="both be None"):
        tnative.decode_jpeg_batch(paths, boxes, flips, SIZE, ds.norm_mean, None)
    with pytest.raises(ValueError, match="mismatch"):
        tnative.decode_jpeg_batch(paths, boxes[:-1], flips, SIZE, None, None)
    with pytest.raises(ValueError, match="bad out buffer"):
        tnative.decode_jpeg_batch(paths, boxes, flips, SIZE, None, None,
                                  out=np.zeros((len(paths), SIZE, SIZE, 3), np.float32))


def test_normalize_batch_matches_jax(jax_native):
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (3, 17, 19, 3), dtype=np.uint8)
    got = tnative.normalize_batch(batch, tds.IMAGENET_MEAN, tds.IMAGENET_STD, n_threads=2)
    np.testing.assert_array_equal(
        got, jnative.normalize_batch(batch, jds.IMAGENET_MEAN, jds.IMAGENET_STD))
    ref = (batch.astype(np.float32) / 255.0 - tds.IMAGENET_MEAN) / tds.IMAGENET_STD
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="NHWC3"):
        tnative.normalize_batch(batch.astype(np.float32), tds.IMAGENET_MEAN, tds.IMAGENET_STD)
    with pytest.raises(ValueError, match=r"shape \(3,\)"):
        tnative.normalize_batch(batch, tds.IMAGENET_MEAN[:2], tds.IMAGENET_STD)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_native_batch_repairs_refused_rows_in_pil(tree, dtype):
    """One native batch of the whole train split: the rows libjpeg refuses
    are PIL's pixels for the params sampled for them (zeros for the file
    PIL refuses too); every row lies within one uint8 level of PIL's."""
    ds, _ = _pair(tree, "train")
    sampler = DistributedShardSampler(len(ds), 1, 0, shuffle=False)
    got, labels = next(iter(DataLoader(ds, len(ds), sampler, num_workers=2,
                                       worker_mode="native", output_dtype=dtype)))
    pil, pil_labels = next(iter(DataLoader(ds, len(ds), sampler, num_workers=2,
                                           worker_mode="thread", output_dtype=dtype)))
    np.testing.assert_array_equal(labels, pil_labels)
    np.testing.assert_array_equal(labels, [lab for _, lab in ds.samples])
    for name in REFUSED:
        i = _index(ds, name)
        want = ds.decode_with_params(i, ds.crop_task(i, tds.sample_rng(0, 0, i))[2])
        if dtype == "float32":
            want = tnative.normalize_batch(want[None], ds.norm_mean, ds.norm_std)[0]
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got[i], pil[i])
    trunc = _index(ds, "trunc.jpg")
    assert not ds.decode_with_params(trunc, (0.0, 0.0, 4.0, 4.0, False)).any()
    level = 1.0 if dtype == "uint8" else 1.0 / 255.0 / float(tds.IMAGENET_STD.min()) + 1e-4
    assert float(np.abs(got.astype(np.float32) - pil.astype(np.float32)).max()) <= level


def test_quarantine_zeros_counter_and_one_log_line(tree, caplog):
    ds, _ = _pair(tree, "train")
    i = _index(ds, "trunc.jpg")
    counter = get_registry().counter("data_corrupt_samples")
    before = counter.value
    with caplog.at_level(logging.WARNING, logger=tds.__name__):
        img, label = ds.get_sample(i, tds.sample_rng(0, 0, i))
        again, _ = ds.get_sample(i, tds.sample_rng(0, 1, i))
        fixed = ds.decode_with_params(i, (1.0, 2.0, 30.0, 30.0, True))
    for arr in (img, again, fixed):
        assert arr.shape == (SIZE, SIZE, 3) and arr.dtype == np.uint8 and not arr.any()
    assert label == ds.samples[i][1] == 1
    assert counter.value == before + 3
    lines = [r for r in caplog.records if "quarantined corrupt sample" in r.getMessage()]
    assert len(lines) == 1 and ds.samples[i][0] in lines[0].getMessage()
    assert ds.image_dims(i) == (SIZE, SIZE)  # the header does not open: placeholder dims


def test_pickles_without_locks(tree):
    ds, _ = _pair(tree, "train")
    ds.image_dims(0)
    clone = pickle.loads(pickle.dumps(ds))
    assert clone._dims_cache is None and clone._corrupt_logged == set()
    assert clone.samples == ds.samples
    assert clone.crop_task(3, tds.sample_rng(1, 2, 3)) == ds.crop_task(3, tds.sample_rng(1, 2, 3))


def test_native_build_lands_in_build_dir():
    path = tnative.build()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert os.path.basename(path).startswith("libpdt_native-") and path.endswith(".so")
    assert os.path.isfile(path) and tnative.library_path() == path
    assert tnative.library_path("clang++") != path  # the compiler is part of the key
    package = os.path.dirname(os.path.dirname(os.path.abspath(tnative.__file__)))
    assert tnative.BUILD_DIR == os.path.join(package, "_build")
    repo = os.path.dirname(package)
    with open(os.path.join(repo, ".gitignore")) as fp:
        assert "pytorch_distributed_training_tpu_torch/_build/" in fp.read().split()


def test_native_build_failure_raises_with_the_compiler_output(tmp_path):
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'fatal error: jpeglib.h: No such file or directory'\n"
                    "exit 1\n")
    fake.chmod(0o755)
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="(?s)exit 1.*jpeglib.h: No such file"):
        tnative.build(cxx=str(fake), build_dir=str(out))
    with pytest.raises(RuntimeError, match="native library failed"):
        tnative.build(cxx=str(tmp_path / "no-such-compiler"), build_dir=str(out))
    assert [p.name for p in out.iterdir()] == ["native.lock"]  # nothing half-written
