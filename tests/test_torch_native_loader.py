"""The port's native prefetching frame loader (io/native_loader.py) against
the JAX package's, the counterpart of tests/test_native_loader.py: the same
library (native/libframeloader.so), in-order delivery, grayscale frames
equal to cv2's and to the JAX loader's bit for bit, depth mode, and the
synchronous cv2 decode when the library is absent."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from multiagent_orb_slam2_tpu.io import native_loader as jloader
from multiagent_orb_slam2_tpu_torch.io import native_loader


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
        img[0, 0] = i  # sentinel to verify ordering
        p = str(d / f"{i:03d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


def test_native_available():
    assert native_loader.available(), \
        "native/libframeloader.so not built (make -C native)"


def test_in_order_delivery(png_dir):
    ld = native_loader.PrefetchLoader(png_dir, n_threads=3, queue_cap=4)
    for i in range(12):
        f = ld.next()
        assert f is not None and f.shape == (48, 64)
        assert int(f[0, 0]) == i
    assert ld.next() is None
    ld.close()


def test_frames_equal_cv2_and_the_jax_loader(png_dir):
    ld = native_loader.PrefetchLoader(png_dir, n_threads=2)
    jl = jloader.PrefetchLoader(png_dir, n_threads=2)
    for p in png_dir:
        f = ld.next()
        ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32)
        np.testing.assert_array_equal(f, ref)
        np.testing.assert_array_equal(f, jl.next())
    assert ld.next() is None and jl.next() is None
    ld.close()
    jl.close()


def test_depth_mode(tmp_path):
    depth = (np.arange(48 * 64, dtype=np.uint16).reshape(48, 64) * 7) % 60000
    p = str(tmp_path / "d.png")
    cv2.imwrite(p, depth)
    ld = native_loader.PrefetchLoader([p], depth_scale=5000.0)
    out = ld.next()
    ld.close()
    np.testing.assert_allclose(out, depth.astype(np.float32) / 5000.0,
                               rtol=1e-6)
    jl = jloader.PrefetchLoader([p], depth_scale=5000.0)
    np.testing.assert_array_equal(out, jl.next())
    jl.close()


def test_cv2_decode_without_the_library(png_dir, monkeypatch):
    monkeypatch.setattr(native_loader, "_LIB_PATH", "/nonexistent.so")
    monkeypatch.setattr(native_loader, "_lib", None)
    assert not native_loader.available()
    ld = native_loader.PrefetchLoader(png_dir[:3])
    for p in png_dir[:3]:
        np.testing.assert_array_equal(
            ld.next(), cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(np.float32))
    assert ld.next() is None
    ld.close()
