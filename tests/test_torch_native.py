"""The port's native libpng/libtiff decoder vs :mod:`tpu_inspect.native`.

Both packages compile the same ``tin_io.cc``; the port builds it into its
own ``_build/`` directory. Each decode must equal the JAX package's and
cv2.imread(IMREAD_UNCHANGED) bit-exactly, or decline (None) where the JAX
package's declines; the prefetching loader delivers frames in path order.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tpu_inspect import native as jnative
from tpu_inspect.imageio import load_gray as j_load_gray

from tpu_inspect_torch import native
from tpu_inspect_torch.imageio import load_gray, load_gray_stream


@pytest.fixture(scope="module")
def libs():
    if native.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("native build unavailable (no g++/libpng/libtiff)")
    return True


def _images():
    rng = np.random.RandomState(0)
    return [
        ("g8.png", rng.randint(0, 256, (37, 53), dtype=np.uint8)),
        ("g8.tif", rng.randint(0, 256, (21, 17), dtype=np.uint8)),
        ("g16.png", rng.randint(0, 65536, (25, 31), dtype=np.uint16)),
        ("g16.tif", rng.randint(0, 65536, (12, 9), dtype=np.uint16)),
        ("c8.png", rng.randint(0, 256, (20, 24, 3), dtype=np.uint8)),
        ("c8.tif", rng.randint(0, 256, (11, 13, 3), dtype=np.uint8)),
        ("c8a.png", rng.randint(0, 256, (20, 24, 4), dtype=np.uint8)),
        ("c16.png", rng.randint(0, 65536, (9, 10, 3), dtype=np.uint16)),
        ("f32.tif", rng.rand(7, 7).astype(np.float32)),  # declined: cv2 decodes it
        ("b.bmp", rng.randint(0, 256, (6, 5), dtype=np.uint8)),  # declined container
    ]


def _write(tmp_path):
    paths = []
    for name, img in _images():
        p = str(tmp_path / name)
        assert cv2.imwrite(p, img)
        paths.append(p)
    return paths


def test_decode_matches_jax_and_cv2(libs, tmp_path):
    """Gray u8/u16, BGR, BGRA (PNG and TIFF) decode as cv2 does; a float
    TIFF and a BMP are declined by both libraries; the gray conversion
    equals the JAX package's for every file."""
    for p in _write(tmp_path):
        got, ref = native.decode(p), jnative.decode(p)
        if ref is None:
            assert got is None, p
            assert p.endswith((".bmp", "f32.tif"))
        else:
            want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            assert got.dtype == ref.dtype == want.dtype, p
            np.testing.assert_array_equal(got, ref, err_msg=p)
            np.testing.assert_array_equal(got, want, err_msg=p)
        np.testing.assert_array_equal(load_gray(p), j_load_gray(p), err_msg=p)
    assert native.version() == jnative.get_lib().tin_version().decode()


def test_stream_loader_order_matches_jax(libs, tmp_path):
    """More threads than capacity, declined frames included: frames come
    back in path order, each equal to the JAX package's loader's; the gray
    stream equals load_gray per path; an unreadable path yields None."""
    paths = _write(tmp_path) * 2 + [str(tmp_path / "missing.png")]
    got = list(native.StreamLoader(paths, capacity=2, threads=4))
    ref = list(jnative.StreamLoader(paths, capacity=2, threads=4))
    assert len(got) == len(ref) == len(paths)
    for g, r, p in zip(got, ref, paths):
        if r is None:
            assert g is None, p
        else:
            np.testing.assert_array_equal(g, r, err_msg=p)
    assert got[-1] is None
    grays = list(load_gray_stream(paths[:-1], capacity=2, threads=2))
    for g, p in zip(grays, paths):
        np.testing.assert_array_equal(g, load_gray(p), err_msg=p)
    loader = native.StreamLoader(paths, capacity=1, threads=2)
    it = iter(loader)
    next(it)
    loader.close()  # closed while suspended: the rest degrade to None
    assert list(it) == [None] * (len(paths) - 1)


def test_encode_png_gray_roundtrip(libs, tmp_path):
    img = np.random.RandomState(5).randint(0, 256, (19, 23), dtype=np.uint8)
    p = str(tmp_path / "enc.png")
    assert native.encode_png_gray(p, img)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(native.decode(p), img)
    assert not native.encode_png_gray(p, img.astype(np.uint16))


def test_library_is_built_in_the_build_dir():
    """The library lands in the port's gitignored build directory, keyed by
    a hash of its source; never beside the source."""
    path = native.library_path()
    assert path.parent.name == "_build" and path.name.startswith("libtin_io_")
    assert not list(path.parent.parent.joinpath("native").glob("*.so"))
