"""The port's host runtime (srcfinder_torch.core.native, ops/csrc/native.cpp)
held against the JAX package's ``core.native`` and ``core.geotiff`` and
against its own plain versions, on the CPU: the BIL window repack, the
8-connected labels and the TIFF LZW codec, all bit for bit (the JAX
package's functions run its C++ extension where it is built, its numpy
and Python versions otherwise: the results are the same). Also the build
itself: atomic when processes build at once, and raising, never falling
back, without a compiler or on a compile error."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from srcfinder_tpu.core import geotiff as jgeotiff
from srcfinder_tpu.core import native as jnative
from srcfinder_torch import core as tcore
from srcfinder_torch.core import geotiff as tgeotiff
from srcfinder_torch.core import native
from srcfinder_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [np.float32, np.float64, np.int16, np.uint16, np.int32]


def _cube(dtype, shape=(40, 50, 66), seed=0):
    return (np.random.default_rng(seed).normal(size=shape) * 300).astype(dtype)


def _repack_checks(src, b0, b1, c0, c1):
    got = native.bil_window_to_lcb(src, b0, b1, c0, c1)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, jnative.bil_window_to_lcb(src, b0, b1, c0, c1))
    np.testing.assert_array_equal(got, native.bil_window_to_lcb_plain(src, b0, b1, c0, c1))
    return got


@pytest.mark.parametrize("dtype", DTYPES)
def test_repack_matches_jax_and_plain(dtype):
    _repack_checks(_cube(dtype), 4, 20, 5, 61)


@pytest.mark.parametrize("dtype", DTYPES)
def test_repack_strided_source(dtype):
    """Views of any strides (every other band, samples reversed)."""
    view = _cube(dtype, seed=1)[:, ::2, ::-1]
    assert not view.flags.c_contiguous
    _repack_checks(view, 0, 25, 3, 40)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["r", "r+"])
def test_repack_memmap_source(tmp_path, dtype, mode):
    """A BIL file through np.memmap, read-only too, into a given ``out``."""
    cube = _cube(dtype, seed=2)
    path = str(tmp_path / "cube.bil")
    cube.tofile(path)
    mm = np.memmap(path, dtype=dtype, mode=mode, shape=cube.shape)
    out = np.full((40, 30, 12), np.nan, np.float32)
    got = native.bil_window_to_lcb(mm, 50 - 12, 50, 36, 66, out=out)
    assert got is out
    np.testing.assert_array_equal(got, jnative.bil_window_to_lcb(mm, 38, 50, 36, 66))
    np.testing.assert_array_equal(got, native.bil_window_to_lcb_plain(cube, 38, 50, 36, 66))


def test_repack_rejects_bad_arguments():
    cube = _cube(np.float32)
    with pytest.raises(TypeError, match="dtype"):
        native.bil_window_to_lcb(cube.astype(np.uint8), 0, 2, 0, 2)
    with pytest.raises(ValueError, match="window"):
        native.bil_window_to_lcb(cube, 0, 51, 0, 2)
    with pytest.raises(ValueError, match="out"):
        native.bil_window_to_lcb(cube, 0, 2, 0, 3, out=np.empty((40, 2, 3), np.float32))
    with pytest.raises(ValueError, match="3-D"):
        native.bil_window_to_lcb(cube[0], 0, 2, 0, 3)


def _label_masks():
    rng = np.random.default_rng(3)
    masks = {f"density_{p}": rng.random((180, 150)) < p for p in (0.2, 0.5, 0.8)}
    masks.update(empty=np.zeros((30, 20), bool), full=np.ones((30, 20), bool),
                 diagonal=np.eye(25, dtype=bool), anti_diagonal=np.eye(25, dtype=bool)[::-1],
                 one_row=rng.random((1, 300)) < 0.5, one_column=rng.random((300, 1)) < 0.5,
                 uint8_values=rng.integers(0, 3, (60, 70)).astype(np.uint8))
    return masks


@pytest.mark.parametrize("name", sorted(_label_masks()))
def test_label8_ids_match_jax(name):
    """Id for id: components numbered from 1 in the raster order of their
    first pixel, as scipy numbers them."""
    mask = _label_masks()[name]
    got = native.label8(mask)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jnative.label8(mask))
    np.testing.assert_array_equal(got, native.label8_plain(mask))
    if name == "diagonal":
        assert got.max() == 1                   # 8-connectivity joins diagonals
    if name == "full":
        assert (got == 1).all()


def _lzw_inputs():
    """The cases of test_torch_qc.py::test_lzw_encoder_bytes_equal_jax and
    the edges: empty, one byte, one byte repeated past many table resets."""
    rng = np.random.default_rng(5)
    nodata = np.full((150, 160, 4), -9999, np.float32)
    nodata[20:130, 30:140] = rng.uniform(0, 5, (110, 110, 4))
    return {"noise": rng.normal(100, 30, (120, 200, 4)).astype(np.float32).tobytes(),
            "nodata": nodata.tobytes(),
            "steps": np.repeat(rng.integers(0, 256, 4000, dtype=np.uint8), 25).tobytes(),
            "empty": b"", "one_byte": b"\x07", "two_bytes": b"\xff\x00",
            "one_value_long": b"\x00" * 3_000_000,
            "random_bytes": rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()}


@pytest.mark.parametrize("case", sorted(_lzw_inputs()))
def test_lzw_bytes_equal_jax_and_round_trip(case):
    data = _lzw_inputs()[case]
    got = native.lzw_encode(data)
    assert got == jgeotiff._lzw_encode_py(data) == tgeotiff._lzw_encode_py(data)
    assert native.lzw_decode(got) == data
    assert native.lzw_decode(got, len(data)) == data
    assert native.lzw_decode(got, 1) == data                  # the buffer grows
    assert native.lzw_decode(bytearray(got)) == data          # any bytes-like
    assert tgeotiff._lzw_decode_py(got) == data


def _pack(codes, bits=9):
    acc = "".join(format(c, f"0{bits}b") for c in codes)
    acc += "0" * (-len(acc) % 8)
    return bytes(int(acc[i:i + 8], 2) for i in range(0, len(acc), 8))


def test_lzw_decode_corrupt_and_truncated():
    with pytest.raises(ValueError, match="corrupt LZW stream"):
        native.lzw_decode(_pack([256, 300]))                 # a string code first
    with pytest.raises(ValueError, match="corrupt LZW stream"):
        native.lzw_decode(_pack([256, 65, 400]))             # a code past the table
    # no EOI: the decoder stops at the end of the input, as the plain one does
    stream = _pack([256, 65, 66, 258])
    assert native.lzw_decode(stream) == tgeotiff._lzw_decode_py(stream) == b"ABAB"


def test_lzw_threads_encode_at_once():
    """Four threads encoding at once give the bytes of serial calls."""
    rng = np.random.default_rng(6)
    inputs = [rng.normal(i, 10, (256, 256, 4)).astype(np.float32).tobytes() for i in range(8)]
    serial = [native.lzw_encode(d) for d in inputs]
    with ThreadPoolExecutor(max_workers=4) as pool:
        for _ in range(3):
            assert list(pool.map(native.lzw_encode, inputs)) == serial
            assert list(pool.map(native.lzw_decode, serial)) == inputs


@pytest.mark.parametrize("mode,dtype,bands", [("F", np.float32, 1), ("L", np.uint8, 1),
                                              ("RGB", np.uint8, 3), ("I;16", np.uint16, 1)])
def test_pillow_lzw_tiff_decodes(tmp_path, mode, dtype, bands):
    """A TIFF written by Pillow with LZW (several strips) reads back."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(7)
    shape = (301, 257, 3) if bands == 3 else (301, 257)
    arr = (rng.normal(100, 30, shape) if dtype == np.float32
           else rng.integers(0, np.iinfo(dtype).max, shape)).astype(dtype)
    arr[100:200, 50:150] = arr[0, 0]                              # long runs
    path = str(tmp_path / "pil.tif")
    img = Image.fromarray(arr)
    assert img.mode == mode
    img.save(path, compression="tiff_lzw")
    with Image.open(path) as back:
        assert len(back.tag_v2[273]) > 1                         # strips
    got, _ = tgeotiff.read_geotiff(path)
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, jgeotiff.read_geotiff(path)[0])


@pytest.mark.parametrize("dtype,bands", [(np.float32, 4), (np.float32, 1), (np.int16, 1),
                                         (np.uint8, 3)])
def test_write_geotiff_lzw_same_file_as_jax(tmp_path, dtype, bands):
    rng = np.random.default_rng(8)
    arr = (rng.normal(0, 500, (97, 131, bands))).astype(dtype)
    arr[:10] = -9999 if dtype != np.uint8 else 0
    mapinfo = {"proj": "UTM", "zone": 11, "hemi": "North", "ulx": 391000.0,
               "uly": 3786000.0, "xps": 3.0, "yps": 3.0, "rotation": 0.0}
    kw = dict(mapinfo=mapinfo, nodata=-9999.0, compress="lzw")
    tgeotiff.write_geotiff(str(tmp_path / "t.tif"), arr, **kw)
    jgeotiff.write_geotiff(str(tmp_path / "j.tif"), arr, **kw)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    got, meta = tgeotiff.read_geotiff(str(tmp_path / "t.tif"))
    np.testing.assert_array_equal(got, arr[..., 0] if bands == 1 else arr)


def test_package_names_and_flag():
    assert tcore.HAVE_NATIVE is True and native.HAVE_NATIVE is True
    assert tcore.label8 is native.label8 and tcore.bil_window_to_lcb is native.bil_window_to_lcb


def test_processes_build_at_once(tmp_path):
    """Four processes building the library into an empty directory at once
    all load it; one library and its log are left, no partial file."""
    code = ("import sys\nfrom srcfinder_torch.ops import build\nbuild.BUILD_DIR = sys.argv[1]\n"
            "from srcfinder_torch.core import native\n"
            "assert native.lzw_decode(native.lzw_encode(b'abcabcabc')) == b'abcabcabc'\n"
            "assert 'torch' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
    assert sorted(f.rsplit(".", 1)[-1] for f in os.listdir(tmp_path)) == ["log", "so"]


def test_build_raises_without_compiler_or_on_error(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    bad = tmp_path / "bad.cpp"
    bad.write_text('extern "C" int f() { return undeclared; }\n')
    lib = build.HostLibrary(str(bad), {"f": (None, [])})
    with pytest.raises(RuntimeError, match="undeclared"):
        lib.load()
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        build.HostLibrary(str(bad), {}).load()
