"""The port's ENVI reads through its own reader
(srcfinder_torch.core.directio, copies out of a read-only mapping), held
byte for byte against the raw file, the JAX package's DirectFile and the
JAX package's EnviImage readers, over bil, bip and bsq and the sample
types of the main path's products."""

import numpy as np
import pytest

from srcfinder_tpu.core import directio as jdio
from srcfinder_tpu.core import envi as jenvi
from srcfinder_torch.core import directio as tdio
from srcfinder_torch.core import envi as tenvi


@pytest.fixture
def blob(tmp_path, rng):
    data = rng.integers(0, 256, size=3_000_000, dtype=np.uint8).tobytes()
    p = tmp_path / "blob.bin"
    p.write_bytes(data)
    return str(p), data


def test_read_range_matches_raw_bytes_and_jax(blob):
    path, data = blob
    cases = [(0, 4096), (1, 4095), (4095, 2), (4096, 4096), (123_457, 777_001),
             (len(data) - 5, 5), (len(data) - 4097, 4097), (0, len(data))]
    with tdio.DirectFile(path) as df, jdio.DirectFile(path) as jf:
        for off, n in cases:
            got = df.read_range(off, n)
            assert got.tobytes() == data[off:off + n], (off, n)
            assert got.tobytes() == jf.read_range(off, n).tobytes()
        with pytest.raises(ValueError):
            df.read_range(len(data) - 1, 2)
        assert df.read_range(5, 0).size == 0


def test_read_strided_matches_raw_bytes_and_jax(tmp_path, rng):
    arr = rng.integers(0, 256, size=(64, 1000), dtype=np.uint8)
    big = rng.integers(0, 256, size=(3, 2_000_000), dtype=np.uint8)
    p = tmp_path / "rows.bin"
    p.write_bytes(arr.tobytes() + big.tobytes())
    base = arr.size
    cases = [([r * 1000 for r in range(0, 64, 3)], 1000, arr[::3]),    # gaps
             ([r * 1000 for r in range(64)], 1000, arr),                # one run
             ([5 * 1000 + 7, 9 * 1000 + 3], 993, np.stack(             # unaligned
                 [arr[5, 7:], arr[9, 3:996]])),
             ([r * 1000 for r in (40, 2, 3, 17)], 1000, arr[[40, 2, 3, 17]]),   # uneven

             ([base + r * 2_000_000 for r in range(3)], 2_000_000, big)]   # > 4 MB run
    with tdio.DirectFile(str(p)) as df, jdio.DirectFile(str(p)) as jf:
        for offs, n, want in cases:
            got = df.read_strided(offs, n)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, jf.read_strided(offs, n))
        assert df.read_strided([], 10).shape == (0, 10)
        with pytest.raises(ValueError):
            df.read_strided([p.stat().st_size - 5], 10)


@pytest.mark.parametrize("rows", [1, 5])
def test_read_strided_into_rows_apart(blob, rows):
    """Reads land in a destination whose rows lie apart (a band run's
    slice of a line block), and nothing outside those rows is written."""
    path, data = blob
    offs = [1000 + 70_001 * k for k in range(rows)]
    dest = np.zeros((rows, 300), np.uint8)
    with tdio.DirectFile(path) as df:
        got = df.read_strided(offs, 100, out=dest[:, 50:150])
        assert got.base is dest or np.shares_memory(got, dest)
        with pytest.raises(ValueError):
            df.read_strided(offs, 100, out=dest[:, 50:149])
    want = np.stack([np.frombuffer(data[o:o + 100], np.uint8) for o in offs])
    np.testing.assert_array_equal(dest[:, 50:150], want)
    assert not dest[:, :50].any() and not dest[:, 150:].any()


# ------------------------------------------------------------ EnviImage
def _write_raw(tmp_path, arr, interleave, offset):
    """An ENVI image of ``arr`` (lines, samples, bands) with ``offset``
    bytes of header before the samples."""
    axes = {"bil": (0, 2, 1), "bip": (0, 1, 2), "bsq": (2, 0, 1)}[interleave]
    path = str(tmp_path / f"img_{interleave}_{offset}")
    with open(path, "wb") as f:
        f.write(b"\x7f" * offset + np.ascontiguousarray(arr.transpose(axes)).tobytes())
    L, S, B = arr.shape
    tenvi.write_header(path + ".hdr", {
        "lines": L, "samples": S, "bands": B, "interleave": interleave,
        "data type": tenvi.dtype_to_envi(arr.dtype), "byte order": 0,
        "header offset": offset})
    return path


# header offsets: 0 is aligned; 100 is a multiple of 4 bytes but not of 8;
# 6 is a multiple of 2 bytes but not of 4. Where the offset is not a
# multiple of the sample size the reads take the memmap path.
OFFSETS = [0, 100, 6]
# float32: the radiance; float64: the CMF's BIP product, which the FCN and
# the plume list read; int16: the masks' product
DTYPES = ["float32", "float64", "int16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("interleave", ["bil", "bip", "bsq"])
def test_envi_reads_match_jax(tmp_path, rng, interleave, offset, dtype):
    arr = rng.normal(size=(37, 29, 23))
    if dtype == "int16":
        arr = arr * 3000
    arr = arr.astype(dtype)
    path = _write_raw(tmp_path, arr, interleave, offset)
    timg, jimg = tenvi.open_envi(path), jenvi.open_envi(path)
    band_lists = [[4], [0, 1, 2, 9, 10, 22], list(range(3, 20)), [5, 7, 9, 11]]

    def same(got, ref, want):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).tobytes() == np.ascontiguousarray(ref).tobytes()

    same(timg.read_lines(4, 31), jimg.read_lines(4, 31), arr[4:31])
    same(timg.read_lines(0, 37), jimg.read_lines(0, 37), arr)
    same(timg.read_band_window(5, 13), jimg.read_band_window(5, 13),
         arr[:, :, 5:13].transpose(0, 2, 1))
    for bands in band_lists:
        same(timg.read_lines_bands(3, 30, bands), jimg.read_lines_bands(3, 30, bands),
             arr[3:30][:, :, bands])
    same(timg.load(), jimg.load(), arr)
    for b in (0, 11, -1):
        same(timg.read_band(b), jimg.read_band(b), arr[..., b])


def test_read_lines_bands_any_order(tmp_path, rng):
    """Unsorted and repeated band lists (the memmap fancy index's contract)
    read each band once and return the list's order."""
    arr = rng.normal(size=(20, 11, 17)).astype(np.float32)
    path = _write_raw(tmp_path, arr, "bil", 0)
    img = tenvi.open_envi(path)
    for bands in ([9, 2, 3], [60 % 17, 42 % 17, 24 % 17], [4, 4, 1]):
        np.testing.assert_array_equal(img.read_lines_bands(2, 18, bands),
                                      arr[2:18][:, :, bands])
