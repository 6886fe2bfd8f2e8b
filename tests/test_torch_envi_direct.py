"""The port's ENVI reads through its own O_DIRECT reader
(srcfinder_torch.core.directio), held byte for byte against the raw file,
the JAX package's DirectFile and the JAX package's EnviImage readers, over
bil, bip and bsq, with O_DIRECT and with the buffered fallback."""

import os

import numpy as np
import pytest

from srcfinder_tpu.core import directio as jdio
from srcfinder_tpu.core import envi as jenvi
from srcfinder_torch.core import directio as tdio
from srcfinder_torch.core import envi as tenvi

# O_DIRECT on (where the filesystem allows it), and off by the switch
MODES = ["direct", "buffered"]


@pytest.fixture(params=MODES)
def io_mode(request, monkeypatch):
    monkeypatch.setenv("SRCFINDER_DIRECT_IO", "1" if request.param == "direct" else "0")
    return request.param


@pytest.fixture
def blob(tmp_path, rng):
    data = rng.integers(0, 256, size=3_000_000, dtype=np.uint8).tobytes()
    p = tmp_path / "blob.bin"
    p.write_bytes(data)
    return str(p), data


def test_direct_io_switch(io_mode):
    assert tdio.direct_io_enabled() == (io_mode == "direct" and hasattr(os, "O_DIRECT"))
    assert tdio.direct_io_enabled() == jdio.direct_io_enabled()


def test_buffered_by_default(blob, monkeypatch):
    """Without the switch the port reads buffered (the JAX package's
    default is O_DIRECT)."""
    monkeypatch.delenv("SRCFINDER_DIRECT_IO", raising=False)
    assert not tdio.direct_io_enabled()
    with tdio.DirectFile(blob[0]) as df:
        assert df.mode == "buffered"


def test_read_range_matches_raw_bytes_and_jax(blob, io_mode):
    path, data = blob
    cases = [(0, 4096), (1, 4095), (4095, 2), (4096, 4096), (123_457, 777_001),
             (len(data) - 5, 5), (len(data) - 4097, 4097), (0, len(data))]
    with tdio.DirectFile(path) as df, jdio.DirectFile(path) as jf:
        assert df.direct == jf.direct
        assert df.mode == ("O_DIRECT" if df.direct else "buffered")
        for off, n in cases:
            got = df.read_range(off, n)
            assert got.tobytes() == data[off:off + n], (off, n, df.mode)
            assert got.tobytes() == jf.read_range(off, n).tobytes()
        with pytest.raises(ValueError):
            df.read_range(len(data) - 1, 2)
        assert df.read_range(5, 0).size == 0


def test_read_strided_matches_raw_bytes_and_jax(tmp_path, rng, io_mode):
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
def test_read_strided_into_rows_apart(blob, io_mode, rows):
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


def test_open_refusing_o_direct_falls_back(blob, monkeypatch):
    """A filesystem that refuses O_DIRECT at open: the file opens
    buffered and reads the same bytes."""
    path, data = blob
    monkeypatch.setenv("SRCFINDER_DIRECT_IO", "1")
    real_open = os.open

    def refuse(p, flags, *a):
        if flags & getattr(os, "O_DIRECT", 0):
            raise OSError(22, "O_DIRECT refused")
        return real_open(p, flags, *a)
    monkeypatch.setattr(tdio.os, "open", refuse)
    with tdio.DirectFile(path) as df:
        assert not df.direct and df.mode == "buffered"
        assert df.read_range(777, 9999).tobytes() == data[777:777 + 9999]
        np.testing.assert_array_equal(df.read_strided([10, 5000], 100).reshape(-1),
                                      np.frombuffer(data[10:110] + data[5000:5100], np.uint8))


@pytest.mark.parametrize("call", ["read_range", "read_strided"])
def test_failed_o_direct_read_demotes_to_buffered(blob, monkeypatch, call):
    """An O_DIRECT read that fails at run time reopens the file buffered
    (the old descriptor parked until close) and retries the read."""
    path, data = blob
    monkeypatch.setenv("SRCFINDER_DIRECT_IO", "0")
    df = tdio.DirectFile(path)
    df.direct = True                       # as if O_DIRECT had opened
    real = tdio.DirectFile._pread_full
    failed = []

    def flaky(self, mv, offset):
        if self.direct:
            failed.append(offset)
            raise OSError(22, "unaligned O_DIRECT read")
        return real(self, mv, offset)
    monkeypatch.setattr(tdio.DirectFile, "_pread_full", flaky)
    if call == "read_range":
        got = df.read_range(100, 5000).tobytes()
        want = data[100:5100]
    else:
        got = df.read_strided([100, 9000], 300).tobytes()
        want = data[100:400] + data[9000:9300]
    assert got == want and failed and df.mode == "buffered"
    assert len(df._retired) == 1
    df.close()
    assert df.fd == -1 and not df._retired


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


# 0: aligned; 100: a multiple of the sample size, not of the 4096-byte
# block (O_DIRECT reads the aligned superset); 6: not a multiple of 4
# bytes (the memmap path)
OFFSETS = [0, 100, 6]


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("interleave", ["bil", "bip", "bsq"])
def test_envi_reads_match_jax(tmp_path, rng, interleave, offset, io_mode):
    arr = rng.normal(size=(37, 29, 23)).astype(np.float32)
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


def test_read_lines_bands_any_order(tmp_path, rng, io_mode):
    """Unsorted and repeated band lists (the memmap fancy index's contract)
    read each band once and return the list's order."""
    arr = rng.normal(size=(20, 11, 17)).astype(np.float32)
    path = _write_raw(tmp_path, arr, "bil", 0)
    img = tenvi.open_envi(path)
    for bands in ([9, 2, 3], [60 % 17, 42 % 17, 24 % 17], [4, 4, 1]):
        np.testing.assert_array_equal(img.read_lines_bands(2, 18, bands),
                                      arr[2:18][:, :, bands])


def test_envi_image_reads_with_o_direct(tmp_path, rng, monkeypatch):
    """With the switch on, an image is read through O_DIRECT wherever its
    filesystem allows it: the image's reader ends in the mode a fresh
    DirectFile of the same file opens in."""
    monkeypatch.setenv("SRCFINDER_DIRECT_IO", "1")
    arr = rng.normal(size=(16, 8, 5)).astype(np.float32)
    path = _write_raw(tmp_path, arr, "bil", 0)
    img = tenvi.open_envi(path)
    np.testing.assert_array_equal(img.read_band_window(1, 4), arr[:, :, 1:4].transpose(0, 2, 1))
    with tdio.DirectFile(path) as probe:
        assert img._direct().mode == probe.mode
