"""The port's ``core`` public API (srcfinder_torch.core: geo, morphology,
labels, tiles, xlsx, loaders) and ``qc.labels`` held against the JAX
package's on the same numpy-seeded inputs, on the CPU.

Tolerances: geodesy rtol 1e-12 with zones and letters equal; morphology,
labels, tiles and the loaders exactly (arrays equal, DataFrames equal).
The cases are those of tests/test_core_geo.py, test_core_morphology.py
and test_core_extras.py, run through both packages.
"""

import os

import numpy as np
import pandas as pd
import pytest

import srcfinder_tpu.core as jcore
import srcfinder_torch.core as tcore
from srcfinder_tpu.core import geo as jgeo
from srcfinder_tpu.core import labels as jlabels
from srcfinder_tpu.core import loaders as jloaders
from srcfinder_tpu.core import morphology as jmorph
from srcfinder_tpu.core import tiles as jtiles
from srcfinder_tpu.core import xlsx as jxlsx
from srcfinder_tpu.qc import labels as jqc
from srcfinder_torch.core import geo as tgeo
from srcfinder_torch.core import labels as tlabels
from srcfinder_torch.core import loaders as tloaders
from srcfinder_torch.core import morphology as tmorph
from srcfinder_torch.core import tiles as ttiles
from srcfinder_torch.core import xlsx as txlsx
from srcfinder_torch.core.envi import save_envi
from srcfinder_torch.qc import labels as tqc

UTM_META = {"data ignore value": -9999,
            "map info": ["UTM", "1", "1", "391000", "3786000", "3.0", "3.0",
                         "11", "North", "WGS-84", "units=Meters", "rotation=0"]}
GEO_MAP = dict(proj="Geographic Lat/Lon", xtie=1.0, ytie=1.0, ulx=-118.5,
               uly=34.5, xps=0.001, yps=0.001, rotation=0.0)


def _equal(a, b):
    """Equal results, recursively: arrays and scalars exactly."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        assert type(a) is type(b), (type(a), type(b))
        np.testing.assert_array_equal(a, b)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype


# ------------------------------------------------------------------ names
def test_public_names_have_port_counterparts():
    """Every public name of the JAX package's core has a port counterpart
    but for the ones the port leaves out on purpose (the TPU prefetch and
    the native extension)."""
    left_out = {"prefetch_to_device", "HAVE_NATIVE", "bil_window_to_lcb",
                "label8", "native", "prefetch"}
    missing = [n for n in dir(jcore) if not n.startswith("_")
               and n not in left_out and not hasattr(tcore, n)]
    assert missing == []
    import srcfinder_tpu.qc as jqcpkg
    import srcfinder_torch.qc as tqcpkg
    assert all(hasattr(tqcpkg, n) for n in jqc.__all__)
    assert {n for n in dir(tqcpkg) if not n.startswith("_")} <= (
        set(jqc.__all__) | {n for n in dir(jqcpkg) if not n.startswith("_")}
        | {"labels", "collect", "session", "webapp"})
    assert jqcpkg.PLUMELAB == tqcpkg.PLUMELAB


# ------------------------------------------------------------------ geo
POINTS = [(0.0, 3.0), (0.0, 0.0), (0.0, 4.0),     # exact anchors
          (34.2013, -118.1714), (36.9989, -109.0452), (-33.8688, 151.2093),
          (31.8, -102.3), (-0.5, 179.9),            # control points
          (60.0, 5.0), (57.0, 11.9),                # Norway: zone 32
          (78.0, 5.0), (78.0, 15.0), (78.0, 25.0), (78.0, 38.0),  # Svalbard
          (83.9, -60.0), (-79.9, 20.0), (45.0, 180.0), (45.0, -180.0)]


@pytest.mark.parametrize("lat,lon", POINTS)
def test_latlon2utm_scalar_equals_jax(lat, lon):
    got = tgeo.latlon2utm(lat, lon)
    ref = jgeo.latlon2utm(lat, lon)
    assert got[2:] == ref[2:] and type(got[2]) is int and type(got[3]) is str
    np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-12, atol=1e-9)
    assert all(type(v) is float for v in got[:2])
    lat2, lon2 = tgeo.utm2latlon(got[0], got[1], got[2],
                                 hemi="North" if lat >= 0 else "South")
    np.testing.assert_allclose([lat2, lon2], jgeo.utm2latlon(
        ref[0], ref[1], ref[2], hemi="North" if lat >= 0 else "South"),
        rtol=1e-12, atol=1e-9)


def test_latlon2utm_zone_exceptions():
    zones = [tgeo.latlon2utm(lat, lon)[2] for lat, lon in POINTS[8:14]]
    assert zones == [32, 32, 31, 33, 35, 37]


@pytest.mark.parametrize("zone", [None, 11])
def test_latlon2utm_arrays_equal_jax(zone):
    lat, lon = np.array(POINTS).T
    got = tgeo.latlon2utm(lat, lon, zone=zone)
    ref = jgeo.latlon2utm(lat, lon, zone=zone)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-12, atol=1e-9)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    assert got[3].dtype == ref[3].dtype and set(got[3]) == {"N", "S"}


@pytest.mark.parametrize("lon,lat,epsg", [(-118.17, 34.2, 32611), (151.2, -33.9, 32756),
                                          (-102.3, 31.8, 32613), (5.0, 60.0, 32631)])
def test_zone_helpers_equal_jax(lon, lat, epsg):
    assert tgeo.geo2utmzone(lon, lat) == jgeo.geo2utmzone(lon, lat)
    assert tgeo.epsg2utmzone(epsg) == jgeo.epsg2utmzone(epsg)
    assert tgeo.utmzone2epsg(*tgeo.geo2utmzone(lon, lat)) == epsg


@pytest.mark.parametrize("m", [tgeo.mapinfo(UTM_META), GEO_MAP,
                               dict(tgeo.mapinfo(UTM_META), rotation=17.0)],
                         ids=["utm", "geographic", "utm_rotated"])
def test_latlon2sl_latlon2xy_geobbox_equal_jax(m, rng):
    s = rng.uniform(0, 600, 7)
    l = rng.uniform(0, 2800, 7)
    lat, lon = jgeo.sl2latlon(s, l, mapinfo=m)
    for name in ("latlon2sl", "latlon2xy"):
        got = getattr(tgeo, name)(lat, lon, mapinfo=m)
        ref = getattr(jgeo, name)(lat, lon, mapinfo=m)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-9)
    # the round trip through the UTM series: within 1e-4 pixel (0.3 mm)
    back = tgeo.latlon2sl(lat, lon, mapinfo=m)
    np.testing.assert_allclose(back, (s, l), atol=1e-4)
    got = tgeo.geobbox(m, shape=(2801, 598))
    np.testing.assert_allclose(got, jgeo.geobbox(m, shape=(2801, 598)),
                               rtol=1e-12)
    assert got[0] < got[1] and got[2] < got[3]
    with pytest.raises(ValueError):
        tgeo.latlon2xy(lat, lon, mapinfo={})


def test_geobbox_of_an_envi_image(tmp_path):
    hdr = str(tmp_path / "img.hdr")
    save_envi(hdr, np.zeros((12, 9, 1), np.float32), metadata=UTM_META)
    from srcfinder_tpu.core.envi import open_envi as jopen
    from srcfinder_torch.core.envi import open_envi as topen
    np.testing.assert_allclose(tgeo.geobbox(topen(hdr)), jgeo.geobbox(jopen(hdr)),
                               rtol=1e-12)


# ------------------------------------------------------------------ morphology
@pytest.mark.parametrize("radius,dtype", [(0, None), (1, None), (3, None),
                                          (2, bool), (4, np.float32)])
def test_disk_equals_jax(radius, dtype):
    kw = {} if dtype is None else {"dtype": dtype}
    _equal(tmorph.disk(radius, **kw), jmorph.disk(radius, **kw))


def _blobs(rng, shape=(40, 36), p=0.12):
    return rng.uniform(size=shape) < p


@pytest.mark.parametrize("name", ["bwdilate", "bwopen"])
@pytest.mark.parametrize("selem", [None, "disk1", "square"])
def test_binary_morphology_equals_jax(rng, name, selem):
    img = _blobs(rng, p=0.3)
    se = {None: None, "disk1": jmorph.disk(1), "square": np.ones((3, 3), bool)}[selem]
    _equal(getattr(tmorph, name)(img, se), getattr(jmorph, name)(img, se))


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
def test_region_maxima_equals_jax(rng, dtype):
    img = (rng.normal(size=(40, 36)) * 50).astype(dtype)
    mask = _blobs(rng, p=0.35)
    _equal(tmorph.region_maxima(img, mask, return_index=True),
           jmorph.region_maxima(img, mask, return_index=True))
    _equal(tmorph.region_maxima(img, mask), jmorph.region_maxima(img, mask))
    empty = np.zeros_like(mask)
    _equal(tmorph.region_maxima(img, empty, return_index=True),
           jmorph.region_maxima(img, empty, return_index=True))


@pytest.mark.parametrize("rad", [1, 2, 4])
@pytest.mark.parametrize("ties", [False, True])
def test_local_maxima_equals_jax(rng, rad, ties):
    """The greedy suppression order: with ties (integer levels), which
    peak survives is decided by argsort(...)[::-1] in both packages."""
    im = rng.normal(size=(48, 40))
    if ties:
        im = np.round(im * 2)
    got = tmorph.local_maxima(im, rad)
    _equal(got, jmorph.local_maxima(im, rad))
    assert len(got) > 0
    flat = np.zeros((8, 8))
    _equal(tmorph.local_maxima(flat, rad), jmorph.local_maxima(flat, rad))


def test_reconstruction_erosion_equals_jax(rng):
    mask = rng.uniform(size=(30, 30))
    seed = np.full_like(mask, mask.max())
    seed[0, :] = mask[0, :]
    _equal(tmorph.reconstruction_erosion(seed, mask),
           jmorph.reconstruction_erosion(seed, mask))


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("anti_alias", [False, True])
@pytest.mark.parametrize("shape", [(4, 4), (13, 7)])
def test_imresize_equals_jax(rng, order, anti_alias, shape):
    img = rng.normal(size=(9, 11)).astype(np.float32)
    _equal(tmorph.imresize(img, shape, order=order, anti_alias=anti_alias),
           jmorph.imresize(img, shape, order=order, anti_alias=anti_alias))


# ------------------------------------------------------------------ labels, tiles
def _labimg(rng):
    return rng.choice(np.array(tlabels.CMFLABELS, np.uint8), size=(12, 10))


@pytest.mark.parametrize("rgba", [False, True])
def test_label_codecs_equal_jax(rng, rgba):
    lab = _labimg(rng)
    rgb = tlabels.labimg2rgb(lab, rgba=rgba)
    _equal(rgb, jlabels.labimg2rgb(lab, rgba=rgba))
    rgb3 = rgb[..., :3].copy()
    rgb3[0, 0] = 255                                 # a LOCSRC pixel
    _equal(tlabels.rgb2labimg(rgb3), jlabels.rgb2labimg(rgb3))
    img = rng.uniform(size=(8, 6))
    packed = tlabels.float2rgba(img, alpha=7)
    _equal(packed, jlabels.float2rgba(img, alpha=7))
    _equal(tlabels.rgba2float(packed), jlabels.rgba2float(packed))


def test_label_constants_equal_jax():
    for name in jlabels.__all__:
        assert getattr(tlabels, name) is not None
        if not callable(getattr(jlabels, name)):
            assert getattr(tlabels, name) == getattr(jlabels, name), name


@pytest.mark.parametrize("kind", ["png", "class"])
def test_loadlabimg_equals_jax(tmp_path, rng, kind):
    lab = _labimg(rng)
    if kind == "png":
        Image = pytest.importorskip("PIL.Image")
        path = str(tmp_path / "lab_mask.png")
        Image.fromarray(tlabels.labimg2rgb(lab)).save(path)
    else:
        path = str(tmp_path / "ang_class")
        save_envi(path + ".hdr", lab[..., None], metadata={})
    _equal(tlabels.loadlabimg(path), jlabels.loadlabimg(path))
    np.testing.assert_array_equal(tlabels.loadlabimg(path), lab)
    with pytest.raises(ValueError):
        tlabels.loadlabimg(str(tmp_path / "x.jpg"))


@pytest.mark.parametrize("ul", [(-1, -1), (3, 3), (0, 5), (-2, 5)])
@pytest.mark.parametrize("bands", [1, 3])
def test_extract_tile_equals_jax(ul, bands):
    img = np.arange(8 * 7 * bands, dtype=np.float32).reshape(8, 7, bands).squeeze()
    for tdim, kw in ((3, {}), ((5, 4), {"fill_value": -1}),
                     (4, {"transpose": (2, 0, 1)})):
        _equal(ttiles.extract_tile(img, ul, tdim, **kw),
               jtiles.extract_tile(img, ul, tdim, **kw))


@pytest.mark.parametrize("i,j,off", [(5, 5, 2), (0, 0, 3), (9, 1, (1, 4))])
def test_boxes_equal_jax(i, j, off):
    for as_slice in (False, True):
        assert (ttiles.pixbox(i, j, off, (10, 10), as_slice)
                == jtiles.pixbox(i, j, off, (10, 10), as_slice))
    assert ttiles.inbbox((i, j), (6, 6)) == jtiles.inbbox((i, j), (6, 6))
    bb = dict(xmin=0, xmax=9, ymin=0, ymax=9, width=10, height=10)
    bb2 = dict(xmin=i, xmax=i + 9, ymin=j, ymax=j + 9, width=10, height=10)
    for pc in (True, False):
        assert (ttiles.bbox_overlap(bb, bb2, pixel_coords=pc)
                == jtiles.bbox_overlap(bb, bb2, pixel_coords=pc))
    assert ttiles.iou(bb, bb2) == jtiles.iou(bb, bb2)


# ------------------------------------------------------------------ qc.labels
def test_qc_labels_equal_jax(tmp_path, rng):
    labs = ["Plume", "Super Plume", "Cloud", "Artifact", "Ambiguous"]
    _equal(tqc.classlabs(labs), jqc.classlabs(labs))
    _equal(tqc.classlabs(labs, dtype=str), jqc.classlabs(labs, dtype=str))
    cid = pd.DataFrame({tqc.CIDCOL: ["A", "B", "3"],
                        tqc.LABCOL: ["Plume", "Plume", "Cloud"]})
    for tgt in ("Plume", "Cloud"):
        for byclass in (False, True):
            assert (tqc.next_cid(tgt, cid, byclass)
                    == jqc.next_cid(tgt, cid, byclass))
    lng, lat = rng.uniform(-120, -100, 5), rng.uniform(30, 40, 5)
    x, y = tqc.lnglat_to_meters(lng, lat)
    _equal((x, y), jqc.lnglat_to_meters(lng, lat))
    _equal(tqc.meters_to_lnglat(x, y), jqc.meters_to_lnglat(x, y))
    assert tqc.cmff_to_lid("/d/ang20200924t211102_cmf_v2y1") == "ang20200924t211102"
    plumes = pd.DataFrame({tqc.LIDCOL: [f"ang{i}" for i in range(7)]})
    got = tqc.lid2uidassign(plumes, ["u1", "u2", "u3"], str(tmp_path / "t.csv"), seed=3)
    _equal(got, jqc.lid2uidassign(plumes, ["u1", "u2", "u3"],
                                  str(tmp_path / "j.csv"), seed=3))
    opts = ["cloud", "glint", "striping"]
    tqc.save_flag_csv(str(tmp_path / "tf.csv"), ["glint"], opts, 'a "note"')
    jqc.save_flag_csv(str(tmp_path / "jf.csv"), ["glint"], opts, 'a "note"')
    assert open(tmp_path / "tf.csv").read() == open(tmp_path / "jf.csv").read()
    _equal(tqc.load_flag_csv(str(tmp_path / "tf.csv"), opts),
           jqc.load_flag_csv(str(tmp_path / "jf.csv"), opts))
    tqc.save_classlabs(str(tmp_path / "t.json"))
    jqc.save_classlabs(str(tmp_path / "j.json"))
    assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json").read()


# ------------------------------------------------------------------ xlsx, loaders
PLUME_COLS = ["Line name", "Candidate ID", "True_pos/false_pos",
              "Plume Latitude (deg)", "Plume Longitude (deg)"]


def _plume_frame(rng, n=9):
    lids = rng.choice(["ang20200924t211102", "ang20200925t180512"], n)
    return pd.DataFrame({
        "Line name": lids,
        "Candidate ID": [f"{l}-{k}" for l, k in zip(lids, rng.integers(1, 4, n))],
        "True_pos/false_pos": rng.choice(["TP", "FP", "FN"], n),
        "Plume Latitude (deg)": np.round(rng.uniform(34, 37, n), 4),
        "Plume Longitude (deg)": np.round(rng.uniform(-120, -117, n), 4)})


def test_read_xlsx_equals_jax(tmp_path, rng):
    df = _plume_frame(rng)
    p = str(tmp_path / "p.xlsx")
    txlsx.write_xlsx(p, [list(df.columns)] + df.values.tolist(), sheet_name="Plumes")
    for sheet in (None, "Plumes"):
        _equal(txlsx.read_xlsx(p, sheet), jxlsx.read_xlsx(p, sheet))
    pd.testing.assert_frame_equal(txlsx.read_xlsx(p), df)
    txlsx.write_xlsx(str(tmp_path / "e.xlsx"), [])
    _equal(txlsx.read_xlsx(str(tmp_path / "e.xlsx")),
           jxlsx.read_xlsx(str(tmp_path / "e.xlsx")))


@pytest.mark.parametrize("ext", [".csv", ".xlsx"])
@pytest.mark.parametrize("kw", [{}, {"dedupcols": ["Line name", "Candidate ID"]},
                                {"truncated_cids": False}],
                         ids=["plain", "dedup", "full_cids"])
def test_load_plumedf_equals_jax(tmp_path, rng, ext, kw):
    df = _plume_frame(rng)
    df = df.rename(columns={"Line name": "# Line name "})      # '#' stripped
    p = str(tmp_path / ("plumes" + ext))
    if ext == ".csv":
        df.to_csv(p, index=False)
    else:
        txlsx.write_xlsx(p, [list(df.columns)] + df.values.tolist())
    got = tloaders.load_plumedf(p, **kw)
    _equal(got, jloaders.load_plumedf(p, **kw))
    assert set(got["Class label"]) <= {"Plume", "False Enhancement"}


def test_load_plumedf_manual_sheet_equals_jax(tmp_path, rng):
    """The manual-id sheet of an xlsx workbook: its rows are marked FN."""
    import zipfile
    p = str(tmp_path / "two.xlsx")
    a, b = _plume_frame(rng, 5), _plume_frame(rng, 3)
    txlsx.write_xlsx(str(tmp_path / "a.xlsx"), [PLUME_COLS] + a.values.tolist(), "CNN")
    txlsx.write_xlsx(str(tmp_path / "b.xlsx"), [PLUME_COLS] + b.values.tolist(), "Manual")
    # one workbook with both sheets: the second's sheet file and workbook entry
    with zipfile.ZipFile(str(tmp_path / "a.xlsx")) as za, \
            zipfile.ZipFile(str(tmp_path / "b.xlsx")) as zb, \
            zipfile.ZipFile(p, "w") as z:
        for item in za.namelist():
            data = za.read(item)
            if item == "xl/workbook.xml":
                data = data.replace(b'</sheets>', b'<sheet name="Manual" sheetId="2" '
                                    b'r:id="rId9"/></sheets>')
            elif item == "xl/_rels/workbook.xml.rels":
                data = data.replace(b'</Relationships>', b'<Relationship Id="rId9" '
                                    b'Type="http://schemas.openxmlformats.org/officeDocument/'
                                    b'2006/relationships/worksheet" Target="worksheets/'
                                    b'sheet2.xml"/></Relationships>')
            z.writestr(item, data)
        z.writestr("xl/worksheets/sheet2.xml", zb.read("xl/worksheets/sheet1.xml"))
    assert len(txlsx.read_xlsx(p, "Manual")) == 3
    got = tloaders.load_plumedf(p, cnn_sheet="CNN", manualid_sheet="Manual")
    _equal(got, jloaders.load_plumedf(p, cnn_sheet="CNN", manualid_sheet="Manual"))
    assert (got["True_pos/false_pos"].values[5:] == "FN").all()


def _write_product(tmp_path, rng, name, bands, interleave="bip"):
    dat = rng.uniform(1, 10, size=(10, 8, bands)).astype(np.float32)
    dat[0, 0] = -9999
    dat[3, 2, 0] = -9999
    path = str(tmp_path / name)
    save_envi(path + ".hdr", dat, metadata=dict(UTM_META), interleave=interleave)
    return path


@pytest.mark.parametrize("kw", [{}, {"rgb_bands": [0, 1, 2]}, {"load_bands": [3]},
                                {"memmap": True}, {"masked_value": -1.0}],
                         ids=["all", "rgb", "load_bands", "memmap", "masked_value"])
def test_loadmaskedimage_equals_jax(tmp_path, rng, kw):
    path = _write_product(tmp_path, rng, "ang20200924t211102_cmf_v2y1_img", 4)
    got = tloaders.loadmaskedimage(path, **kw)
    ref = jloaders.loadmaskedimage(path, **kw)
    assert list(got) == list(ref)
    for k in got:
        if k == "mapinfo":
            assert got[k] == ref[k]
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


@pytest.mark.parametrize("name", ["loadfiltdet", "loaddetids", "loadsaliencemap"])
def test_single_band_loaders_equal_jax(tmp_path, rng, name):
    path = _write_product(tmp_path, rng, "ang20200924t211102_band", 1, "bil")
    got = getattr(tloaders, name)(path)
    ref = getattr(jloaders, name)(path)
    assert list(got) == list(ref)
    for k in got:
        if k == "mapinfo":
            assert got[k] == ref[k]
        else:
            _equal(got[k], ref[k])


@pytest.mark.parametrize("maskwin", [3, 5])
def test_parse_masks_equals_jax(tmp_path, maskwin):
    mask = np.zeros((20, 20, 4), np.int16)
    mask[10, 10, 2] = 1            # flare
    mask[3, 15, 0] = 1             # cloud
    mask[18, 18] = -9999
    meta = dict(UTM_META, **{"band names": ["Cloud mask", "Specular mask",
                                            "Flare mask", "Dark mask"]})
    save_envi(str(tmp_path / "ang20200924t211102_msk_v2y1_img.hdr"), mask,
              metadata=meta, interleave="bil")
    m = tgeo.mapinfo(meta)
    sl = [(10, 10), (2, 2), (15, 3), (18, 18), (0, 19)]
    lat, lon = tgeo.sl2latlon(np.array([s for s, _ in sl]),
                              np.array([l for _, l in sl]), mapinfo=m)
    lid = np.array(["ang20200924t211102"] * 4 + ["ang20990101t000000"])
    cid = np.array(list("ABCDE"))
    got = tloaders.parse_masks(lid, cid, lat, lon, str(tmp_path), "img", maskwin)
    _equal(got, jloaders.parse_masks(lid, cid, lat, lon, str(tmp_path), "img", maskwin))
    assert got[1] == ["Cloud", "Specular", "Flare", "Dark"]
    assert len(got[0]) == 4 and got[0]["Flare"].tolist()[0] == 1


def test_mask2rgb_absnorm_equal_jax(rng):
    mask = rng.choice(np.array([0, 0, 0, 1], np.int16), size=(9, 7, 4))
    mask[0, 0] = -9999
    for alpha in (1.0, 0.5):
        _equal(tloaders.mask2rgb(mask, alpha), jloaders.mask2rgb(mask, alpha))
    img = rng.normal(size=(16, 16)).astype(np.float32)
    nodata = rng.uniform(size=(16, 16)) < 0.1
    _equal(tloaders.absnorm(img, nodata), jloaders.absnorm(img, nodata))


@pytest.mark.parametrize("normalize", [True, False])
def test_smoothbil_equals_jax(rng, normalize):
    pytest.importorskip("cv2")
    img = rng.normal(size=(16, 16)).astype(np.float32)
    mask = np.zeros((16, 16), bool)
    _equal(tloaders.smoothbil(img, mask, 5, 25, 25, normalize),
           jloaders.smoothbil(img, mask, 5, 25, 25, normalize))


def test_retrieve_rgb_equals_jax(tmp_path):
    """The injectable fetcher (no network): the same URLs, return codes
    and files in both packages."""
    calls = {"port": [], "jax": []}

    def fetcher(tag):
        def fetch(url, dest):
            calls[tag].append(url)
            with open(dest, "wb") as f:
                f.write(b"\x89PNG fake")
        return fetch

    def bad(url, dest):
        raise OSError("no route")

    for tag, mod in (("port", tloaders), ("jax", jloaders)):
        d = tmp_path / tag
        for name in ("ang20200924t211102_RGB.jpeg", "ang20170924t211102_RGB.jpeg",
                     "ang20200924t211102_RGB.jpeg"):
            assert mod.retrieve_rgb(str(d / name), fetcher=fetcher(tag)) == 0
        assert mod.retrieve_rgb(str(d / "ang20190101t000000.j"), fetcher=bad) == 1
        with pytest.raises(ValueError):
            mod.retrieve_rgb(str(d / "foo.jpeg"))
        assert sorted(os.listdir(d)) == ["ang20170924t211102_RGB.jpeg",
                                         "ang20200924t211102_RGB.jpeg"]
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2
