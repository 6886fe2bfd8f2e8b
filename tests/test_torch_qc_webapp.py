"""The port's QC tagger web app (srcfinder_torch.qc.webapp) held against
the JAX package's: both apps started on port 0 over two copies of one
datapath, each with its own output directory, and one request sequence
replayed to each. Status codes, content types and JSON bodies equal, the
page byte for byte, PNGs decoded with Pillow and equal pixel for pixel
(the port encodes with the standard library, so the bytes differ), and
the files written equal byte for byte. The cases are those of
tests/test_qc_webapp.py."""

import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from srcfinder_tpu.qc import session as jsession
from srcfinder_tpu.qc import webapp as jweb
from srcfinder_torch.core import envi as tenvi
from srcfinder_torch.core.labels import POINTSRC, DIFFSRC
from srcfinder_torch.qc import session as tsession
from srcfinder_torch.qc import webapp as tweb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("ang20200924t211102_cmf_v2y1_img", "ang20200925t120000_cmf_v2y1_img")
META = {"data ignore value": -9999,
        "map info": ["UTM", "1", "1", "391000", "3786000", "3.0", "3.0", "11", "North",
                     "WGS-84", "units=Meters", "rotation=0"]}


def _datapath(d, rng):
    """Two 30 x 20 CMF products (a plume, a nodata pixel); the first with
    a saliency and a label-image sibling."""
    os.makedirs(d)
    for i, name in enumerate(NAMES):
        dat = np.zeros((30, 20, 4), np.float32)
        dat[..., :3] = rng.uniform(1, 10, size=(30, 20, 3))
        dat[..., 3] = rng.normal(100, 30, size=(30, 20))
        dat[10:14, 5:8, 3] = 900.0 + 300 * i
        dat[0, 0] = -9999
        tenvi.save_envi(os.path.join(d, name + ".hdr"), dat, metadata=META,
                        interleave="bip")
    sal = np.zeros((30, 20), np.float32)
    sal[10:14, 5:8] = 0.9
    sal[20:22, 2:4] = 0.6
    tenvi.save_envi(os.path.join(d, NAMES[0] + "_saliency.hdr"), sal[..., None],
                    interleave="bip")
    lab = np.zeros((30, 20), np.int16)
    lab[2:5, 2:5] = POINTSRC
    lab[25:28, 10:15] = DIFFSRC
    tenvi.save_envi(os.path.join(d, NAMES[0] + "_labclass.hdr"), lab[..., None],
                    interleave="bip")


def _plumes():
    return pd.DataFrame({"Line name": ["ang20200924t211102"] * 2,
                         "Candidate ID": ["ang20200924t211102-C", "ang20200924t211102-D"],
                         "Plume Latitude (deg)": [34.2125, 34.2121],
                         "Plume Longitude (deg)": [-118.1887, -118.1885],
                         "Label": ["Plume", "Artifact"]})


@pytest.fixture
def apps(tmp_path, rng):
    """(port app, JAX app, tmp_path) over copies of one datapath."""
    _datapath(str(tmp_path / "t" / "data"), rng)
    shutil.copytree(tmp_path / "t" / "data", tmp_path / "j" / "data")
    out = []
    for tag, sess_mod, web_mod in (("t", tsession, tweb), ("j", jsession, jweb)):
        sess = sess_mod.QcSession("alice", str(tmp_path / tag / "data"),
                                  str(tmp_path / tag / "out"))
        app = web_mod.QcWebApp(sess, plumedf=_plumes())
        app.start()
        out.append(app)
    yield out[0], out[1], tmp_path
    for app in out:
        app.stop()


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _call(app, path, body=None):
    """(status, content type, body) of one request."""
    req = urllib.request.Request(f"http://127.0.0.1:{app.port}{path}",
                                 data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _same(t, j):
    """The port's and the JAX app's responses agree: PNGs by their
    decoded pixels, JSON by value, anything else byte for byte."""
    assert t[:2] == j[:2]
    if t[1] == "image/png":
        a, b = Image.open(io.BytesIO(t[2])), Image.open(io.BytesIO(j[2]))
        assert a.mode == b.mode == "RGB" and a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return np.asarray(a)
    if t[1] == "application/json":
        assert json.loads(t[2]) == json.loads(j[2])
        return json.loads(t[2])
    assert t[2] == j[2]
    return t[2]


def _both(apps, path, body=None):
    return _same(_call(apps[0], path, body), _call(apps[1], path, body))


def test_webapp_session_matches_jax(apps):
    """A whole labelling session replayed to both apps: the page, info,
    basemaps, bounds, flags, every layer and viewport of /img, the view
    ops, adds by pixel and by click, relabel, delete, flags, submit,
    reset, the log, the error paths; then the output files."""
    tapp, japp, tmp_path = apps
    fl, fl2 = NAMES
    page = _both(apps[:2], "/")
    assert b"srcfinder QC tagger" in page
    info = _both(apps[:2], "/api/info")
    assert info["todo"] == list(NAMES) and info["done"] == []
    _both(apps[:2], "/api/wmts")
    bounds = _both(apps[:2], f"/api/bounds?fl={fl}")
    assert (bounds["width"], bounds["height"]) == (20, 30)
    assert _both(apps[:2], f"/api/flags?fl={fl}")["values"] == {}
    cands = _both(apps[:2], f"/api/candidates?fl={fl}")
    assert [c["cid"] for c in cands] == ["C", "D"]
    for layers in ("rgb", "cmf", "rgb,cmf", "rgb,salience,labels",
                   "rgb,cmf,salience,labels,candidates", "candidates"):
        fit = _both(apps[:2], f"/img?fl={fl}&layers={layers}")
        assert fit.shape == (30 * 68, 20 * 68, 3)
    _both(apps[:2], f"/img?fl={fl2}&layers=rgb,cmf,salience,labels,candidates")
    _both(apps[:2], f"/img?fl={fl}")
    _both(apps[:2], f"/img?fl={fl}&layers=rgb,cmf&minppmm=100&maxppmm=400")
    for v in ((4, 10, 12, 16), (-58, -52, 70, 76), (19, 29, 40, 40), (2.5, 8.5, 12.5, 18.5)):
        q = "&".join(f"{k}={x}" for k, x in zip(("x0", "y0", "x1", "y1"), v))
        _both(apps[:2], f"/img?fl={fl}&layers=rgb,cmf,candidates&{q}")
    views = [_both(apps[:2], "/api/view", {"op": op, "view": view, "dims": [20, 30], **p})
             for op, view, p in (("zoom", None, {"f": 0.5}), ("zoom", [0, 0, 16, 12], {"f": 2}),
                                 ("pan", [0, 0, 16, 12], {"dx": 1, "dy": 0}),
                                 ("pan", [3, 5, 10, 14], {"dx": -1, "dy": 1}),
                                 ("zoomTo", None, {"x": 6, "y": 12}),
                                 ("zoomTo", [1, 1, 5, 5], {"x": 6.5, "y": 12.5}))]
    assert views[0]["view"] == [-6, -1, 26, 31] and views[4]["view"] == [-58, -52, 70, 76]
    _both(apps[:2], "/api/view", {"op": "spin", "view": None, "dims": [20, 30]})

    _both(apps[:2], "/api/add", {"fl": fl, "row": 12, "col": 6, "label": "Plume"})
    v = [2, 8, 12, 18]
    w, h = Image.open(io.BytesIO(_call(tapp, f"/img?fl={fl}&layers=rgb,cmf&x0=2&y0=8&x1=12&y1=18")
                                 [2])).size
    _both(apps[:2], "/api/add", {"fl": fl, "view": v, "dims": [20, 30],
                                 "offx": (6 - v[0] + 0.5) * w / 10,
                                 "offy": (12 - v[1] + 0.5) * h / 10, "imgw": w, "imgh": h,
                                 "label": "False Enhancement"})
    _both(apps[:2], "/api/add", {"fl": fl, "view": None, "dims": [20, 30], "offx": 100.0,
                                 "offy": 333.3, "imgw": 1360, "imgh": 2040,
                                 "label": "Super Plume"})
    cands = _both(apps[:2], f"/api/candidates?fl={fl}")
    assert len(cands) == 5
    assert abs(cands[3]["col"] - 6) < 1 and abs(cands[3]["row"] - 12) < 1
    _both(apps[:2], "/api/relabel", {"fl": fl, "cid": "C", "label": "Cloud"})
    _both(apps[:2], "/api/relabel", {"fl": fl, "cid": "ZZ", "label": "Cloud"})
    _both(apps[:2], "/api/delete", {"fl": fl, "cid": "D"})
    _both(apps[:2], "/api/flags", {"fl": fl, "values": {
        "Coverage": "good", "Clouds": "some", "Artifacts": "", "Usernotes": "looks, fine"}})
    assert _both(apps[:2], f"/api/flags?fl={fl}")["values"]["Usernotes"] == "looks, fine"
    _both(apps[:2], f"/img?fl={fl}&layers=rgb,cmf,candidates")
    _both(apps[:2], "/api/submit", {"fl": fl})
    assert _both(apps[:2], "/api/info")["done"] == [fl]
    _both(apps[:2], "/api/add", {"fl": fl2, "row": 3, "col": 3, "label": "Ambiguous"})
    _both(apps[:2], "/api/reset", {"fl": fl2})
    assert _both(apps[:2], f"/api/candidates?fl={fl2}") == []
    # error paths: unknown flightline (400 with its message), routes (404)
    bad = _both(apps[:2], "/api/add", {"fl": "nope", "row": 0, "col": 0, "label": "Plume"})
    assert "unknown flightline" in bad["error"]
    assert _call(tapp, "/api/bogus")[0] == 404
    _both(apps[:2], "/api/bogus")
    _both(apps[:2], "/api/bogus", {"fl": fl})
    log = _both(apps[:2], "/api/log")
    assert "submitted" in log["text"] and "relabeled C -> Cloud" in log["text"]

    files = {tag: _tree(tmp_path / tag / "out") for tag in ("t", "j")}
    assert files["t"] == files["j"]
    assert sorted(files["t"]) == sorted([f"alice/submitted/{fl}_cid.csv",
                                         f"alice/submitted/{fl}_lid.csv",
                                         f"alice/{fl}_cid.csv", f"alice/{fl}_lid.csv"])


@pytest.mark.parametrize("op", ["zoom", "pan", "zoomTo"])
def test_view_math_matches_jax(op):
    """The viewport ops on a grid of views and arguments with .5 ties
    (JS Math.round rounds them up, also below zero)."""
    for view in (None, [0, 0, 16, 12], [-3, 1, 8, 6], [1, 1, 2, 2], [5, 7, 18, 30]):
        for dims in ([20, 30], [7, 3], [598, 2801]):
            for arg in (-2.5, -0.5, 0, 0.5, 1, 1.5, 2, 3.25, 7.5):
                p = {"zoom": {"f": arg}, "pan": {"dx": int(arg), "dy": int(-arg)},
                     "zoomTo": {"x": arg, "y": arg + 0.5}}[op]
                assert tweb.view_math(op, view, dims, **p) == jweb.view_math(op, view, dims, **p)
    assert tweb.view_math("zoomTo", None, [20, 30], x=-64.5, y=0.5) == [-128, -63, 0, 65]
    with pytest.raises(ValueError):
        tweb.view_math("spin", None, [20, 30])


def test_click_to_pixel_matches_jax():
    rng = np.random.default_rng(3)
    for view in (None, [2, 8, 12, 18], [-58, -52, 70, 76]):
        for imgw, imgh in ((1360, 2040), (2048, 2048), (33, 17)):
            for offx in (0, 0.5, 67.5, 68, imgw - 0.5, *rng.uniform(0, imgw, 5)):
                for offy in (0, 0.5, 101.5, imgh - 1, *rng.uniform(0, imgh, 3)):
                    assert tweb.click_to_pixel(view, [20, 30], offx, offy, imgw, imgh) == \
                        jweb.click_to_pixel(view, [20, 30], offx, offy, imgw, imgh)


def test_render_layers_png_matches_jax(tmp_path, rng):
    """The render functions directly: every layer subset, viewports, the
    zoom factor (out_max), candidate markers at the edges, render_cmf_png."""
    _datapath(str(tmp_path / "d"), rng)
    cmff = str(tmp_path / "d" / NAMES[0])
    sal = tweb._find_sibling(cmff, ("saliency", "salience"))
    lab = tweb._find_sibling(cmff, ("_lab",))
    assert (sal, lab) == (jweb._find_sibling(cmff, ("saliency", "salience")),
                          jweb._find_sibling(cmff, ("_lab",)))
    assert sal.endswith("_saliency") and lab.endswith("_labclass")
    assert tweb._find_sibling(str(tmp_path / "d" / NAMES[1]), ("_lab",)) is None
    cands = [{"row": 0.4, "col": 19.6}, {"row": 12, "col": 6}, {"row": 40, "col": 2}]
    for layers in (("rgb",), ("cmf",), ("rgb", "cmf", "salience", "labels", "candidates"),
                   ("labels",), ()):
        for viewport, out_max in ((None, 2048), (None, 0), ((4, 10, 12, 16), 2048),
                                  ((-5, -5, 3, 40), 100), ((4, 10, 12, 16), 9)):
            kw = dict(viewport=viewport, candidates=cands, salience_file=sal, label_file=lab,
                      out_max=out_max)
            a = Image.open(io.BytesIO(tweb.render_layers_png(cmff, layers, **kw)))
            b = Image.open(io.BytesIO(jweb.render_layers_png(cmff, layers, **kw)))
            assert a.size == b.size
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    a, b = (np.asarray(Image.open(io.BytesIO(m.render_cmf_png(cmff, minppmm=50))))
            for m in (tweb, jweb))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (30, 20, 3)


@pytest.mark.parametrize("shape", [(1, 1), (30, 20), (7, 513), (300, 2)])
def test_encode_png_decodes_to_its_pixels(shape):
    rgb = np.random.default_rng(1).integers(0, 256, (*shape, 3), dtype=np.uint8)
    im = Image.open(io.BytesIO(tweb.encode_png(rgb)))
    assert im.mode == "RGB" and im.size == shape[::-1]
    np.testing.assert_array_equal(np.asarray(im), rgb)
    with pytest.raises(ValueError):
        tweb.encode_png(rgb[:0])


def test_user_port_matches_jax():
    for users in (["bob", "alice"], ["u3", "u1", "u2"]):
        for u in users:
            assert tweb.user_port(users, u) == jweb.user_port(users, u)
            assert tweb.user_port(users, u, 6000) == jweb.user_port(users, u, 6000)
    assert tweb.user_port(["bob", "alice"], "alice") == 5006


def test_page_js_server_contract():
    """The page is the JAX package's, byte for byte, and every endpoint
    its script fetches is routed by the port's handler."""
    import re
    assert tweb._PAGE == jweb._PAGE
    assert tweb.ALL_LABELS == jweb.ALL_LABELS
    assert tweb.DEFAULT_FLAG_OPTS == jweb.DEFAULT_FLAG_OPTS and tweb.DEFAULT_WMTS == jweb.DEFAULT_WMTS
    js = tweb._PAGE[tweb._PAGE.index("<script>"):tweb._PAGE.rindex("</script>")]
    with open(tweb.__file__) as f:
        handler_src = f.read()
    endpoints = set(re.findall(r"j\('(/[a-z/]+)[?']", js)) | set(re.findall(r"'(/img)\?", js))
    assert len(endpoints) >= 10
    for ep in endpoints:
        assert f'"{ep}"' in handler_src, f"JS fetches unrouted {ep}"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tagger_process(tmp_path, rng):
    """python -m srcfinder_torch tagger with settings, --precache and a
    port: it precaches the EPSG:3857 GeoTIFFs, serves the session of the
    user, and imports no torch, jax or srcfinder_tpu."""
    _datapath(str(tmp_path / "data"), rng)
    cfg = tmp_path / "settings.json"
    cfg.write_text(json.dumps({"users": ["bob", "alice"], "datapath": str(tmp_path / "data"),
                               "flag_opts": {"Coverage": ["", "good", "bad"]}}))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONPROFILEIMPORTTIME="1", PYTHONUNBUFFERED="1")
    # the outputs go to files: the import trace alone outgrows a pipe's buffer
    with open(tmp_path / "out.txt", "w") as out, open(tmp_path / "err.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "srcfinder_torch", "tagger", "--config",
                                 str(cfg), "--user", "alice", "--output", str(tmp_path / "out"),
                                 "--port", str(port), "--precache", "--gtif-cache",
                                 str(tmp_path / "gtif")], env=env, stdout=out, stderr=err)
        try:
            deadline = time.time() + 90
            while True:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/info") as r:
                        info = json.loads(r.read())
                    break
                except OSError:
                    if proc.poll() is not None or time.time() > deadline:
                        raise
                    time.sleep(0.2)
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    out, err = (tmp_path / "out.txt").read_text(), (tmp_path / "err.txt").read_text()
    assert info["user"] == "alice" and info["todo"] == list(NAMES)
    assert info["flag_opts"] == {"Coverage": ["", "good", "bad"]}
    assert f"precached 2 gtifs into {tmp_path / 'gtif'}" in out
    assert sorted(os.listdir(tmp_path / "gtif")) == [n + "_epsg3857.tif" for n in NAMES]
    imported = {line.split("|")[-1].strip().split(".")[0] for line in err.splitlines()
                if line.startswith("import time:")}
    assert "numpy" in imported
    assert not imported & {"torch", "jax", "jaxlib", "flax", "srcfinder_tpu"}
