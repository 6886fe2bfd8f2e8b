"""Interactive plume-labeling web app.

Port of the JAX package's ``qc/webapp.py``: the same routes, JSON, page
and files. PNGs are encoded with the standard library (zlib, RGB, 8 bits,
filter 0) and zoomed by pixel repetition, not with Pillow: the bytes
differ from Pillow's, the decoded pixels do not.

Reference (cmftagger/cmftagger.py): a multi-user Panel/HoloViews/Bokeh
server with per-user ports, flightline assignment, layered CMF/RGB views,
double-tap candidate adding, editable label tables, autosave and a
submit/reset lifecycle. Panel/Bokeh are not available in this
environment, so this app serves the same workflow over the stdlib HTTP
server + a small vanilla-JS page:

- flightline list with todo/done state (reference: cmftagger.py:292-346)
- layered rendering: RGB base, CMF overlay, salience overlay, label
  overlay, candidate markers (reference layers + collect_data,
  cmftagger.py:757-832,834-900)
- zoom/pan viewport with zoom-to-candidate (reference: :950-992); the
  /img endpoint crops+scales server-side so clicks stay exact
- click-to-add candidates with label selection (reference: :711-755)
- per-candidate label editing/deleting (reference: :396-430)
- editable per-flightline QC flag table -> ``*_lid.csv``
  (reference: :471-532)
- WMTS basemap hook: /api/wmts serves the configured tile templates and
  /api/bounds the flightline's lat/lon bbox (reference: :60-74 +
  config/wmts.json; actual tile fetching needs network egress)
- autosave on every edit + submit/reset into output/<user>/submitted/
  (reference: :534-664)
- the in-app ring-buffer log (reference: :250-290)

State is :class:`.session.QcSession`; labels merge downstream through
:mod:`.collect`.
"""

from __future__ import annotations

import binascii
import glob
import json
import os
import struct
import threading
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .labels import CIDCOL, LATCOL, LONCOL, LABCOL, POSLABS, NEGLABS, AMBLABS
from .session import QcSession

__all__ = ["QcWebApp", "user_port", "render_layers_png", "render_cmf_png",
           "encode_png", "DEFAULT_FLAG_OPTS", "DEFAULT_WMTS"]

ALL_LABELS = POSLABS + NEGLABS + AMBLABS

#: editable flightline-flag vocabulary (reference: the QC template
#: columns behind cmftagger.py:471-532; override via settings
#: ["flag_opts"] or the constructor)
DEFAULT_FLAG_OPTS = {
    "Coverage": ["", "good", "partial", "bad"],
    "Clouds": ["", "none", "some", "many"],
    "Artifacts": ["", "none", "some", "severe"],
    "Usernotes": None,               # free text
}

#: WMTS basemap templates (reference: cmftagger/config/wmts.json,
#: cmftagger.py:60-74); zero-egress here, so these are served as a hook
#: for front ends that can reach the internet
DEFAULT_WMTS = {
    "ESRI World Imagery": ("https://server.arcgisonline.com/ArcGIS/rest/"
                           "services/World_Imagery/MapServer/tile/{z}/{y}/{x}"),
    "OSM": "https://tile.openstreetmap.org/{z}/{x}/{y}.png",
}


def user_port(users, user, base_port: int = 5006) -> int:
    """Per-user port assignment (reference: cmftagger.py:32-42)."""
    return base_port + sorted(users).index(user)


def _find_sibling(cmff: str, tags) -> str | None:
    """Locate a sibling product of the flightline (salience map, label
    image) by filename tag (reference discovers them by regex over the
    datapath, cmftagger.py:793-827)."""
    d = os.path.dirname(cmff) or "."
    base = os.path.basename(cmff)
    stem = base[:-4] if base.endswith(".img") else base
    for tag in tags:
        for cand in sorted(glob.glob(os.path.join(d, f"*{tag}*"))):
            cb = os.path.basename(cand)
            if cb.endswith(".hdr") or cb == base:
                continue
            if cb.startswith(stem.split("_cmf")[0].split("_ch4mf")[0]):
                return cand
    return None


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: 8-bit RGB, no interlace, filter 0
    on every row, one zlib stream (level 6, Pillow's default)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    if rgb.ndim != 3 or rgb.shape[2] != 3 or not h or not w:
        raise ValueError(f"expected a non-empty (H, W, 3) image, got {rgb.shape}")
    raw = np.zeros((h, 1 + 3 * w), np.uint8)    # a filter-type byte per row
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def render_layers_png(cmff, layers=("rgb", "cmf"), viewport=None,
                      candidates=None, salience_file=None,
                      label_file=None, minppmm: float = 250,
                      maxppmm: float = 1500, rdnmax: float = 15.0,
                      salthr: float = 0.5, out_max: int = 2048) -> bytes:
    """Compose the requested layers into a PNG.

    layers: subset of {rgb, cmf, salience, labels, candidates}.
    viewport: (x0, y0, x1, y1) image-coordinate crop (pan/zoom);
    the crop is integer-scaled up (nearest) when small so zooming is
    actually magnified, never above ``out_max`` per side.
    """
    from ..core.loaders import loadcmf
    cmf, rgba, nodata, _ = loadcmf(cmff, rdnmax=rdnmax)
    h, w = cmf.shape
    rgb = (rgba[..., :3] * 255).astype(np.uint8)
    if "rgb" not in layers:
        rgb[:] = 0
    if "cmf" in layers:
        hot = np.clip((cmf - minppmm) / (maxppmm - minppmm), 0, 1)
        mask = (cmf > minppmm) & ~nodata
        rgb[mask, 0] = np.uint8(255)
        rgb[mask, 1] = (rgb[mask, 1] * (1 - hot[mask])).astype(np.uint8)
        rgb[mask, 2] = (rgb[mask, 2] * (1 - hot[mask])).astype(np.uint8)
    if "salience" in layers and salience_file:
        from ..core.loaders import loadsaliencemap
        sal = loadsaliencemap(salience_file)["saliencemap"]
        if sal.shape == cmf.shape:
            smask = (sal > salthr) & (sal <= 1.0)
            amt = np.clip((sal - salthr) / max(1e-6, 1 - salthr), 0, 1)
            rgb[smask, 2] = np.uint8(255)
            rgb[smask, 1] = np.maximum(
                rgb[smask, 1], (255 * amt[smask]).astype(np.uint8))
    if "labels" in layers and label_file:
        from ..core.labels import loadlabimg, labimg2rgb
        try:
            lab = loadlabimg(label_file)
        except Exception:       # not a label product; skip the layer
            lab = None
        if lab is not None and lab.shape == cmf.shape:
            lrgb = labimg2rgb(lab)          # already uint8 0..255
            lmask = lab != 0
            rgb[lmask] = lrgb[lmask]
    rgb[nodata] = 0
    if "candidates" in layers and candidates:
        for c in candidates:
            r, s = int(round(c["row"])), int(round(c["col"]))
            if 0 <= r < h and 0 <= s < w:
                rr = slice(max(0, r - 3), min(h, r + 4))
                cc = slice(max(0, s - 3), min(w, s + 4))
                rgb[rr, s, :] = (0, 255, 255)
                rgb[r, cc, :] = (0, 255, 255)

    if viewport is not None:
        x0, y0, x1, y1 = (int(v) for v in viewport)
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(w, max(x0 + 1, x1)), min(h, max(y0 + 1, y1))
        rgb = rgb[y0:y1, x0:x1]
    side = max(rgb.shape[:2])
    if side < out_max:
        k = max(1, out_max // side)
        if k > 1:           # nearest-neighbour zoom by an integer factor
            rgb = np.repeat(np.repeat(rgb, k, axis=0), k, axis=1)
    return encode_png(rgb)


def render_cmf_png(cmff, minppmm: float = 250, maxppmm: float = 1500,
                   rdnmax: float = 15.0) -> bytes:
    """Back-compat single-layer render (rgb + cmf, no scaling)."""
    return render_layers_png(cmff, ("rgb", "cmf"), minppmm=minppmm,
                             maxppmm=maxppmm, rdnmax=rdnmax, out_max=0)


_PAGE = """<!doctype html><html><head><title>srcfinder QC tagger</title>
<style>body{font-family:sans-serif;margin:1em}table{border-collapse:collapse}
td,th{border:1px solid #999;padding:2px 6px}#log{white-space:pre;background:#eee;
padding:4px;font-size:11px;max-height:8em;overflow-y:auto}
#img{border:1px solid #333;image-rendering:pixelated;max-width:95vw}</style>
</head><body>
<h3>srcfinder QC tagger — user: <span id=user></span></h3>
<div>flightline: <select id=fl onchange="flChanged()"></select>
 label: <select id=lab></select>
 <button onclick="submitFl()">submit</button>
 <button onclick="resetFl()">reset</button></div>
<div>layers:
 <label><input type=checkbox id=ly_rgb checked onchange="load()">rgb</label>
 <label><input type=checkbox id=ly_cmf checked onchange="load()">cmf</label>
 <label><input type=checkbox id=ly_salience onchange="load()">salience</label>
 <label><input type=checkbox id=ly_labels onchange="load()">labels</label>
 <label><input type=checkbox id=ly_candidates checked onchange="load()">candidates</label>
 &nbsp;zoom: <button onclick="zoom(0.5)">+</button>
 <button onclick="zoom(2)">-</button>
 <button onclick="view=null;load()">fit</button>
 pan: <button onclick="pan(0,-1)">&uarr;</button>
 <button onclick="pan(0,1)">&darr;</button>
 <button onclick="pan(-1,0)">&larr;</button>
 <button onclick="pan(1,0)">&rarr;</button>
 basemap: <select id=wmts></select></div>
<p>click the image to add a candidate with the selected label</p>
<img id=img onclick="addCand(event)">
<h4>flightline flags</h4><table id=flags></table>
<h4>candidates</h4><table id=tbl></table>
<h4>log</h4><div id=log></div>
<script>
let view=null, dims=[0,0], flagOpts={};
async function j(u,opts){const r=await fetch(u,opts);return r.json();}
async function init(){
 const info=await j('/api/info');
 document.getElementById('user').textContent=info.user;
 flagOpts=info.flag_opts;
 const sel=document.getElementById('fl');
 for(const f of info.todo.concat(info.done)){
   const o=document.createElement('option');o.value=f;
   o.textContent=(info.done.includes(f)?'[done] ':'')+f;sel.appendChild(o);}
 const lsel=document.getElementById('lab');
 for(const l of info.labels){const o=document.createElement('option');
   o.value=l;o.textContent=l;lsel.appendChild(o);}
 const wm=await j('/api/wmts');
 const ws=document.getElementById('wmts');
 for(const name in wm){const o=document.createElement('option');
   o.value=wm[name];o.textContent=name;ws.appendChild(o);}
 if(sel.options.length) flChanged();
 refreshLog();
}
function fl(){return document.getElementById('fl').value;}
function layers(){
 return ['rgb','cmf','salience','labels','candidates'].filter(
   l=>document.getElementById('ly_'+l).checked).join(',');}
async function flChanged(){view=null;
 const b=await j('/api/bounds?fl='+encodeURIComponent(fl()));
 dims=[b.width,b.height];loadFlags();load();}
async function load(){
 let u='/img?fl='+encodeURIComponent(fl())+'&layers='+layers();
 if(view)u+='&x0='+view[0]+'&y0='+view[1]+'&x1='+view[2]+'&y1='+view[3];
 document.getElementById('img').src=u+'&t='+Date.now();
 const rows=await j('/api/candidates?fl='+encodeURIComponent(fl()));
 const t=document.getElementById('tbl');
 t.innerHTML='<tr><th>cid</th><th>label</th><th>lat</th><th>lon</th>'
   +'<th></th><th></th></tr>';
 for(const r of rows){const tr=document.createElement('tr');
  let lsel='<select onchange="relabel(\\''+r.cid+'\\',this.value)">';
  for(const l of JSON.parse(document.getElementById('labjson').textContent))
    lsel+='<option'+(l===r.label?' selected':'')+'>'+l+'</option>';
  lsel+='</select>';
  tr.innerHTML='<td>'+r.cid+'</td><td>'+lsel+'</td><td>'+r.lat.toFixed(5)
   +'</td><td>'+r.lon.toFixed(5)+'</td>'
   +'<td><button onclick="zoomTo('+r.col+','+r.row+')">zoom</button></td>'
   +'<td><button onclick="delCand(\\''+r.cid+'\\')">delete</button></td>';
  t.appendChild(tr);}
}
async function setView(body){
 const r=await j('/api/view',{method:'POST',body:JSON.stringify(
   Object.assign({view:view,dims:dims},body))});
 view=r.view;load();}
function zoom(f){setView({op:'zoom',f:f});}
function pan(dx,dy){setView({op:'pan',dx:dx,dy:dy});}
function zoomTo(x,y){setView({op:'zoomTo',x:x,y:y});}
async function addCand(e){
 const img=document.getElementById('img');
 await j('/api/add',{method:'POST',body:JSON.stringify(
   {fl:fl(),view:view,dims:dims,offx:e.offsetX,offy:e.offsetY,
    imgw:img.width,imgh:img.height,
    label:document.getElementById('lab').value})});
 load();refreshLog();
}
async function relabel(cid,label){
 await j('/api/relabel',{method:'POST',body:JSON.stringify(
   {fl:fl(),cid:cid,label:label})});load();refreshLog();}
async function delCand(cid){
 await j('/api/delete',{method:'POST',body:JSON.stringify({fl:fl(),cid:cid})});
 load();refreshLog();
}
async function loadFlags(){
 const cur=await j('/api/flags?fl='+encodeURIComponent(fl()));
 const t=document.getElementById('flags');t.innerHTML='';
 const tr1=document.createElement('tr'),tr2=document.createElement('tr');
 for(const name in flagOpts){
  tr1.innerHTML+='<th>'+name+'</th>';
  const val=cur.values[name]||'';
  if(flagOpts[name]===null){
   tr2.innerHTML+='<td><input id="flag_'+name+'" value="'+val
     +'" onchange="saveFlags()"></td>';
  }else{
   let s='<select id="flag_'+name+'" onchange="saveFlags()">';
   for(const o of flagOpts[name])
     s+='<option'+(o===val?' selected':'')+'>'+o+'</option>';
   tr2.innerHTML+='<td>'+s+'</select></td>';}}
 t.appendChild(tr1);t.appendChild(tr2);
}
async function saveFlags(){
 const values={};
 for(const name in flagOpts)
   values[name]=document.getElementById('flag_'+name).value;
 await j('/api/flags',{method:'POST',body:JSON.stringify(
   {fl:fl(),values:values})});refreshLog();}
async function submitFl(){await j('/api/submit',{method:'POST',
 body:JSON.stringify({fl:fl()})});refreshLog();}
async function resetFl(){await j('/api/reset',{method:'POST',
 body:JSON.stringify({fl:fl()})});loadFlags();load();refreshLog();}
async function refreshLog(){
 const l=await j('/api/log');
 document.getElementById('log').textContent=l.text;}
init();
</script><script id=labjson type=application/json>__LABELS__</script>
</body></html>"""


def cur_view(view, dims):
    """The page's curView(): the explicit viewport or the full image."""
    return [int(v) for v in view] if view else [0, 0, int(dims[0]),
                                               int(dims[1])]


def view_math(op, view, dims, **p):
    """Viewport navigation — the single source of truth for the page's
    zoom/pan/zoomTo buttons (the JS calls /api/view so no coordinate
    math lives client-side where tests cannot execute it)."""
    import math as _math
    v = cur_view(view, dims)

    def _round(x):       # JS Math.round: half away from zero upward
        return int(_math.floor(x + 0.5))

    if op == "zoom":
        f = float(p["f"])
        cx, cy = (v[0] + v[2]) / 2, (v[1] + v[3]) / 2
        wx = max(16.0, (v[2] - v[0]) * f / 2)
        wy = max(16.0, (v[3] - v[1]) * f / 2)
        return [_round(cx - wx), _round(cy - wy),
                _round(cx + wx), _round(cy + wy)]
    if op == "pan":
        dx, dy = int(p["dx"]), int(p["dy"])
        sx, sy = (v[2] - v[0]) >> 2, (v[3] - v[1]) >> 2
        return [v[0] + dx * sx, v[1] + dy * sy,
                v[2] + dx * sx, v[3] + dy * sy]
    if op == "zoomTo":
        x, y, r = float(p["x"]), float(p["y"]), 64
        return [_round(x - r), _round(y - r), _round(x + r), _round(y + r)]
    raise ValueError(f"unknown view op {op!r}")


def click_to_pixel(view, dims, offx, offy, imgw, imgh):
    """CSS click offset on the rendered image -> image pixel (col, row).
    The page posts the raw event to /api/add; this is the only
    implementation of the mapping (formerly duplicated in JS)."""
    import math as _math
    v = cur_view(view, dims)
    x = int(_math.floor(v[0] + float(offx) * (v[2] - v[0]) / float(imgw)))
    y = int(_math.floor(v[1] + float(offy) * (v[3] - v[1]) / float(imgh)))
    return x, y


class QcWebApp:
    """HTTP labeling app over a :class:`QcSession`."""

    def __init__(self, session: QcSession, plumedf=None, host="127.0.0.1",
                 port: int = 0, flag_opts=None, wmts=None):
        self.session = session
        self.plumedf = plumedf
        self.flag_opts = dict(DEFAULT_FLAG_OPTS if flag_opts is None
                              else flag_opts)
        self.wmts = dict(DEFAULT_WMTS if wmts is None else wmts)
        self._tables = {}          # cmff -> working DataFrame
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, json.dumps(obj).encode())

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                q = dict(urllib.parse.parse_qsl(parsed.query))
                if parsed.path == "/":
                    page = _PAGE.replace("__LABELS__",
                                         json.dumps(ALL_LABELS))
                    self._send(200, page.encode(), "text/html")
                elif parsed.path == "/api/info":
                    self._json(dict(
                        user=app.session.user,
                        todo=[os.path.basename(f) for f in app.session.todo],
                        done=[os.path.basename(f) for f in app.session.done],
                        labels=ALL_LABELS,
                        flag_opts=app.flag_opts))
                elif parsed.path == "/img":
                    self._send(200, app.render(q), "image/png")
                elif parsed.path == "/api/candidates":
                    self._json(app.candidates(q.get("fl", "")))
                elif parsed.path == "/api/flags":
                    cmff = app._resolve(q.get("fl", ""))
                    self._json(dict(columns=app.flag_opts,
                                    values=app.session.load_flags(cmff)))
                elif parsed.path == "/api/wmts":
                    self._json(app.wmts)
                elif parsed.path == "/api/bounds":
                    self._json(app.bounds(q.get("fl", "")))
                elif parsed.path == "/api/log":
                    self._json(dict(text=app.session.log.text()))
                else:
                    self._json(dict(error="not found"), 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                parsed = urllib.parse.urlparse(self.path)
                try:
                    if parsed.path == "/api/add":
                        if "offx" in body:      # raw click event
                            col, row = click_to_pixel(
                                body.get("view"), body["dims"],
                                body["offx"], body["offy"],
                                body["imgw"], body["imgh"])
                        else:                   # direct pixel (API use)
                            col, row = int(body["col"]), int(body["row"])
                        app.add(body["fl"], row, col, body["label"])
                    elif parsed.path == "/api/view":
                        return self._json(dict(view=view_math(
                            body["op"], body.get("view"), body["dims"],
                            **{k: v for k, v in body.items()
                               if k in ("f", "dx", "dy", "x", "y")})))
                    elif parsed.path == "/api/relabel":
                        app.relabel(body["fl"], body["cid"], body["label"])
                    elif parsed.path == "/api/delete":
                        app.delete(body["fl"], body["cid"])
                    elif parsed.path == "/api/flags":
                        cmff = app._resolve(body["fl"])
                        app.session.save_flags(cmff, body["values"])
                    elif parsed.path == "/api/submit":
                        app.session.submit(app._resolve(body["fl"]))
                    elif parsed.path == "/api/reset":
                        cmff = app._resolve(body["fl"])
                        app.session.reset(cmff)
                        app._tables.pop(cmff, None)
                    else:
                        return self._json(dict(error="not found"), 404)
                    self._json(dict(ok=True))
                except Exception as e:  # surface errors to the UI
                    self._json(dict(error=str(e)), 400)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = None

    # ---- app logic -----------------------------------------------------
    def _resolve(self, fl_basename: str) -> str:
        for f in self.session.datafiles:
            if os.path.basename(f) == fl_basename:
                return f
        raise KeyError(f"unknown flightline {fl_basename}")

    def _table(self, cmff):
        if cmff not in self._tables:
            self._tables[cmff] = self.session.load_candidates(
                cmff, self.plumedf)
        return self._tables[cmff]

    def _mapinfo(self, cmff):
        from ..core.geo import mapinfo
        from ..core.envi import open_envi
        return mapinfo(open_envi(cmff))

    def render(self, q) -> bytes:
        cmff = self._resolve(q.get("fl", ""))
        layers = tuple((q.get("layers") or "rgb,cmf").split(","))
        viewport = None
        if "x0" in q:
            viewport = (float(q["x0"]), float(q["y0"]),
                        float(q["x1"]), float(q["y1"]))
        cands = self.candidates(q.get("fl", "")) \
            if "candidates" in layers else None
        return render_layers_png(
            cmff, layers, viewport=viewport, candidates=cands,
            salience_file=_find_sibling(cmff, ("saliency", "salience")),
            label_file=_find_sibling(cmff, ("_lab",)),
            minppmm=float(q.get("minppmm", 250)),
            maxppmm=float(q.get("maxppmm", 1500)))

    def bounds(self, fl_basename: str):
        """Flightline pixel dims + lat/lon bbox (for WMTS front ends)."""
        from ..core.envi import open_envi
        from ..core.geo import sl2latlon
        cmff = self._resolve(fl_basename)
        img = open_envi(cmff)
        h, w = img.shape[:2]
        m = self._mapinfo(cmff)
        lat0, lon0 = sl2latlon(0, 0, mapinfo=m)
        lat1, lon1 = sl2latlon(w - 1, h - 1, mapinfo=m)
        return dict(width=w, height=h,
                    lat_min=float(min(lat0, lat1)),
                    lat_max=float(max(lat0, lat1)),
                    lon_min=float(min(lon0, lon1)),
                    lon_max=float(max(lon0, lon1)))

    def candidates(self, fl_basename: str):
        from ..core.geo import latlon2sl
        cmff = self._resolve(fl_basename)
        df = self._table(cmff)
        out = []
        m = self._mapinfo(cmff)
        for _, r in df.iterrows():
            lat, lon = float(r[LATCOL]), float(r[LONCOL])
            s, l = latlon2sl(lat, lon, mapinfo=m)
            out.append(dict(cid=str(r[CIDCOL]), label=str(r[LABCOL]),
                            lat=lat, lon=lon, col=float(s), row=float(l)))
        return out

    def add(self, fl_basename: str, row: int, col: int, label: str):
        from ..core.geo import sl2latlon
        cmff = self._resolve(fl_basename)
        m = self._mapinfo(cmff)
        lat, lon = sl2latlon(col, row, mapinfo=m)
        df = self.session.add_candidate(self._table(cmff), cmff,
                                        float(lat), float(lon), label)
        self._tables[cmff] = df
        self.session.autosave(cmff, df)
        return df

    def relabel(self, fl_basename: str, cid: str, label: str):
        """Edit a candidate's label in place (the editable Tabulator
        cell, reference: cmftagger.py:471-532)."""
        cmff = self._resolve(fl_basename)
        df = self._table(cmff)
        sel = df[CIDCOL].astype(str) == str(cid)
        if not sel.any():
            raise KeyError(f"unknown candidate {cid}")
        df.loc[sel, LABCOL] = label
        self._tables[cmff] = df
        self.session.autosave(cmff, df)
        self.session.log.append(f"relabeled {cid} -> {label}")
        return df

    def delete(self, fl_basename: str, cid: str):
        cmff = self._resolve(fl_basename)
        df = self.session.delete_candidate(self._table(cmff), cid)
        self._tables[cmff] = df
        self.session.autosave(cmff, df)
        return df

    # ---- lifecycle -----------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        self.server.shutdown()

    def serve_forever(self):
        print(f"srcfinder QC tagger: http://127.0.0.1:{self.port}/ "
              f"(user {self.session.user})")
        self.server.serve_forever()


def main(argv=None):
    """CLI (reference: cmftagger.py argparse surface: --port, user/paths
    from config/settings.json)."""
    import argparse
    from .session import load_settings

    p = argparse.ArgumentParser(description="srcfinder QC tagger")
    p.add_argument("--config", default="config/settings.json")
    p.add_argument("--user", required=True)
    p.add_argument("--datapath", default=None)
    p.add_argument("--output", default="output")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--precache", action="store_true",
                   help="pre-warp every flightline to the EPSG:3857 "
                        "GeoTIFF cache before serving (reference: "
                        "cmftagger.py:600-616)")
    p.add_argument("--gtif-cache", default="gtif_cache")
    args = p.parse_args(argv)

    settings = {}
    try:
        settings = load_settings(args.config)
    except FileNotFoundError:
        pass
    datapath = args.datapath or settings.get("datapath", ".")
    users = settings.get("users", [args.user])
    port = args.port or user_port(users, args.user)
    sess = QcSession(args.user, datapath, args.output)
    if args.precache:
        from .gtif import precache_gtifs
        outs = precache_gtifs(sess.datafiles, args.gtif_cache)
        print(f"precached {len(outs)} gtifs into {args.gtif_cache}")
    QcWebApp(sess, port=port, flag_opts=settings.get("flag_opts"),
             wmts=settings.get("wmts")).serve_forever()
    return 0


if __name__ == "__main__":
    main()
