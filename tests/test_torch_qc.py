"""The port's QC sessions, consensus merge and GeoTIFF cache
(srcfinder_torch.qc.session, .collect, .collect_cli, .gtif) held against
the JAX package's on the same numpy-seeded inputs, on the CPU: todo and
done lists, every file written byte for byte, the log text, frames with
``pandas.testing.assert_frame_equal``, and the warped rasters (array,
geotransform, EPSG, nodata) exactly. The cases are those of
tests/test_qc.py run through both packages."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest

from srcfinder_tpu.core import geotiff as jgeotiff
from srcfinder_tpu.qc import collect as jcollect
from srcfinder_tpu.qc import collect_cli as jcollect_cli
from srcfinder_tpu.qc import gtif as jgtif
from srcfinder_tpu.qc import session as jsession
from srcfinder_torch import qc as tqc
from srcfinder_torch.core import envi as tenvi
from srcfinder_torch.core import geotiff as tgeotiff
from srcfinder_torch.qc import collect as tcollect
from srcfinder_torch.qc import collect_cli as tcollect_cli
from srcfinder_torch.qc import gtif as tgtif
from srcfinder_torch.qc import session as tsession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTM_META = {"data ignore value": -9999,
            "map info": ["UTM", "1", "1", "391000", "3786000", "3.0", "3.0", "11", "North",
                         "WGS-84", "units=Meters", "rotation=0"]}
LIDFILTERS = {"Coverage": {"accept": ["good", "partial"], "reject": ["bad"]},
              "Clouds": {"accept": ["none", "some"], "reject": ["many"]}}


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _trees_equal(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k
    return ta


# ------------------------------------------------------------------ consensus
@pytest.mark.parametrize("labels,expect", [
    ([tqc.PLUMELAB], tqc.PLUMELAB),                               # one label
    ([tqc.PLUMELAB, tqc.PLUMELAB], tqc.PLUMELAB),
    ([tqc.PLUMELAB, tqc.REJLAB], tqc.REJLAB),                     # any Reject
    ([tqc.AMBLAB, tqc.REJLAB, tqc.FALSELAB], tqc.REJLAB),
    ([tqc.AMBLAB, tqc.DUPLAB], tqc.AMBLAB),                       # all ambiguous
    ([tqc.BGLAB, tqc.DUPLAB, tqc.AMBLAB], tqc.AMBLAB),
    ([tqc.PLUMELAB, tqc.FALSELAB], tqc.AMBLAB),                   # positive + negative
    ([tqc.SUPERLAB, tqc.CLOUDLAB, tqc.AMBLAB], tqc.AMBLAB),
    ([tqc.PLUMELAB, tqc.AMBLAB], tqc.AMBLAB),                     # ambiguous + one side
    ([tqc.ARTFLAB, tqc.BGLAB], tqc.AMBLAB),
    ([tqc.FALSELAB, tqc.ARTFLAB], tqc.FALSELAB),                  # all negative
    ([tqc.CLOUDLAB, tqc.ARTFLAB, tqc.CLOUDLAB], tqc.FALSELAB),
    ([tqc.PLUMELAB, tqc.SUPERLAB], tqc.SUPERLAB),                 # all positive
    ([tqc.SUPERLAB, tqc.SUPERLAB], tqc.SUPERLAB),
    ([tqc.PLUMELAB, "Unknown"], tqc.AMBLAB),                      # no rule: ambiguous
])
def test_consensus_label_matches_jax(labels, expect):
    got = tcollect.consensus_label(labels)
    assert got == jcollect.consensus_label(labels) == expect
    assert got == tqc.consensus_label(np.array(labels, dtype=object))


def _cid_frame(rng, n_lid=4, n_cid=5, users=("u1", "u2", "u3")):
    """Candidates of several flightlines labelled by several users, the
    labels drawn from the whole vocabulary."""
    vocab = tqc.POSLABS + tqc.NEGLABS + tqc.AMBLABS + [tqc.REJLAB]
    rows = []
    for li in range(n_lid):
        for ci in range(n_cid):
            for u in users:
                if rng.uniform() < 0.8:
                    rows.append({tqc.LIDCOL: f"ang2020090{li}t000000",
                                 tqc.CIDCOL: chr(ord("A") + ci),
                                 tqc.LABCOL: vocab[rng.integers(len(vocab))],
                                 tqc.UIDCOL: u})
    return pd.DataFrame(rows)


@pytest.mark.parametrize("seed", [0, 1])
def test_consensus_candidates_matches_jax(seed):
    rng = np.random.default_rng(seed)
    df = _cid_frame(rng)
    for reject in ((), ("ang20200901t000000",)):
        got = tcollect.consensus_candidates(df, reject)
        pd.testing.assert_frame_equal(got, jcollect.consensus_candidates(df, reject))
        assert set(got[tqc.CLSCOL]) <= {-1, 0, 1}
    # the tests/test_qc.py case
    df = pd.DataFrame({
        tqc.LIDCOL: ["l1", "l1", "l1", "l1", "l2"], tqc.CIDCOL: ["A", "A", "B", "B", "A"],
        tqc.LABCOL: [tqc.PLUMELAB, tqc.SUPERLAB, tqc.PLUMELAB, tqc.FALSELAB, tqc.FALSELAB],
        tqc.UIDCOL: ["u1", "u2", "u1", "u2", "u1"]})
    got = tcollect.consensus_candidates(df)
    pd.testing.assert_frame_equal(got, jcollect.consensus_candidates(df))
    assert got[tqc.LABCOL].tolist() == [tqc.SUPERLAB] * 2 + [tqc.AMBLAB] * 2 + [tqc.FALSELAB]
    assert got[tqc.EVALCOL].tolist() == ["TP", "TP", "", "", "FP"]


@pytest.mark.parametrize("answer", ["y", "n", "m", None])
def test_filter_flightlines_resolver_matches_jax(answer):
    """Flag rules per column, a flightline both users reject alike, one
    they disagree on (the resolver's, or ambiguous without one), one
    accepted."""
    liddf = pd.DataFrame({
        tqc.LIDCOL: ["l1", "l1", "l2", "l2", "l3", "l3"],
        "Coverage": ["good", "bad", "bad", "bad", "good", "partial"],
        "Clouds": ["none", "none", "many", "some", "some", "none"],
        "Usernotes": ["", "x", "", "", "", ""],
        tqc.UIDCOL: ["u1", "u2", "u1", "u2", "u1", "u2"]})
    seen = {}

    def resolver(tag):
        def ask(lid, group):
            seen.setdefault(tag, []).append((lid, group.copy()))
            return answer
        return ask if answer else None

    got = tcollect.filter_flightlines(liddf, LIDFILTERS, resolver("t"))
    ref = jcollect.filter_flightlines(liddf, LIDFILTERS, resolver("j"))
    pd.testing.assert_frame_equal(got, ref)
    if answer:
        assert [lid for lid, _ in seen["t"]] == [lid for lid, _ in seen["j"]] == ["l1"]
        for (_, a), (_, b) in zip(seen["t"], seen["j"]):
            pd.testing.assert_frame_equal(a, b)
    want = {"y": tqc.REJLAB, "n": tqc.KEEPLAB, "m": tqc.AMBLAB, None: tqc.AMBLAB}[answer]
    assert got.loc[got[tqc.LIDCOL] == "l1", tqc.LABCOL].tolist() == [want, want]
    assert got.loc[got[tqc.LIDCOL] == "l2", tqc.LABCOL].tolist() == [tqc.REJLAB] * 2
    assert got.loc[got[tqc.LIDCOL] == "l3", tqc.LABCOL].tolist() == [tqc.KEEPLAB] * 2
    with pytest.raises(AssertionError, match="unmapped"):
        tcollect.filter_flightlines(liddf.assign(Clouds="fog"), LIDFILTERS)


def _season(out, rng, users=("u1", "u2", "u3"), lids=4):
    """Submitted CSVs of several users: candidates with shared cids and
    the flightline flags (one flightline rejected by a flag, one in
    conflict)."""
    df = _cid_frame(rng, n_lid=lids, users=users)
    flags = {"good": "none", "bad": "none", "partial": "many"}
    for u in users:
        sub = os.path.join(out, u, "submitted")
        os.makedirs(sub)
        for li in range(lids):
            lid = f"ang2020090{li}t000000"
            base = f"{lid}_cmf_v2y1_img"
            mine = df[(df[tqc.UIDCOL] == u) & (df[tqc.LIDCOL] == lid)].drop(columns=tqc.UIDCOL)
            mine.to_csv(os.path.join(sub, base + "_cid.csv"), index=False)
            cov = "bad" if li == 1 else ("partial" if li == 2 and u == "u2" else "good")
            pd.DataFrame([{tqc.LIDCOL: lid, "Coverage": cov, "Clouds": flags[cov],
                           "Usernotes": f"{u} {li}"}]).to_csv(
                os.path.join(sub, base + "_lid.csv"), index=False)
    return df


def test_gather_submitted_matches_jax(tmp_path, rng):
    _season(str(tmp_path), rng)
    for users in (None, ["u1", "u3"], ["nobody"]):
        got = tcollect.gather_submitted(str(tmp_path), users)
        ref = jcollect.gather_submitted(str(tmp_path), users)
        for g, r in zip(got, ref):
            pd.testing.assert_frame_equal(g, r)
    assert len(tcollect.gather_submitted(str(tmp_path))[1]) == 12


@pytest.mark.parametrize("users", [None, ["u1", "u2"]])
def test_collect_qcdata_files_equal_jax(tmp_path, rng, users):
    """All five CSVs of the merge byte for byte, and the returned frames."""
    _season(str(tmp_path / "out"), rng)
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    got = tcollect.collect_qcdata(str(tmp_path / "out"), LIDFILTERS, str(tmp_path / "t" / "camp"),
                                  users=users, resolver=lambda lid, df: "m")
    ref = jcollect.collect_qcdata(str(tmp_path / "out"), LIDFILTERS, str(tmp_path / "j" / "camp"),
                                  users=users, resolver=lambda lid, df: "m")
    for g, r in zip(got, ref):
        pd.testing.assert_frame_equal(g, r)
    files = _trees_equal(tmp_path / "t", tmp_path / "j")
    assert sorted(files) == sorted(f"camp_{s}.csv" for s in (
        "lid_filt", "cid_filt", "cid_filt_nodup", "cid_filt_nodup_norej",
        "cid_filt_nodup_norej_noamb"))


def test_collect_cli_matches_jax(tmp_path, rng, capsys):
    _season(str(tmp_path / "out"), rng)
    lidf = tmp_path / "lidfilters.json"
    lidf.write_text(json.dumps(LIDFILTERS))
    outs = {}
    for tag, mod in (("t", tcollect_cli), ("j", jcollect_cli)):
        os.makedirs(tmp_path / tag)
        prefix = str(tmp_path / tag / "camp")
        rc = mod.main([str(tmp_path / "out"), "--lidfilters", str(lidf), "--outprefix", prefix,
                       "--auto-resolve", "y"])
        assert rc == 0
        outs[tag] = capsys.readouterr().out.replace(prefix, "PREFIX")
    assert outs["t"] == outs["j"] and "final candidates" in outs["t"]
    _trees_equal(tmp_path / "t", tmp_path / "j")


def test_collect_qc_dispatcher_process(tmp_path, rng):
    """python -m srcfinder_torch collect-qc writes the JAX collect_cli's
    CSVs, and its process imports no torch, jax or srcfinder_tpu."""
    _season(str(tmp_path / "out"), rng)
    lidf = tmp_path / "lidfilters.json"
    lidf.write_text(json.dumps(LIDFILTERS))
    for tag in ("t", "j"):
        os.makedirs(tmp_path / tag)
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONPROFILEIMPORTTIME="1")
    out = subprocess.run([sys.executable, "-m", "srcfinder_torch", "collect-qc",
                          str(tmp_path / "out"), "--lidfilters", str(lidf), "--outprefix",
                          str(tmp_path / "t" / "camp"), "--auto-resolve", "n"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert jcollect_cli.main([str(tmp_path / "out"), "--lidfilters", str(lidf), "--outprefix",
                              str(tmp_path / "j" / "camp"), "--auto-resolve", "n"]) == 0
    _trees_equal(tmp_path / "t", tmp_path / "j")
    imported = {line.split("|")[-1].strip().split(".")[0] for line in out.stderr.splitlines()
                if line.startswith("import time:")}
    assert "pandas" in imported
    assert not imported & {"torch", "jax", "jaxlib", "flax", "srcfinder_tpu"}


# ------------------------------------------------------------------- sessions
def _lifecycle(mod, data, out, plumedf):
    """A whole session: discovery, candidates from the campaign list, adds
    of both kinds, a relabel by table edit, a delete, flags, autosave,
    reload, submit, reset, load_flags from submitted/. Returns every
    observable result."""
    trace = []
    sess = mod.QcSession("alice", data, out)
    trace.append(("todo", list(sess.todo), list(sess.done), list(sess.datafiles)))
    first, second = sess.todo[0], sess.todo[1]
    df = sess.load_candidates(first, plumedf)
    trace.append(("loaded", df))
    df = sess.add_candidate(df, first, 34.5, -118.5, tqc.PLUMELAB)
    df = sess.add_candidate(df, first, 34.6, -118.6, tqc.FALSELAB)
    df = sess.add_candidate(df, first, 34.7, -118.7, tqc.SUPERLAB)
    df.loc[df[tqc.CIDCOL] == "A", tqc.LABCOL] = tqc.CLOUDLAB
    df = sess.delete_candidate(df, "B")
    trace.append(("edited", df))
    trace.append(("autosave", sess.autosave(first, df, lid_flags={"Coverage": "good",
                                                                  "Clouds": "",
                                                                  "Usernotes": "a, b"})))
    trace.append(("reloaded", sess.load_candidates(first, plumedf)))
    trace.append(("flags", sess.load_flags(first)))
    trace.append(("submitted", sess.submit(first), list(sess.todo), list(sess.done)))
    df2 = sess.add_candidate(sess.load_candidates(second), second, 34.4, -118.4, tqc.AMBLAB)
    sess.autosave(second, df2)
    sess.save_flags(second, {"Coverage": "bad"})
    sess.reset(second)
    sess.reset(first)
    trace.append(("after reset", sess.load_candidates(second), sess.load_flags(first),
                  sess.load_flags(second)))
    trace.append(("log", sess.log.text(), len(sess.log), sess.log[0]))
    sess2 = mod.QcSession("alice", data, out, file_regex=r".*_cmf_.*img$", log_len=3)
    trace.append(("resumed", list(sess2.todo), list(sess2.done), sess2.log.text()))
    return trace


def _equal(a, b):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


def test_session_lifecycle_matches_jax(tmp_path):
    data = tmp_path / "data"
    os.makedirs(data)
    for lid in ("ang20200924t211102", "ang20200925t120000", "ang20200926t010203"):
        (data / f"{lid}_cmf_v2y1_img").write_bytes(b"")
        (data / f"{lid}_cmf_v2y1_img.hdr").write_bytes(b"")
    (data / "ang20200927t000000_ch4mf_v2y1_img").write_bytes(b"")
    plumedf = pd.DataFrame({
        tqc.LIDCOL: ["ang20200924t211102"] * 2 + ["ang20200925t120000"],
        tqc.CIDCOL: ["ang20200924t211102-C", "ang20200924t211102-D", "x-A"],
        tqc.LATCOL: [34.1, 34.2, 34.3], tqc.LONCOL: [-118.1, -118.2, -118.3],
        tqc.LABCOL: [tqc.PLUMELAB, tqc.ARTFLAB, tqc.PLUMELAB]})
    got = _lifecycle(tsession, str(data), str(tmp_path / "t"), plumedf)
    ref = _lifecycle(jsession, str(data), str(tmp_path / "j"), plumedf)
    for g, r in zip(got, ref):
        assert g[0] == r[0]
        if g[0] in ("autosave", "submitted"):     # paths under each output dir
            g, r = ([str(x).replace(str(tmp_path / "t"), "OUT") for x in
                     (g[1] if isinstance(g[1], list) else [g[1]])],
                    [str(x).replace(str(tmp_path / "j"), "OUT") for x in
                     (r[1] if isinstance(r[1], list) else [r[1]])])
        _equal(g, r)
    files = _trees_equal(tmp_path / "t", tmp_path / "j")
    assert sorted(files) == ["alice/submitted/ang20200924t211102_cmf_v2y1_img_cid.csv",
                             "alice/submitted/ang20200924t211102_cmf_v2y1_img_lid.csv"]
    assert got[0][1] == [str(data / f"{lid}_cmf_v2y1_img") for lid in
                         ("ang20200924t211102", "ang20200925t120000", "ang20200926t010203")] \
        + [str(data / "ang20200927t000000_ch4mf_v2y1_img")]
    assert "submitted ang20200924t211102_cmf_v2y1_img" in got[-2][1]


def test_circular_buffer_and_settings_match_jax(tmp_path):
    bufs = [mod.CircularBuffer(3) for mod in (tsession, jsession)]
    for b in bufs:
        for i in range(5):
            b.append(i)
    assert [list(b) for b in bufs] == [[2, 3, 4]] * 2
    assert [(len(b), b[0], b[-1], b.text()) for b in bufs] == [(3, 2, 4, "2\n3\n4")] * 2
    good = tmp_path / "settings.json"
    good.write_text(json.dumps({"users": ["bob", "alice"], "datapath": "/d"}))
    assert tsession.load_settings(str(good)) == jsession.load_settings(str(good))
    bad = tmp_path / "bad.json"
    bad.write_text('{"users": ["bob",]}')
    with pytest.raises(json.JSONDecodeError):
        tsession.load_settings(str(bad))


# ----------------------------------------------------------------------- gtif
def _product(path, rng, h=40, w=30, meta=UTM_META):
    dat = np.zeros((h, w, 4), np.float32)
    dat[..., :3] = rng.uniform(1, 10, (h, w, 3))
    dat[..., 3] = np.arange(h * w, dtype=np.float32).reshape(h, w)
    dat[0, 0] = -9999
    tenvi.save_envi(path + ".hdr", dat, metadata=meta, interleave="bip")
    return dat


@pytest.mark.parametrize("zone", ["11", "17"])
def test_img_to_gtif_matches_jax(tmp_path, rng, zone):
    """The warped raster, its geotransform, EPSG and nodata exactly, the
    file byte for byte, and the pixel the JAX test picks by projection."""
    meta = dict(UTM_META, **{"map info": list(UTM_META["map info"])})
    meta["map info"][7] = zone
    imgf = str(tmp_path / "ang20200924t211102_cmf_v2y1_img")
    dat = _product(imgf, rng, meta=meta)
    tout = tgtif.img_to_gtif(imgf, str(tmp_path / "t"))
    jout = jgtif.img_to_gtif(imgf, str(tmp_path / "j"))
    assert os.path.basename(tout) == os.path.basename(jout) == \
        "ang20200924t211102_cmf_v2y1_img_epsg3857.tif"
    with open(tout, "rb") as f, open(jout, "rb") as g:
        assert f.read() == g.read()
    (ta, tm), (ja, jm) = tgtif.load_cache_gtif(imgf, str(tmp_path / "t")), \
        jgtif.load_cache_gtif(imgf, str(tmp_path / "j"))
    np.testing.assert_array_equal(ta, ja)
    assert tm["geotransform"] == jm["geotransform"]
    assert tm["epsg"] == jm["epsg"] == 3857 and tm["nodata"] == jm["nodata"] == -9999.0
    assert ta.shape[2] == 4 and (ta[..., 3] == -9999).any()
    assert set(np.unique(ta[..., 3])) - {-9999.0} <= set(dat[..., 3].ravel())


def test_gtif_lock_protocol(tmp_path, rng):
    """A second caller reuses the file; a held lock blocks until released
    and the finished file is reused; a lock never released raises."""
    imgf = str(tmp_path / "ang_x_cmf_img")
    _product(imgf, rng)
    cache = str(tmp_path / "gtifs")
    outf = tgtif.img_to_gtif(imgf, cache)
    m1 = os.path.getmtime(outf)
    time.sleep(0.01)
    assert tgtif.img_to_gtif(imgf, cache) == outf and os.path.getmtime(outf) == m1
    lock = outf + ".lock"
    os.remove(outf)
    with open(lock, "w"):
        pass

    def release():
        time.sleep(0.3)
        tgeotiff.write_geotiff(outf, np.zeros((2, 2), np.float32))
        os.remove(lock)

    t = threading.Thread(target=release)
    t.start()
    got = tgtif.img_to_gtif(imgf, cache)
    t.join(timeout=30)
    assert not t.is_alive()
    assert got == outf and tgeotiff.read_geotiff(outf)[0].shape == (2, 2)
    os.remove(outf)
    with open(lock, "w"):
        pass
    for mod in (tgtif, jgtif):
        with pytest.raises(TimeoutError, match="stale gtif lock"):
            mod.img_to_gtif(imgf, cache, lock_timeout=0.2)
    assert os.path.isfile(lock) and not os.path.isfile(outf)


def test_precache_gtifs_matches_jax(tmp_path, rng):
    """Two products warped by two worker processes, then again with
    overwrite: the JAX package's files."""
    imgs = []
    for name in ("ang20200924t211102_cmf_v2y1_img", "ang20200925t120000_cmf_v2y1_img"):
        imgs.append(str(tmp_path / name))
        _product(imgs[-1], rng)
    tout = tgtif.precache_gtifs(imgs, str(tmp_path / "t"), workers=2)
    jout = jgtif.precache_gtifs(imgs, str(tmp_path / "j"), workers=2)
    assert [os.path.basename(p) for p in tout] == [os.path.basename(p) for p in jout]
    _trees_equal(tmp_path / "t", tmp_path / "j")
    assert tgtif.precache_gtifs(imgs, str(tmp_path / "t"), workers=2, overwrite=True) == tout
    assert tgtif.precache_gtifs(imgs[:1], str(tmp_path / "t")) == tout[:1]
    _trees_equal(tmp_path / "t", tmp_path / "j")


@pytest.mark.parametrize("case", ["noise", "nodata", "steps"])
def test_lzw_encoder_bytes_equal_jax(case):
    """The port's LZW encoder against the JAX package's pure-Python one on
    inputs long enough for many table restarts and every code width."""
    rng = np.random.default_rng(5)
    if case == "noise":
        data = rng.normal(100, 30, (120, 200, 4)).astype(np.float32).tobytes()
    elif case == "nodata":
        a = np.full((150, 160, 4), -9999, np.float32)
        a[20:130, 30:140] = rng.uniform(0, 5, (110, 110, 4))
        data = a.tobytes()
    else:
        data = np.repeat(rng.integers(0, 256, 4000, dtype=np.uint8), 25).tobytes()
    got = tgeotiff._lzw_encode_py(data)
    assert got == jgeotiff._lzw_encode_py(data)
    assert tgeotiff._lzw_decode_py(got) == data
