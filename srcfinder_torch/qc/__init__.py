"""Plume QC: the label taxonomy, labelling sessions, the consensus merge,
the EPSG:3857 GeoTIFF cache (``gtif``) and the tagger web app (reference:
cmftagger/).

The public names are the JAX package's ``qc``'s, with the rest of the
port's ``labels``. They load on first use; the package is host code and
imports no torch.
"""

from .._lazy import lazy_names as _lazy_names

_NAMES = {
    "labels": ("CMFCOL", "EVALCOL", "LIDCOL", "CIDCOL", "LATCOL", "LONCOL", "LABCOL",
               "CLSCOL", "UIDCOL", "DONECOL", "ROWCOL", "COLCOL", "XCOL", "YCOL",
               "KEEPLAB", "REJLAB", "PLUMELAB", "SUPERLAB", "POSLABS", "ARTFLAB",
               "CLOUDLAB", "FALSELAB", "NEGLABS", "AMBLAB", "BGLAB", "DUPLAB", "AMBLABS",
               "classlabs", "next_cid", "lnglat_to_meters", "meters_to_lnglat",
               "cmff_to_lid", "lid2uidassign", "save_flag_csv", "load_flag_csv",
               "save_classlabs"),
    "collect": ("gather_submitted", "filter_flightlines", "consensus_label",
                "consensus_candidates", "collect_qcdata"),
    "session": ("CircularBuffer", "QcSession", "load_settings"),
    "webapp": ("QcWebApp", "user_port", "render_cmf_png"),
}
__getattr__, __dir__, __all__ = _lazy_names(__name__, _NAMES)
