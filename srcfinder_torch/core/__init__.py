"""Host-side utilities of the port: ENVI I/O, geodesy, morphology, tiles,
labels, statistics, physics, GeoTIFF and the stdlib xlsx reader and
writer, all numpy; and the block prefetcher, which stages host blocks
onto the device.

The public names are the JAX package's ``core``'s, but for
``prefetch_to_device``, which the port does not carry; ``HAVE_NATIVE``,
``bil_window_to_lcb`` and ``label8`` are the port's own C++ host runtime
(``native``). They load on first use, so a process imports the modules
it uses only (torch with the prefetcher).
"""

from .._lazy import lazy_names as _lazy_names

_NAMES = {
    "envi": ("EnviImage", "open_envi", "create_envi", "save_envi", "find_header",
             "read_header", "write_header", "dtype_to_envi", "envi_to_dtype", "NODATA"),
    "geo": ("latlon2utm", "utm2latlon", "geo2utmzone", "utmzone2epsg", "epsg2utmzone",
            "sl2xy", "xy2sl", "sl2latlon", "latlon2sl", "latlon2xy", "rotxy", "mapinfo",
            "mapdict2str", "geobbox", "gcdist"),
    "morphology": ("CONN4", "CONN8", "imlabel", "findobj", "disk", "bwopen", "bwdilate",
                   "bwdist", "mergelabels", "remove_small_objects", "relabel_sequential",
                   "region_maxima", "local_maxima", "imresize"),
    "stats": ("counts", "extrema", "mad"),
    "labels": ("CMFBG", "POINTSRC", "DIFFSRC", "FALSESRC", "LOCSRC", "CMFLABELS", "LIDCOL",
               "CIDCOL", "LATCOL", "LONCOL", "LABCOL", "XLSCOL", "EVALCOL", "rgb2labimg",
               "labimg2rgb", "loadlabimg", "float2rgba", "rgba2float"),
    "tiles": ("pixbox", "inbbox", "extract_tile", "bbox_overlap", "iou"),
    "physics": ("ime", "ime_scale"),
    "geotiff": ("write_geotiff", "read_geotiff"),
    "loaders": ("loadcmf", "loadmaskedimage", "loadfiltdet", "loaddetids",
                "loadsaliencemap", "load_plumedf", "parse_masks", "mask2rgb", "absnorm",
                "smoothbil"),
    "prefetch": ("BlockPrefetcher",),
    "native": ("HAVE_NATIVE", "bil_window_to_lcb", "label8"),
}
__getattr__, __dir__, __all__ = _lazy_names(__name__, _NAMES)
