"""Host-side utilities of the port: ENVI I/O, geodesy, morphology, tiles,
labels, statistics, physics, GeoTIFF and the stdlib xlsx reader and
writer, all numpy; and the block prefetcher, which stages host blocks
onto the device.

The public names are the JAX package's ``core``'s, but for
``prefetch_to_device`` and the native extension's, which the port does
not carry. They load on first use, so a process imports the modules it
uses only (torch with the prefetcher).
"""

import importlib

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
}
_MODULE_OF = {name: mod for mod, names in _NAMES.items() for name in names}
__all__ = list(_MODULE_OF)


def __getattr__(name):
    if name in _MODULE_OF:
        value = getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
    elif name in _NAMES:
        value = importlib.import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__) | set(_NAMES))
