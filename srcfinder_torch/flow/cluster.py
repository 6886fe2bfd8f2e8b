"""Incremental nearest-neighbor clustering of plumes into sources.

Reference (msf_flow/cluster/cluster_incr_nn.py): lat/lon -> UTM, greedy
online clustering — each plume joins the nearest source centroid within
``radius`` meters (recentering the centroid as the running mean) or seeds
a new source; source ids are "A%08d". The port's copy of the JAX
package's ``flow/cluster.py``.
"""

from __future__ import annotations

import csv

import numpy as np

from ..core.geo import latlon2utm

__all__ = ["cluster", "cluster_plume_list", "source_num_to_str",
           "read_plume_csv", "write_plume_csv"]


def source_num_to_str(source_num: int, prefix: str = "") -> str:
    """(reference: cluster_incr_nn.py:55-56)"""
    return "{}{:08d}".format(prefix, source_num)


def cluster(sample, radius: float = 100.0):
    """Greedy incremental NN clustering (reference:
    cluster_incr_nn.py:58-97). sample: (N, D) projected coords (meters).

    Returns (source_mapping {i: "Axxxxxxxx"}, clusters [[indices]]).
    """
    sample = np.asarray(sample, np.float64)
    sources = [sample[0]]
    clusters = [[0]]
    source_mapping = {0: source_num_to_str(1, "A")}
    for i in range(1, len(sample)):
        sq = ((np.asarray(sources) - sample[i]) ** 2).sum(axis=1)
        ind_min = int(np.argmin(sq))
        if np.sqrt(sq[ind_min]) > radius:
            sources.append(sample[i])
            clusters.append([i])
            source_id = len(sources)
        else:
            clusters[ind_min].append(i)
            sources[ind_min] = np.mean([sample[j]
                                        for j in clusters[ind_min]], axis=0)
            source_id = ind_min + 1
        source_mapping[i] = source_num_to_str(source_id, "A")
    return source_mapping, clusters


def read_plume_csv(path, lat_key="Plume Latitude (deg)",
                   lon_key="Plume Longitude (deg)", fill_value="-9999"):
    """(reference: cluster_incr_nn.py:36-44)"""
    with open(path) as fin:
        reader = csv.DictReader(fin, skipinitialspace=True)
        return [d for d in reader if (d[lat_key] != fill_value
                                      and d[lon_key] != fill_value)]


def write_plume_csv(path, rows):
    if not rows:
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def cluster_plume_list(in_csv, out_csv, radius: float = 150.0,
                       lat_key="Plume Latitude (deg)",
                       lon_key="Plume Longitude (deg)",
                       source_key="Source ID"):
    """CSV in -> CSV out with a Source ID column appended
    (reference: cluster_incr_nn.py:99-176)."""
    rows = read_plume_csv(in_csv, lat_key, lon_key)
    if not rows:
        write_plume_csv(out_csv, rows)
        return rows
    coords = np.array([latlon2utm(float(d[lat_key]), float(d[lon_key]))[:2]
                       for d in rows])
    mapping, _ = cluster(coords, radius=radius)
    for i, row in enumerate(rows):
        row[source_key] = mapping[i]
    write_plume_csv(out_csv, rows)
    return rows
