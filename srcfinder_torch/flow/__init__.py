"""MSF workflow: winds, emissions, clustering, dedup, persistence,
inversion, harvesting, orchestration (reference: msf_flow/); the
one-command pipeline is ``flow.pipeline_cli``.

The public names are the JAX package's ``flow``'s. They load on first
use, so a process that runs one stage (a job of ``srcfinder-jobs``)
imports that stage's modules only, and torch only where the stage runs
on the device.
"""

from .._lazy import lazy_names as _lazy_names

# the function ``cluster`` takes its module's name, as in the JAX package
from .cluster import cluster, cluster_plume_list, source_num_to_str

_NAMES = {
    "windgrid": ("WindGrid", "read_wind_grid", "write_wind_grid_npz",
                 "register_reader", "read_grib2_simple"),
    "wind": ("distance_spherical", "distance_index", "nearest_points", "wind_mnstd",
             "plumetime_format", "nearst_hm", "read_plumes", "gather_plumes"),
    "emission": ("WindType", "get_mean_wind_key", "get_std_wind_key",
                 "compute_emission_rate", "compute_wind_stats"),
    "dedup": ("teale_albers", "circle_overlap_fraction", "overlap_matrix",
              "calculate_overlap", "filter_plumes_recursive", "filter_plumes",
              "remove_duplicate_plumes"),
    "persistence": ("read_shapefile_polygons", "point_in_polygon", "plumes_per_source",
                    "flightlines_per_source", "source_persistence"),
    "inversion": ("ols_inversion", "bayesian_inversion", "background_percentile"),
    "harvester": ("load_dataset_conf", "set_date_range", "replace_template",
                  "paths_generator", "harvest_date_range", "invoke_harvester_windows",
                  "wind_quality_check"),
    "stations": ("station_wind_speed", "get_station_data_for_plume",
                 "plume_datetime_from_cid"),
    "utils": ("DirWatcher", "init_logger", "concat_csvs"),
    "deploy": ("Job", "JobQueue", "watch_and_trigger", "IME_JOB_DEFAULTS"),
    "msf_flow": ("process_plume", "process_plumes", "insert_plumes_in_file",
                 "get_minppmm_from_fname"),
    "ime_worker": ("detection_ime_stats", "compute_ime_for_cmf", "IME_JOB_PARAMS"),
    "wind_export": ("regrid_to_latlon", "write_wind_nc", "wind_grid_to_nc",
                    "parse_wind_filename_date"),
}
__getattr__, __dir__, _LAZY = _lazy_names(__name__, _NAMES)
__all__ = ["cluster", "cluster_plume_list", "source_num_to_str", *_LAZY]
