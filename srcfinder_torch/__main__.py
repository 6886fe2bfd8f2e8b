"""``python -m srcfinder_torch <name> [args...]``: the port's console scripts.

Each name is one of the JAX package's console scripts
(``pyproject.toml``'s ``srcfinder-<name>``) without its prefix, and runs
the port's ``main`` of the same surface with ``args``. With no name, or a
name the port does not run, it prints the names and exits 2; it never
runs the JAX package's script.
"""

from __future__ import annotations

import importlib
import sys

#: console script (without ``srcfinder-``) -> ``module:function`` of the port
COMMANDS = {
    "cmf": "srcfinder_torch.cmf.cli:main",
    "cnn-pred": "srcfinder_torch.detect.cnn_cli:main",
    "fcn-pred": "srcfinder_torch.detect.fcn_cli:main",
    "salience": "srcfinder_torch.detect.salience_cli:main",
    "masks": "srcfinder_torch.masks.cli:main",
    "train": "srcfinder_torch.train.cli:main",
    "triage": "srcfinder_torch.triage.cli:main",
    "msf-flow": "srcfinder_torch.flow.msf_flow:main",
    "downsample": "srcfinder_torch.detect.downsample_cli:main",
    "pipeline": "srcfinder_torch.flow.pipeline_cli:main",
    "grib2npz": "srcfinder_torch.flow.grib_cli:main",
    "ime": "srcfinder_torch.flow.ime_worker:main",
    "harvest": "srcfinder_torch.flow.harvester:main",
    "jobs": "srcfinder_torch.flow.deploy:main",
    "wind-nc": "srcfinder_torch.flow.wind_export:main",
    "cluster": "srcfinder_torch.flow.stage_clis:cluster_main",
    "dedup": "srcfinder_torch.flow.stage_clis:dedup_main",
    "station-winds": "srcfinder_torch.flow.stage_clis:station_winds_main",
    "windspeed": "srcfinder_torch.flow.stage_clis:windspeed_main",
    "wind-qc": "srcfinder_torch.flow.stage_clis:wind_qc_main",
    "persistence": "srcfinder_torch.flow.stage_clis:persistence_main",
    "inversion": "srcfinder_torch.flow.stage_clis:inversion_main",
}

#: the JAX package's console scripts the port does not run yet
NOT_PORTED = ("tagger", "collect-qc", "covid-oracle")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if argv else None
    if name not in COMMANDS:
        if name in NOT_PORTED:
            print(f"srcfinder-{name} is not yet ported to srcfinder_torch",
                  file=sys.stderr)
        else:
            if name is not None:
                print(f"unknown command {name!r}", file=sys.stderr)
            print("usage: python -m srcfinder_torch <name> [args...]\n"
                  f"names: {' '.join(COMMANDS)}\n"
                  f"not yet ported: {' '.join(NOT_PORTED)}", file=sys.stderr)
        return 2
    module, func = COMMANDS[name].split(":")
    return getattr(importlib.import_module(module), func)(argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
