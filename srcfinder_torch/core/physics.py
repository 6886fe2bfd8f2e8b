"""Methane physics: integrated methane enhancement (IME)
(reference: srcfinder_util.py:1989-1996)."""

from __future__ import annotations

import numpy as np

__all__ = ["ime_scale", "ime"]


def ime_scale(ps: float) -> float:
    """ppm*m -> kg conversion factor for pixel size ``ps`` meters
    (reference: srcfinder_util.py:1989-1992).

    chain:  ppm(m) * ps^2 [m^3] * 1000 [L/m^3] / 22.4 [L/mole] * 0.01604 [kg/mole]
    """
    return (1.0 / 1e6) * (ps * ps) * 1000.0 * (1.0 / 22.4) * 0.01604


def ime(pixels_ppmm, ps: float) -> float:
    """Integrated methane enhancement in kg for plume pixels in ppm*m
    (reference: srcfinder_util.py:1994-1996)."""
    pixels_ppmm = np.asarray(pixels_ppmm)
    assert (np.isfinite(pixels_ppmm) & (pixels_ppmm >= 0)).all()
    return float(pixels_ppmm.sum() * ime_scale(ps))
