"""Inputs made from ``--seed``: GoogLeNet-1ch weights, the AVIRIS-NG-shaped
radiance flightline with its CH4 unit-absorption library, and the ppm*m
band of the exact CNN. Random draws are made on the card in a few large
calls; the same seed gives the same inputs.

The flightline scene is laid out as chip_smoke.py's ``write_scene`` (the
port's card smoke test), with the configuration's numbers:
|N(radiance_mean, noise_sd^2)| + radiance_floor in every band, a box of
pixels scaled by absorb_factor in absorb_bands, and the nodata pixels
(``aviris-ng-flightline-snr``: |N(4, 0.01^2)| + 0.5, 0.5% absorption in
bands 360-409, three nodata pixels).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .reference.googlenet import GoogLeNet1ch

WEIGHT_SALT, SCENE_SALT, BAND_SALT = 0, 1 << 40, 2 << 40


def generator(device, seed: int, salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed + salt) % (1 << 63))


def seeded_state_dict(seed: int, device, spec: dict) -> dict:
    """GoogLeNet-1ch state dict (the reference checkpoint's names), float32
    on ``device``. Conv weights N(0, conv_gain^2 / fan_in); fc weights
    N(0, fc_gain^2 / fan_in), each row then centred over its 1024 inputs so
    that the features' common positive level does not push every logit one
    way; fc bias 0. ``spec["bn"]``: "init" keeps BatchNorm at its published
    init (identity statistics and affine); "trained_like" draws gamma
    U(0.5, 1.5), beta N(0, 0.2^2), running mean N(0, 0.2^2), running
    variance U(0.5, 1.5)."""
    gen = generator(device, seed, WEIGHT_SALT)
    with torch.device("meta"):
        shapes = {k: (v.shape, v.dtype) for k, v in GoogLeNet1ch().state_dict().items()}
    wkeys = [k for k in shapes if k.endswith("conv.weight")] + ["fc.weight"]
    flat = torch.randn(sum(math.prod(shapes[k][0]) for k in wkeys), generator=gen,
                       device=device)
    sd, i = {}, 0
    for k in wkeys:
        shape = shapes[k][0]
        n = math.prod(shape)
        gain = spec["fc_gain"] if k == "fc.weight" else spec["conv_gain"]
        sd[k] = flat[i:i + n].view(shape) * (gain / math.sqrt(n // shape[0]))
        i += n
    sd["fc.weight"] = sd["fc.weight"] - sd["fc.weight"].mean(dim=1, keepdim=True)
    sd["fc.bias"] = torch.zeros(2, device=device)
    bn = [k[:-len(".weight")] for k in shapes if k.endswith("bn.weight")]
    nbn = sum(shapes[p + ".weight"][0][0] for p in bn)
    if spec["bn"] == "trained_like":
        u, z = (torch.rand(2, nbn, generator=gen, device=device),
                torch.randn(2, nbn, generator=gen, device=device))
        parts = dict(weight=0.5 + u[0], bias=0.2 * z[0], running_mean=0.2 * z[1],
                     running_var=0.5 + u[1])
    elif spec["bn"] == "init":
        one, zero = torch.ones(nbn, device=device), torch.zeros(nbn, device=device)
        parts = dict(weight=one, bias=zero, running_mean=zero, running_var=one)
    else:
        raise ValueError(f"unknown BatchNorm weights {spec['bn']!r}")
    i = 0
    for p in bn:
        c = shapes[p + ".weight"][0][0]
        for leaf, v in parts.items():
            sd[f"{p}.{leaf}"] = v[i:i + c]
        sd[f"{p}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
        i += c
    return {k: sd[k].contiguous() for k in shapes}


def write_envi_header(path: str, lines: int, samples: int, bands: int, interleave: str,
                      data_type: int, extra: dict) -> None:
    rows = ["ENVI", f"samples = {samples}", f"lines = {lines}", f"bands = {bands}",
            "header offset = 0", "file type = ENVI Standard", f"data type = {data_type}",
            f"interleave = {interleave}", "byte order = 0"]
    for k, v in extra.items():
        rows.append(f"{k} = {{{', '.join(map(str, v))}}}" if isinstance(v, list)
                    else f"{k} = {v}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def write_scene(workdir: str, cfg: dict, seed: int, device) -> tuple:
    """The seeded radiance (BIL float32, written in line blocks) and the
    CH4 library. Returns (radiance path, library path, library column 3)."""
    nl, ns, nb = cfg["lines"], cfg["samples"], cfg["bands"]
    (p0, p1), (q0, q1) = cfg["plume_lines"], cfg["plume_samples"]
    a0, a1 = cfg["absorb_bands"]
    rdn = os.path.join(workdir, cfg["scene_name"])
    write_envi_header(rdn + ".hdr", nl, ns, nb, "bil", 4, {
        "data ignore value": cfg["nodata"], "map info": cfg["map_info"],
        "wavelength": [f"{w:.2f}" for w in np.linspace(*cfg["wavelength_nm"], nb)]})
    mm = np.memmap(rdn, dtype="<f4", mode="w+", shape=(nl, nb, ns))
    gen = generator(device, seed, SCENE_SALT)
    absorb = torch.ones(nb, device=device)
    absorb[a0:a1] = cfg["absorb_factor"]
    step = cfg["write_block_lines"]
    for r0 in range(0, nl, step):
        r1 = min(nl, r0 + step)
        blk = (torch.randn(r1 - r0, ns, nb, generator=gen, device=device)
               * cfg["noise_sd"] + cfg["radiance_mean"]).abs_().add_(cfg["radiance_floor"])
        lo, hi = max(r0, p0), min(r1, p1)
        if lo < hi:
            blk[lo - r0:hi - r0, q0:q1] *= absorb
        for r, c in cfg["nodata_pixels"]:
            if r0 <= r < r1:
                blk[r - r0, c] = cfg["nodata"]
        mm[r0:r1] = blk.permute(0, 2, 1).cpu().numpy()
    mm.flush()
    del mm
    rng = np.random.default_rng(seed)
    lib = np.zeros((nb, 3))
    lib[:, 0] = np.arange(1, nb + 1)
    lib[:, 1] = np.linspace(*cfg["wavelength_nm"], nb)
    lib[:, 2] = -np.abs(rng.normal(size=nb)) * cfg["library_scale"]
    libf = os.path.join(workdir, cfg["library_name"])
    np.savetxt(libf, lib)
    return rdn, libf, lib[:, 2]


def seeded_band(cfg: dict, seed: int, device) -> np.ndarray:
    """(lines, samples) float32 ppm*m band: N(0, sd^2) background, a fixed
    number of Gaussian plumes (centre, peak and width drawn from the seed)
    and the configured nodata pixels."""
    nl, ns = cfg["lines"], cfg["samples"]
    gen = generator(device, seed, BAND_SALT)
    band = torch.randn(nl, ns, generator=gen, device=device) * cfg["background_sd"]
    k = cfg["plumes"]
    u = torch.rand(k, 4, generator=gen, device=device)
    rows = torch.arange(nl, device=device, dtype=torch.float32)[:, None]
    cols = torch.arange(ns, device=device, dtype=torch.float32)[None, :]
    (pk0, pk1), (w0, w1) = cfg["plume_peak"], cfg["plume_sd_px"]
    for r, c, a, w in (u * torch.tensor([nl, ns, 1.0, 1.0], device=device)).tolist():
        peak, sd = pk0 + a * (pk1 - pk0), w0 + w * (w1 - w0)
        band += peak * torch.exp(-((rows - r) ** 2 + (cols - c) ** 2) / (2 * sd * sd))
    for r, c in cfg["nodata_pixels"]:
        band[r, c] = cfg["nodata"]
    return band.cpu().numpy()
