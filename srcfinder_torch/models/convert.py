"""Weights between the JAX package's Flax GoogLeNet tree and this port.

The JAX package stores weights as a Flax variables tree
``{"params": ..., "batch_stats": ...}`` (NHWC: conv kernels HWIO, dense
kernels (in, out)), saved flattened to ``.npz`` with ``/``-joined keys
(the JAX package's ``detect/cnn_cli.py::save_weights``). The port's
:class:`~srcfinder_torch.models.googlenet.GoogLeNet` uses the reference
torch checkpoint names and layouts (conv OIHW, linear (out, in)).

- :func:`flax_to_torch_state_dict`: Flax tree (nested or flattened, numpy)
  -> the port's ``state_dict`` — the one path by which both packages get
  the same weights.
- :func:`torch_state_dict_to_flax`: the inverse (reference ``.pt`` ->
  Flax tree).
- :func:`load_weights` / :func:`save_weights`: ``.npz`` (Flax layout) and
  ``.pt`` (torch layout) files.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["flax_to_torch_state_dict", "torch_state_dict_to_flax",
           "load_weights", "save_weights", "unflatten"]


def unflatten(flat):
    """``{"params/conv1/conv/kernel": array}`` -> nested dict."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def flax_to_torch_state_dict(variables):
    """Flax GoogLeNet variables (numpy leaves; nested, or flattened with
    ``/`` keys) -> the port's ``state_dict`` (torch tensors, reference
    names). Aux-head parameters are dropped: the port's network is the
    inference trunk. Every BatchNorm gets ``num_batches_tracked = 0``."""
    if any("/" in k for k in variables):
        variables = unflatten(variables)
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                out[tuple(prefix + [k])] = np.asarray(v)

    walk(variables["params"], [])
    walk(variables.get("batch_stats", {}), [])

    sd = {}
    for path, v in out.items():
        mods, flax_leaf = list(path[:-1]), path[-1]
        if mods[0] in ("aux1", "aux2"):
            continue
        name = re.sub(r"branch(\d)_(\d)", r"branch\1.\2", ".".join(mods))
        if flax_leaf == "kernel":
            v = np.transpose(v, (3, 2, 0, 1) if v.ndim == 4 else (1, 0))
            sd[name + ".weight"] = v
        elif flax_leaf == "scale":
            sd[name + ".weight"] = v
            sd[name + ".num_batches_tracked"] = np.zeros((), np.int64)
        elif flax_leaf == "bias":
            sd[name + ".bias"] = v
        elif flax_leaf == "mean":
            sd[name + ".running_mean"] = v
        elif flax_leaf == "var":
            sd[name + ".running_var"] = v
        else:
            raise KeyError(f"unrecognized Flax leaf: {'/'.join(path)}")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _route_convbn(params, stats, prefix, mod, leaf, v):
    if mod == "conv":
        if leaf != "weight":
            raise KeyError(f"unexpected conv leaf {leaf}")
        _assign(params, prefix + ["conv", "kernel"],
                np.transpose(v, (2, 3, 1, 0)))            # OIHW -> HWIO
    elif leaf == "weight":
        _assign(params, prefix + ["bn", "scale"], v)
    elif leaf == "bias":
        _assign(params, prefix + ["bn", "bias"], v)
    elif leaf == "running_mean":
        _assign(stats, prefix + ["bn", "mean"], v)
    elif leaf == "running_var":
        _assign(stats, prefix + ["bn", "var"], v)
    else:
        raise KeyError(f"unknown bn leaf {leaf}")


def _assign(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def torch_state_dict_to_flax(sd):
    """The port's (or the reference's) canonical ``state_dict`` -> Flax
    ``{"params": ..., "batch_stats": ...}`` with numpy leaves. Aux heads
    and ``num_batches_tracked`` are skipped."""
    params: dict = {}
    stats: dict = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked") or key.startswith(("aux1.", "aux2.")):
            continue
        v = val.detach().cpu().numpy() if hasattr(val, "detach") else np.asarray(val)
        parts = key.split(".")
        if parts[0] == "fc":
            leaf = "kernel" if parts[1] == "weight" else "bias"
            _assign(params, ["fc", leaf], v.T if leaf == "kernel" else v)
            continue
        m = re.match(r"(inception\d[a-e])\.(branch\d(?:\.\d)?)\.(conv|bn)\.(.+)", key)
        if m:
            blk, branch, mod, leaf = m.groups()
            _route_convbn(params, stats, [blk, branch.replace(".", "_")],
                          mod, leaf, v)
            continue
        m = re.match(r"(conv\d)\.(conv|bn)\.(.+)", key)
        if m:
            blk, mod, leaf = m.groups()
            _route_convbn(params, stats, [blk], mod, leaf, v)
            continue
        raise KeyError(f"unrecognized torch key: {key}")
    return {"params": params, "batch_stats": stats}


def load_weights(path: str):
    """``.npz`` (flattened Flax tree) or ``.pt`` (torch state dict) ->
    the port's canonical ``state_dict``."""
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v for k, v in sd.items() if not k.startswith(("aux1.", "aux2."))}
    with np.load(path, allow_pickle=False) as flat:
        return flax_to_torch_state_dict({k: flat[k] for k in flat.files})


def save_weights(path: str, variables) -> None:
    """Flax variables tree -> flattened ``.npz`` (the JAX package's
    layout, readable by both packages)."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                flat["/".join(prefix + [k])] = np.asarray(v)

    walk(variables, [])
    np.savez(path, **flat)
