"""Device meshes and sharded runs.

Port of the JAX package's ``parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` and XLA partitions each call; here a mesh is an
ordered list of ``torch.device``s, and a sharded call runs one callable
per shard, one thread per shard (torch's own idiom for multi-device
inference, as ``torch.nn.parallel.parallel_apply``), then gathers the
shards' results in order onto the caller's device: one call in, one
result out. The sharded work needs no collectives: the CMF's columns,
the FCN's shifts and phase maps and the exact CNN's windows are
independent of each other (reference: the ``nn.DataParallel`` at
cnn/cnn_pred_pipeline.py:113-116 and fcn_pred_pipeline.py:162-165).

A mesh may name one device more than once: ``["cpu"] * 8`` stands for the
JAX tests' 8 virtual CPU devices, and ``["cuda:0"] * 4`` runs four shards
on one card, each with its own working set at once.
"""

from __future__ import annotations

import copy
import threading
from contextlib import nullcontext

import torch

from ..device import resolve_device

__all__ = ["make_mesh", "as_mesh", "column_ranges", "batch_ranges", "replicate",
           "run_shards", "gather", "shard_columns_mf", "shard_fcn_shifts"]


def make_mesh(n_devices: int | None = None, device="cuda") -> list:
    """The first ``n_devices`` devices of kind ``device``.

    ``device="cuda"``: cards 0..n-1 (all cards when ``n_devices`` is
    None); raises when there are fewer than ``n_devices`` cards, and never
    shrinks the mesh or falls back to the CPU. ``device="cpu"``: the CPU
    ``n_devices`` times (once when None). A list of devices is validated
    and returned as given, repeats included.
    """
    if isinstance(device, (list, tuple)):
        mesh = as_mesh(device)
        if n_devices is not None and n_devices != len(mesh):
            raise ValueError(f"n_devices={n_devices} but {len(mesh)} devices given")
        return mesh
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n_devices is None else n_devices)
    if dev.index is not None:
        raise ValueError(f"make_mesh takes 'cuda' or a list of devices, not {device!r}")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise RuntimeError(f"a mesh of {n} cards needs {n} CUDA devices; "
                           f"{count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def as_mesh(mesh) -> list:
    """``mesh`` (devices or their names) as a list of ``torch.device``s,
    each validated: a CUDA device must exist."""
    out = []
    for d in mesh:
        dev = resolve_device(d)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0 if dev.index is None else dev.index)
            if dev.index >= torch.cuda.device_count():
                raise RuntimeError(f"{dev} does not exist: "
                                   f"{torch.cuda.device_count()} CUDA devices")
        out.append(dev)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def column_ranges(n: int, shards: int) -> list:
    """Contiguous ``(start, stop)`` ranges of ``n`` items over ``shards``
    shards, ``torch.tensor_split``'s: the first ``n % shards`` ranges are
    one longer, and ranges past ``n`` are empty."""
    q, r = divmod(n, shards)
    bounds = [0]
    for i in range(shards):
        bounds.append(bounds[-1] + q + (i < r))
    return list(zip(bounds[:-1], bounds[1:]))


batch_ranges = column_ranges


def replicate(value, mesh) -> dict:
    """``{device: value_on(device)}`` for each distinct device of the mesh:
    ``value`` is a module (deep-copied onto each other device; the same
    object where it already lies), a tensor (``.to``) or a callable
    ``device -> value``."""
    out = {}
    for dev in mesh:
        if dev in out:
            continue
        if isinstance(value, torch.nn.Module):
            here = next(value.parameters()).device
            out[dev] = value if here == dev else copy.deepcopy(value).to(dev)
        elif isinstance(value, torch.Tensor):
            out[dev] = value.to(dev)
        else:
            out[dev] = value(dev)
    return out


def run_shards(mesh, fn, n_shards: int | None = None) -> list:
    """``[fn(i, mesh[i]) for i in range(n_shards)]``, each call in a thread
    of its own with ``mesh[i]`` as its current CUDA device, under the
    caller's grad and inference modes (both are per thread in torch).
    ``n_shards`` defaults to the mesh's size. Re-raises the first shard's
    exception, if any, after every thread has ended."""
    mesh = as_mesh(mesh)
    n = len(mesh) if n_shards is None else n_shards
    results, errors = [None] * n, [None] * n
    grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()

    def work(i):
        dev = mesh[i]
        try:
            with torch.inference_mode(inference), torch.set_grad_enabled(grad), \
                    (torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()):
                results[i] = fn(i, dev)
        except BaseException as e:              # re-raised by the caller
            errors[i] = e

    if n == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for e in errors:
        if e is not None:
            raise e
    return results


def gather(parts, device, dim: int = 0):
    """The shards' tensors concatenated along ``dim`` on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


#: the column axis of each field of the CMF results (MFResult,
#: MFMultimodalResult)
_MF_COLUMN_AXIS = {"mf": 1, "alpha_index": 0, "nll": 0, "mu": 0, "n": 0, "cond": 0,
                   "valid": 1, "labels": 1, "alpha_pix": 1, "rejected": 0, "counts": 0}


def shard_columns_mf(mesh, x, m, abscf, alphas, **kwargs):
    """:func:`~srcfinder_torch.cmf.matched_filter.matched_filter_columns`
    with the detector-column axis split over the mesh (contiguous ranges,
    ``C`` need not divide): each range runs on its shard's device, so K1,
    ``eigh`` and K2 run per card; ``bgmodes=K`` runs
    :func:`~srcfinder_torch.cmf.matched_filter.matched_filter_columns_multimodal`
    instead. Column-indexed keywords (``T``, ``n_loo``, ``init_index``) are
    split with the columns. The multimodal k-means++ seeds come from
    uniforms drawn for all columns at once on the first shard's device (as
    the single-device call draws them), so the sharded labels equal the
    single-device labels for the same ``seed``. Results are gathered onto
    ``x``'s device, in the single call's result type.
    """
    from ..cmf.kmeans import kpp_uniforms
    from ..cmf.matched_filter import (matched_filter_columns,
                                      matched_filter_columns_multimodal)

    mesh = as_mesh(mesh)
    L, C, _ = x.shape
    ranges = [r for r in column_ranges(C, len(mesh)) if r[1] > r[0]]
    bgmodes = kwargs.get("bgmodes")
    if bgmodes:
        fn = matched_filter_columns_multimodal
        if kwargs.get("init_index") is None and kwargs.get("uniforms") is None:
            kwargs["uniforms"] = kpp_uniforms(L, C, bgmodes, kwargs.get("seed", 0),
                                              x.dtype, mesh[0])
    else:
        kwargs.pop("bgmodes", None)
        fn = matched_filter_columns
    abscfs, alphass = replicate(abscf, mesh), replicate(alphas, mesh)

    def shard(i, dev):
        c0, c1 = ranges[i]
        kw = dict(kwargs)
        for k in ("T", "n_loo", "init_index"):              # (C, ...) keywords
            if kw.get(k) is not None:
                kw[k] = torch.as_tensor(kw[k])[c0:c1].to(dev)
        if kw.get("uniforms") is not None:                    # (K, L, C)
            kw["uniforms"] = kw["uniforms"][:, :, c0:c1].to(dev)
        return fn(x[:, c0:c1].to(dev), m[:, c0:c1].to(dev), abscfs[dev], alphass[dev], **kw)

    parts = run_shards(mesh, shard, len(ranges))
    out_type = type(parts[0])
    return out_type(**{f: gather([getattr(p, f) for p in parts], x.device,
                                 _MF_COLUMN_AXIS[f]) for f in out_type._fields})


def shard_fcn_shifts(mesh, model, img, scale: int = 32, batch: int = 16):
    """FCN shift-and-stitch with each chunk of ``batch`` shifts split over
    the mesh (the JAX package's ``shard_fcn_shifts``): the canvas and the
    model replicate, each shard runs its shifts' forwards on its device,
    and the stitch runs on ``img``'s device over the gathered outputs."""
    from ..detect.fcn_pipeline import _canvas, _shift_probs, stitch_stack

    mesh = as_mesh(mesh)
    models = replicate(model, mesh)
    canvases = replicate(_canvas(img, scale), mesh)
    nshift = scale * scale
    outs = []
    with torch.inference_mode():
        for i in range(0, nshift, batch):
            ranges = [r for r in batch_ranges(min(batch, nshift - i), len(mesh))
                      if r[1] > r[0]]
            parts = run_shards(mesh, lambda k, dev: _shift_probs(
                models[dev], canvases[dev], scale, range(i + ranges[k][0], i + ranges[k][1])),
                len(ranges))
            outs.append(gather(parts, img.device))
        return stitch_stack(tuple(img.shape), torch.cat(outs, dim=0), scale)
