"""Sharpness-Aware Minimization (SAM) training step in PyTorch.

Port of the JAX package's ``train/sam.py``. Reference usage
(cnn/training/experiment_script_all.py:325-367): SAM wrapping
SGD(momentum=0.9, weight_decay=5e-4) with rho=2.0, adaptive=True, two
forward/backward passes per step with BatchNorm running-stat updates only
on the first pass. The SAM update rule follows Foret et al. 2021 + the
ASAM elementwise scaling:

    eps  = rho * (|w|^2 * g if adaptive else g) / ||(|w| * g if adaptive else g)||_2
    step = inner_opt(grad at (w + eps))

The steps are plain functions over an ``nn.Module`` (a
:class:`~srcfinder_torch.models.googlenet.GoogLeNet` with aux heads), a
``torch.optim.SGD`` and a ``torch.Generator`` that draws the dropout
masks: fresh masks in each pass, as the JAX step's ``r1``/``r2``.

Data-parallel (:mod:`.ddp`): the model is a ``DistributedDataParallel``
and each call may pass ``group``, the process group over whose ranks the
global batch is split. The step is then the global batch's step, as the
JAX package's GSPMD step over a batch-sharded mesh: BatchNorm normalises
by the global batch (:func:`~srcfinder_torch.models.googlenet.cross_replica`),
each rank's loss is its share of the global weighted mean
(:func:`weighted_cross_entropy`), DDP averages the gradients, so SAM's
perturbation sees the global gradient on every rank, and the returned
loss is the global one. Without ``group`` (a batch the ranks do not
divide) every rank runs the whole batch, as the JAX step runs it
replicated.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch
import torch.nn.functional as F

from torch.nn.parallel import DistributedDataParallel

from ..models.googlenet import cross_replica, frozen_stats

__all__ = ["make_sam_train_step", "make_sgd_train_step", "make_inner_optimizer",
           "weighted_cross_entropy", "sam_perturbation", "step_lr"]


def weighted_cross_entropy(logits, labels, weights, group=None):
    """torch CrossEntropyLoss(weight=w) semantics: mean weighted by the
    per-sample class weight (sum w_yi * ce_i / sum w_yi).

    ``group``: the batch is split over this process group's N ranks, and
    the result is this rank's share N * sum_rank(w * ce) / sum_global(w):
    the mean over the ranks, which DDP's gradient average takes, is the
    global batch's weighted mean, whatever the class mix of each shard
    (a per-rank weighted mean would weigh the shards equally)."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels[:, None])[:, 0]
    w = weights[labels]
    if group is None:
        return (w * ce).sum() / w.sum()
    import torch.distributed as dist
    total = w.sum().detach().clone()
    dist.all_reduce(total, group=group)
    return dist.get_world_size(group) * (w * ce).sum() / total


@torch.no_grad()
def sam_perturbation(params, grads, rho: float, adaptive: bool):
    """The SAM ascent step eps for each parameter (davda54/sam first_step
    semantics: grad_norm over ALL params of (|w| if adaptive else 1)*g;
    eps = rho/(norm+1e-12) * (w^2 if adaptive else 1) * g). Multi-tensor
    (``_foreach``) ops: a few launches for all of GoogLeNet's ~360
    tensors, not a few for each."""
    params = [p.detach() for p in params]
    scaled = (torch._foreach_mul(torch._foreach_abs(params), grads) if adaptive
              else grads)
    grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(scaled)))
    scale = rho / (grad_norm + 1e-12)
    eps = (torch._foreach_mul(torch._foreach_mul(params, params), grads)
           if adaptive else list(grads))
    return torch._foreach_mul(eps, scale)


def make_inner_optimizer(params, momentum: float = 0.9, weight_decay: float = 5e-4):
    """SGD(momentum, weight_decay): decay added to the gradient before the
    momentum buffer, the buffer starting at the first gradient (the JAX
    package's optax ``add_decayed_weights`` -> ``sgd(momentum)``). The
    learning rate is set per step by the step functions."""
    return torch.optim.SGD(params, lr=1e-4, momentum=momentum,
                           weight_decay=weight_decay)


def step_lr(base_lr: float, total_epochs: int, epoch) -> float:
    """The SAM reference implementation's StepLR schedule used by the
    training script (experiment_script_all.py:340, scheduler(epoch)):
    base until 30% of epochs, then x0.2 at 30%/60%/80%. The epoch is
    compared with the milestones in f32, as the JAX package's schedule
    does (at 100 epochs 0.3 * 100 is 30.000000000000004, 30 in f32); the
    rate comes back as a Python float, which an f32 model's SGD applies as
    the JAX package's f32 rate."""
    e = np.float32(epoch)
    t = float(total_epochs)
    if e < np.float32(0.3 * t):
        return base_lr
    if e < np.float32(0.6 * t):
        return base_lr * 0.2
    if e < np.float32(0.8 * t):
        return base_lr * 0.2 ** 2
    return base_lr * 0.2 ** 3


def _trainable(model):
    return [p for p in model.parameters() if p.requires_grad]


def _loss_and_grads(model, params, images, labels, weights, generator,
                    aux_weight: float, group=None):
    """Weighted CE of the train-mode forward (plus ``aux_weight`` times
    the aux heads' CE, where the model returns ``(logits, aux2, aux1)``)
    and its gradient for every parameter: a zero gradient where autograd
    gives none (the aux heads at ``aux_weight`` 0), so that weight decay
    and momentum reach them as in the JAX step. A
    ``DistributedDataParallel`` model's gradients are DDP's averages over
    the ranks, and its loss the global batch's (``group``: see the module
    docstring)."""
    # the global BatchNorm only where the batch is split (the context walks
    # every module: ~0.5 ms of host time a pass)
    with cross_replica(model, group) if group is not None else nullcontext():
        out = model(images, generator=generator)
    logits, aux2, aux1 = out if isinstance(out, tuple) else (out, None, None)
    loss = weighted_cross_entropy(logits, labels, weights, group)
    if aux_weight > 0.0:
        loss = loss + aux_weight * (weighted_cross_entropy(aux2, labels, weights, group)
                                    + weighted_cross_entropy(aux1, labels, weights, group))
    if not isinstance(model, DistributedDataParallel):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]
    if aux2 is not None and aux_weight == 0.0:
        # DDP reduces a gradient for every parameter the forward reached:
        # the aux heads get their zero gradient from the loss itself
        loss = loss + 0.0 * (aux2.sum() + aux1.sum())
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    for p in params:
        p.grad = None
    loss = loss.detach()
    if group is not None:
        import torch.distributed as dist
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
    return loss, grads


def _apply(optimizer, params, grads, lr: float):
    for p, g in zip(params, grads):
        p.grad = g
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    for p in params:
        p.grad = None


def make_sam_train_step(model, optimizer, weights, rho: float = 2.0,
                        adaptive: bool = True, aux_weight: float = 0.0):
    """SAM two-pass step. ``weights``: (num_classes,) CE class weights.
    Returns step(images NCHW, labels, lr, generator, group=None) -> loss (a
    0-d tensor on the model's device; ``group``: see the module docstring). ``model`` (in train mode, aux heads on) and
    ``optimizer`` are updated in place. The first pass updates the
    BatchNorm running stats, the second normalises with its own batch
    statistics and does not (reference: experiment_script_all.py:356-367)."""
    params = _trainable(model)
    saved = [torch.empty_like(p) for p in params]

    def step(images, labels, lr, generator=None, group=None):
        loss, grads = _loss_and_grads(model, params, images, labels, weights,
                                      generator, aux_weight, group)
        eps = sam_perturbation(params, grads, rho, adaptive)
        with torch.no_grad():
            torch._foreach_copy_(saved, params)
            torch._foreach_add_(params, eps)
        with frozen_stats(model):
            _, grads2 = _loss_and_grads(model, params, images, labels, weights,
                                        generator, aux_weight, group)
        with torch.no_grad():
            torch._foreach_copy_(params, saved)
        _apply(optimizer, params, grads2, lr)
        return loss

    return step


def make_sgd_train_step(model, optimizer, weights, aux_weight: float = 0.0):
    """Plain SGD step (reference --no-sam path,
    experiment_script_all.py:368-374); the same signature as the SAM
    step's."""
    params = _trainable(model)

    def step(images, labels, lr, generator=None, group=None):
        loss, grads = _loss_and_grads(model, params, images, labels, weights,
                                      generator, aux_weight, group)
        _apply(optimizer, params, grads, lr)
        return loss

    return step
