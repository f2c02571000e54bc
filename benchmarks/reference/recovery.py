"""Plain reference of the asymmetric L2 recovery step on ConvNeXt with
DwSepRep's rank-1 strips (the ``L2Reconstruct`` step of
``configs/convnext/dw-sep-rep_r1_l2-asym_convnext-t.py``): the dense teacher
and the student share every weight but the depthwise convs, which the student
holds as rank-1 strips (each channel's k x k kernel cut to rank 1 by an SVD:
the (1, k) taps the first right singular vector, the (k, 1) taps the first
left one times its singular value, the bias kept).  The loss is the mean over
the batch of each sample's L2 norm of the student's minus the teacher's
depthwise output, averaged over the sites; the strips alone train, by AdamW
(decoupled weight decay, bias corrections ``1 - b^t``) at a constant rate.
"""

from __future__ import annotations

import torch

from yardstick.recipe import Rewrites

from . import convnext

B1, B2 = 0.9, 0.999


def student_strips(p: dict, model: dict) -> dict:
    """{block: (h, v, b)} of every block, as leaves that take gradients."""
    out = {}
    for s, depth in enumerate(model["depths"]):
        for i in range(depth):
            b = f"stages.{s}.{i}"
            u, sv, vh = torch.linalg.svd(p[f"{b}.dwconv.weight"][:, 0], full_matrices=False)
            out[b] = tuple(t.clone().requires_grad_(True) for t in (
                vh[:, 0, :], u[:, :, 0] * sv[:, :1], p[f"{b}.dwconv.bias"]))
    return out


def leaf_names(block: str):
    """The program's names of a block's three leaves: the strips and the bias."""
    pre = f"{block}.dwconv.new"
    return (f"{pre}.conv1.weight", f"{pre}.conv2.weight", f"{pre}.conv2.bias")


def loss(p: dict, sep: dict, x, model: dict):
    teacher, student = [], []
    with torch.no_grad():
        convnext.forward(p, x, model, Rewrites(), taps=teacher)
    convnext.forward(p, x, model, Rewrites(), sep=sep, taps=student)
    per_sample = sum(torch.linalg.vector_norm((a - b).flatten(1), dim=1)
                     for a, b in zip(student, teacher)) / len(student)
    return per_sample.mean()


def train(p: dict, model: dict, batches, lr: float, weight_decay: float, eps: float) -> dict:
    """Steps of AdamW on the strips, one per batch: each step's loss, the first
    step's gradient and the strips' change over the steps, by the program's
    leaf names."""
    sep = student_strips(p, model)
    start = {b: tuple(t.detach().clone() for t in ts) for b, ts in sep.items()}
    leaves = [t for ts in sep.values() for t in ts]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses, first = [], None
    for n, x in enumerate(batches, start=1):
        value = loss(p, sep, x, model)
        grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        if first is None:
            first = [g.clone() for g in grads]
        with torch.no_grad():
            for t, g, m, v in zip(leaves, grads, mu, nu):
                m.mul_(B1).add_(g, alpha=1 - B1)
                v.mul_(B2).add_(g * g, alpha=1 - B2)
                update = (m / (1 - B1 ** n)) / ((v / (1 - B2 ** n)).sqrt() + eps)
                t.sub_(lr * (update + weight_decay * t))
    names = [name for b in sep for name in leaf_names(b)]
    change = [t.detach() - s for ts, ss in zip(sep.values(), start.values())
              for t, s in zip(ts, ss)]
    return dict(losses=losses, grad=dict(zip(names, first)), change=dict(zip(names, change)))
