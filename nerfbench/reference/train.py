"""The train cells' first steps, as plain PyTorch: the loss of each step,
its gradients by autograd and Adam (``torch.optim.Adam``'s update, written
out), from the initial parameters the harness made and the batches the
window's feed served.

Both losses are the mean squared error of the rendered colours against
the batch's targets (the hierarchy sums its coarse and fine terms); the
occupancy path renders with :func:`~.render.render_occupancy`, the
hierarchy with :func:`~.render.render_hierarchy`.  A field whose file
(``reference/fields/<field>.py``) defines ``step_loss`` trains on that in
their place.  Leaves are named
``<model>.<parameter>`` and ``background`` (the trained background
colour, which the composite blends).
"""

from typing import Dict, List

import torch

from . import draws
from . import fields
from .precision import matmul_at
from .render import render_hierarchy, render_occupancy

Tensor = torch.Tensor


def step_loss(kind: str, cfg: dict, leaves: Dict[str, Tensor], batch: Tensor, uniforms: List[Tensor],
              grid: dict, matmul, half_batch: bool = False) -> Tensor:
    """One step's loss on ``batch [N, 3, 3]``; ``half_batch`` (a planted
    fault) leaves out the second half of the rows."""
    if half_batch:
        n = batch.shape[0] // 2
        batch, uniforms = batch[:n], [u[:n] for u in uniforms]
    field = fields.load(cfg["field"]).field
    model = lambda prefix: (lambda x, d: field({k[len(prefix) + 1:]: v for k, v in leaves.items()  # noqa: E731
                                                if k.startswith(prefix + ".")}, cfg, x, d, matmul))
    rays, targets = batch[:, :2], batch[:, 2]
    background = leaves["background"]
    if kind == "occupancy":
        rgb = render_occupancy(model("fine"), rays, uniforms[0], grid["densities"], grid, cfg["samples"],
                               background)
        return ((rgb - targets) ** 2).mean()
    rgb_c, rgb_f = render_hierarchy(model("coarse"), model("fine"), rays, uniforms[0], uniforms[1], cfg, background)
    return ((rgb_c - targets) ** 2).mean() + ((rgb_f - targets) ** 2).mean()


def reference_steps(kind: str, cfg: dict, initial: Dict[str, Tensor], batches: List[Tensor], base_seed: int,
                    grid: dict, precision: str = "float32", half_batch: bool = False) -> dict:
    """``len(batches)`` steps from ``initial``: ``losses`` (one a step),
    ``grad_norms`` (each leaf's first gradient's norm) and ``change_norms``
    (each leaf's change after the steps)."""
    matmul = matmul_at(precision)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in initial.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    b1, b2, eps, lr = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"], cfg["lr"]
    widths = [cfg["candidates"]] if kind == "occupancy" else [cfg["coarse_samples"], cfg["fine_samples"]]
    loss_of = getattr(fields.load(cfg["field"]), "step_loss", step_loss)
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches):
        uniforms = draws.train_uniforms(base_seed, step, widths, batch.shape[0], batch.device)
        loss = loss_of(kind, cfg, leaves, batch, uniforms, grid, matmul, half_batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            t = step + 1
            for (name, p), g in zip(leaves.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                if step == 0:
                    grad_norms[name] = float(torch.linalg.vector_norm(g))
                m[name].mul_(b1).add_(g, alpha=1 - b1)
                v2[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v2[name].sqrt() / (1 - b2**t) ** 0.5 + eps
                p.sub_(lr / (1 - b1**t) * m[name] / denom)
        del grads, loss
    change = {k: float(torch.linalg.vector_norm(leaves[k].detach() - initial[k])) for k in leaves}
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change)
