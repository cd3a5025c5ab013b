"""render_composite (scan, termination weights, blend) against
learn_nerf_tpu's ``termination_weights`` / ``composite`` /
``composite_alpha`` and their ``jax.vjp``, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py); here the
plain route is held to the JAX ops at 1e-6 for all three cotangents, and the
backward kernel's closed form, written out in NumPy, is held to autograd:
so the kernel's mathematics is pinned where no card is.  The autograd
function itself runs with plain launchers swapped in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu.ops import volume as jvolume
from learn_nerf_tpu_torch.kernels import composite as kc

from .torch_helpers import t

torch.set_num_threads(1)


def inputs(seed, n=37, k=8):
    """Rays of optical depth about 1-3 with padding slots (density 0) and a
    few masked rays."""
    rng = np.random.RandomState(seed)
    densities = (rng.uniform(0, 12, (n, k)) * (rng.rand(n, k) < 0.8)).astype(np.float32)
    dt = rng.uniform(0.5 / k, 4.0 / k, (n, 1)).astype(np.float32)
    rgbs = rng.uniform(-1, 1, (n, k, 3)).astype(np.float32)
    background = np.array([-1.0, 0.3, 1.0], np.float32)
    mask = rng.rand(n) < 0.85
    cotangents = [rng.randn(*s).astype(np.float32) for s in ((n, 3), (n, k + 1), (n, 1))]
    return (densities, dt, rgbs, background, mask), cotangents


def jax_composite(densities, dt, rgbs, background, mask):
    weights = jvolume.termination_weights(densities, jnp.broadcast_to(dt, densities.shape))
    return (jvolume.composite(weights, rgbs, background, mask), weights,
            jvolume.composite_alpha(weights, mask))


def closed_form_backward(densities, dt, rgbs, background, mask, g_out, g_w, g_alpha):
    """The backward kernel's formula in NumPy (float64):
    ``dL/ds_t = G_t (T_t - w_t) - sum_{j>t} G_j w_j``."""
    densities, dt, rgbs, background = (np.asarray(a, np.float64) for a in (densities, dt, rgbs, background))
    g_out, g_w, g_alpha = (np.asarray(a, np.float64) for a in (g_out, g_w, g_alpha))
    n, k = densities.shape
    hit = mask[:, None]
    s = densities * dt
    acc = np.cumsum(s, axis=1)
    trans = np.exp(-np.concatenate([np.zeros((n, 1)), acc], axis=1))  # T_0..T_K
    w = np.concatenate([trans[:, :-1] * (1 - np.exp(-s)), trans[:, -1:]], axis=1)
    big_g = g_w.copy()
    big_g[:, :k] += np.where(hit, np.einsum("nc,nkc->nk", g_out, rgbs), 0.0)
    big_g[:, k] += np.where(mask, g_out @ background - g_alpha[:, 0], 0.0)
    gw = big_g * w
    suffix = np.cumsum(gw[:, ::-1], axis=1)[:, ::-1]  # sum_{j>=t}
    grad_s = big_g[:, :k] * (trans[:, :k] - w[:, :k]) - suffix[:, 1:]
    grad_rgbs = np.where(hit[..., None], w[:, :k, None] * g_out[:, None, :], 0.0)
    grad_background = np.where(hit, w[:, k:] * g_out, g_out).sum(axis=0)
    return grad_s * dt, (grad_s * densities).sum(axis=1, keepdims=True), grad_rgbs, grad_background


@pytest.mark.parametrize("k", [1, 8, 33])
def test_plain_route_matches_jax_forward_and_vjp(k):
    args, cotangents = inputs(k, k=k)
    ref, vjp = jax.vjp(jax_composite, *(jnp.asarray(a) for a in args[:4]), jnp.asarray(args[4]))
    ref_grads = vjp(tuple(jnp.asarray(c) for c in cotangents))[:4]

    leaves = [t(a).requires_grad_() for a in args[:4]]
    before = (kc.counter.plain_calls, kc.counter.launches)
    outs = kc.render_composite(*leaves, t(args[4]))
    assert (kc.counter.plain_calls, kc.counter.launches) == (before[0] + 1, before[1])
    assert [tuple(o.shape) for o in outs] == [(37, 3), (37, k + 1), (37, 1)]
    for out, want in zip(outs, ref):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(outs[1].detach().numpy().sum(axis=1), 1.0, atol=1e-6)
    masked = ~args[4]
    np.testing.assert_array_equal(outs[0].detach().numpy()[masked], np.tile(args[3], (masked.sum(), 1)))
    np.testing.assert_array_equal(outs[2].detach().numpy()[masked], 0.0)
    grads = torch.autograd.grad(outs, leaves, [t(c) for c in cotangents])
    for grad, want in zip(grads, ref_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(grad.numpy(), want, atol=1e-6 * max(1.0, np.abs(want).max()), rtol=1e-5)


@pytest.mark.parametrize("which", ["all", "outputs", "weights", "alphas"])
def test_closed_form_backward_equals_autograd(which):
    """Every cotangent on its own and all together (a missing one is zero)."""
    args, cotangents = inputs(5, k=12)
    if which != "all":
        index = ["outputs", "weights", "alphas"].index(which)
        cotangents = [c if i == index else np.zeros_like(c) for i, c in enumerate(cotangents)]
    leaves = [t(a).requires_grad_() for a in args[:4]]
    outs = kc.render_composite_reference(*leaves, t(args[4]))
    grads = torch.autograd.grad(outs, leaves, [t(c) for c in cotangents])
    for grad, want in zip(grads, closed_form_backward(*args, *cotangents)):
        np.testing.assert_allclose(grad.numpy(), want, atol=2e-6 * max(1.0, np.abs(want).max()), rtol=1e-5)


def test_autograd_function_with_plain_launchers(monkeypatch):
    """RenderComposite's wiring, with the closed form as its backward:
    gradients for every input that needs one, None cotangents passed on as
    zero, no gradient for the mask."""
    args, cotangents = inputs(6, k=5)
    seen = {}

    def forward(densities, dt, rgbs, background, mask):
        return tuple(o.detach() for o in kc.render_composite_reference(densities, dt, rgbs, background, mask))

    def backward(densities, dt, rgbs, background, mask, g_out, g_w, g_alpha):
        seen["none"] = [g is None for g in (g_out, g_w, g_alpha)]
        filled = [np.zeros(s, np.float32) if g is None else g.numpy()
                  for g, s in zip((g_out, g_w, g_alpha), ((37, 3), (37, 6), (37, 1)))]
        grads = closed_form_backward(densities.numpy(), dt.numpy(), rgbs.numpy(), background.numpy(),
                                     mask.numpy(), *filled)
        return tuple(t(np.asarray(g, np.float32)) for g in grads)

    monkeypatch.setattr(kc, "_forward_launcher", forward)
    monkeypatch.setattr(kc, "_backward_launcher", backward)
    leaves = [t(a).requires_grad_() for a in args[:4]]
    leaves[1].requires_grad_(False)  # dt comes from the rays: no gradient asked
    outs = kc.RenderComposite.apply(*leaves, t(args[4]))
    loss = (outs[0] * t(cotangents[0])).sum() + (outs[2] * t(cotangents[2])).sum()
    loss.backward()
    assert seen["none"] == [False, True, False]
    assert leaves[1].grad is None
    ref_leaves = [t(a).requires_grad_() for a in args[:4]]
    ref = kc.render_composite_reference(*ref_leaves, t(args[4]))
    ((ref[0] * t(cotangents[0])).sum() + (ref[2] * t(cotangents[2])).sum()).backward()
    for i in (0, 2, 3):
        torch.testing.assert_close(leaves[i].grad, ref_leaves[i].grad, atol=2e-6, rtol=1e-5)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    args, _ = inputs(7, k=4)
    cpu = [t(a) for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        kc.composite_forward_cuda(*cpu)
    assert kc.MAX_SAMPLES == 64
