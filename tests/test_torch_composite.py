"""render_composite (scan, termination weights, the colour, coords and aux
blends) against learn_nerf_tpu's ``termination_weights`` / ``composite`` /
``composite_alpha`` / ``average_aux`` and their ``jax.vjp``, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py); here the
plain route is held to the JAX ops at 1e-5 for every cotangent, with one
bin width per ray or one per sample, with and without extras, and the
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
from learn_nerf_tpu_torch import render
from learn_nerf_tpu_torch.kernels import composite as kc

from .torch_helpers import t

torch.set_num_threads(1)

N = 37


def inputs(seed, n=N, k=8, per_sample=False, extras=0):
    """Rays of optical depth about 1-3 with padding slots (density 0), a few
    masked rays; bin widths per ray ``[N, 1]`` or per sample ``[N, K]``;
    ``extras`` columns of per-sample values (``None`` for 0)."""
    rng = np.random.RandomState(seed)
    densities = (rng.uniform(0, 12, (n, k)) * (rng.rand(n, k) < 0.8)).astype(np.float32)
    deltas = rng.uniform(0.5 / k, 4.0 / k, (n, k if per_sample else 1)).astype(np.float32)
    rgbs = rng.uniform(-1, 1, (n, k, 3)).astype(np.float32)
    background = np.array([-1.0, 0.3, 1.0], np.float32)
    mask = rng.rand(n) < 0.85
    values = rng.uniform(-1, 1, (n, k, extras)).astype(np.float32) if extras else None
    shapes = [(n, 3), (n, k + 1), (n, 1)] + ([(n, extras)] if extras else [])
    cotangents = [rng.randn(*s).astype(np.float32) for s in shapes]
    return (densities, deltas, rgbs, background, mask, values), cotangents


def jax_composite(densities, deltas, rgbs, background, mask, extras=None):
    weights = jvolume.termination_weights(densities, jnp.broadcast_to(deltas, densities.shape))
    outs = (jvolume.composite(weights, rgbs, background, mask), weights,
            jvolume.composite_alpha(weights, mask))
    if extras is None:
        return outs
    return (*outs, jvolume.composite(weights, extras, jnp.zeros(extras.shape[-1]), mask))


def closed_form_backward(densities, deltas, rgbs, background, mask, extras, g_out, g_w, g_alpha, g_ex=None):
    """The backward kernel's formula in NumPy (float64):
    ``dL/ds_t = G_t (T_t - w_t) - sum_{j>t} G_j w_j``; gradients of
    ``(densities, deltas, rgbs, background, extras)`` (deltas in their own
    shape, ``None`` for absent extras)."""
    f64 = lambda a: None if a is None else np.asarray(a, np.float64)  # noqa: E731
    densities, deltas, rgbs, background, extras = map(f64, (densities, deltas, rgbs, background, extras))
    g_out, g_w, g_alpha, g_ex = map(f64, (g_out, g_w, g_alpha, g_ex))
    n, k = densities.shape
    hit = mask[:, None]
    s = densities * deltas
    acc = np.cumsum(s, axis=1)
    trans = np.exp(-np.concatenate([np.zeros((n, 1)), acc], axis=1))  # T_0..T_K
    w = np.concatenate([trans[:, :-1] * (1 - np.exp(-s)), trans[:, -1:]], axis=1)
    big_g = g_w.copy()
    big_g[:, :k] += np.where(hit, np.einsum("nc,nkc->nk", g_out, rgbs), 0.0)
    if extras is not None and g_ex is not None:
        big_g[:, :k] += np.where(hit, np.einsum("nc,nkc->nk", g_ex, extras), 0.0)
    big_g[:, k] += np.where(mask, g_out @ background - g_alpha[:, 0], 0.0)
    gw = big_g * w
    suffix = np.cumsum(gw[:, ::-1], axis=1)[:, ::-1]  # sum_{j>=t}
    grad_s = big_g[:, :k] * (trans[:, :k] - w[:, :k]) - suffix[:, 1:]
    grad_deltas = grad_s * densities
    if deltas.shape[1] == 1:
        grad_deltas = grad_deltas.sum(axis=1, keepdims=True)
    grad_rgbs = np.where(hit[..., None], w[:, :k, None] * g_out[:, None, :], 0.0)
    grad_background = np.where(hit, w[:, k:] * g_out, g_out).sum(axis=0)
    grad_extras = None
    if extras is not None:
        g = np.zeros((n, extras.shape[-1])) if g_ex is None else g_ex
        grad_extras = np.where(hit[..., None], w[:, :k, None] * g[:, None, :], 0.0)
    return grad_s * deltas, grad_deltas, grad_rgbs, grad_background, grad_extras


def leaves_of(args):
    """The differentiable inputs (all but the mask) as leaves, and the mask."""
    leaves = [None if a is None else t(a).requires_grad_() for a in (*args[:4], args[5])]
    return leaves, t(args[4])


@pytest.mark.parametrize("extras", [0, 5])
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("k", [1, 8, 33, 64, 192])
def test_plain_route_matches_jax_forward_and_vjp(k, per_sample, extras):
    args, cotangents = inputs(k, k=k, per_sample=per_sample, extras=extras)
    jax_args = [jnp.asarray(a) for a in args if a is not None]
    ref, vjp = jax.vjp(lambda *a: jax_composite(*a[:4], jax_args[4], *a[4:]), *jax_args[:4], *jax_args[5:])
    ref_grads = vjp(tuple(jnp.asarray(c) for c in cotangents))

    leaves, mask = leaves_of(args)
    before = (kc.counter.plain_calls, kc.counter.launches)
    outs = kc.render_composite(*leaves[:4], mask, leaves[4])
    assert (kc.counter.plain_calls, kc.counter.launches) == (before[0] + 1, before[1])
    shapes = [(N, 3), (N, k + 1), (N, 1)] + ([(N, extras)] if extras else [])
    assert [tuple(o.shape) for o in outs if o is not None] == shapes
    assert (outs[3] is None) == (extras == 0)
    outs = [o for o in outs if o is not None]
    for out, want in zip(outs, ref):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(outs[1].detach().numpy().sum(axis=1), 1.0, atol=1e-5)
    masked = ~args[4]
    np.testing.assert_array_equal(outs[0].detach().numpy()[masked], np.tile(args[3], (masked.sum(), 1)))
    np.testing.assert_array_equal(outs[2].detach().numpy()[masked], 0.0)
    if extras:
        np.testing.assert_array_equal(outs[3].detach().numpy()[masked], 0.0)
    grads = torch.autograd.grad(outs, [v for v in leaves if v is not None], [t(c) for c in cotangents])
    assert grads[1].shape == leaves[1].shape
    for grad, want in zip(grads, ref_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(grad.numpy(), want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=1e-5)


@pytest.mark.parametrize("which", ["all", "outputs", "weights", "alphas", "extras", "per-sample widths"])
def test_closed_form_backward_equals_autograd(which):
    """Every cotangent on its own and all together (a missing one is zero),
    and per-sample widths."""
    args, cotangents = inputs(5, k=12, per_sample=which == "per-sample widths", extras=3)
    if which in ("outputs", "weights", "alphas", "extras"):
        index = ["outputs", "weights", "alphas", "extras"].index(which)
        cotangents = [c if i == index else np.zeros_like(c) for i, c in enumerate(cotangents)]
    leaves, mask = leaves_of(args)
    outs = kc.render_composite_reference(*leaves[:4], mask, leaves[4])
    grads = torch.autograd.grad(outs, leaves, [t(c) for c in cotangents])
    for grad, want in zip(grads, closed_form_backward(*args, *cotangents)):
        np.testing.assert_allclose(grad.numpy(), want, atol=2e-6 * max(1.0, np.abs(want).max()), rtol=1e-5)


def plain_launchers(monkeypatch, seen):
    """Swap plain versions in behind RenderComposite: the forward's outputs
    detached, the backward by the closed form."""

    def forward(densities, deltas, rgbs, background, mask, extras, per_sample):
        assert per_sample == (deltas.shape[1] > 1)
        outs = kc.render_composite_reference(densities, deltas, rgbs, background, mask, extras)
        return tuple(None if o is None else o.detach() for o in outs)

    def backward(densities, deltas, rgbs, background, mask, extras, per_sample, g_out, g_w, g_alpha, g_ex,
                 wanted):
        n, k = densities.shape
        seen["none"] = [g is None for g in (g_out, g_w, g_alpha, g_ex)]
        seen["wanted"] = wanted
        shapes = ((n, 3), (n, k + 1), (n, 1), (n, 0 if extras is None else extras.shape[-1]))
        filled = [np.zeros(s, np.float32) if g is None else g.numpy() for g, s in zip((g_out, g_w, g_alpha, g_ex), shapes)]
        grads = closed_form_backward(densities.numpy(), deltas.numpy(), rgbs.numpy(), background.numpy(),
                                     mask.numpy(), None if extras is None else extras.numpy(), *filled)
        grads = [None if g is None else t(np.asarray(g, np.float32)) for g in grads]
        return (grads[0], *(g if want else None for g, want in zip(grads[1:], wanted)))

    monkeypatch.setattr(kc, "_forward_launcher", forward)
    monkeypatch.setattr(kc, "_backward_launcher", backward)


@pytest.mark.parametrize("extras", [0, 4])
def test_autograd_function_with_plain_launchers(monkeypatch, extras):
    """RenderComposite's wiring, with the closed form as its backward:
    gradients for every input that needs one (never a detached result),
    None cotangents passed on as zero, no gradient for the mask or the
    widths (which come from the rays)."""
    args, cotangents = inputs(6, k=5, per_sample=bool(extras), extras=extras)
    seen = {}
    plain_launchers(monkeypatch, seen)
    leaves, mask = leaves_of(args)
    leaves[1].requires_grad_(False)
    outs = kc.RenderComposite.apply(*leaves[:4], mask, leaves[4])
    assert len(outs) == (4 if extras else 3) and all(o.grad_fn is not None for o in outs)
    loss = (outs[0] * t(cotangents[0])).sum() + (outs[2] * t(cotangents[2])).sum()
    if extras:
        loss = loss + (outs[3] * t(cotangents[3])).sum()
    loss.backward()
    assert seen["none"] == [False, True, False, not extras]
    assert seen["wanted"] == (False, True, True, bool(extras))
    assert leaves[1].grad is None
    ref_leaves, _ = leaves_of(args)
    ref = kc.render_composite_reference(*ref_leaves[:4], mask, ref_leaves[4])
    ref_loss = (ref[0] * t(cotangents[0])).sum() + (ref[2] * t(cotangents[2])).sum()
    if extras:
        ref_loss = ref_loss + (ref[3] * t(cotangents[3])).sum()
    ref_loss.backward()
    for i in (0, 2, 3) + ((4,) if extras else ()):
        torch.testing.assert_close(leaves[i].grad, ref_leaves[i].grad, atol=2e-6, rtol=1e-5)


def test_composite_samples_blends_coords_and_aux_as_the_jax_package():
    """The renderers' one call: coords and each aux mean from the extras,
    against the JAX package's ``composite`` of the points and
    ``average_aux``, values and gradients."""
    args, _ = inputs(8, k=16, per_sample=True)
    rng = np.random.RandomState(9)
    points = rng.uniform(-1, 1, (N, 16, 3)).astype(np.float32)
    aux = {"normal_mse": rng.rand(N, 16).astype(np.float32), "orientation": rng.rand(N, 16).astype(np.float32)}
    weights = jvolume.termination_weights(*map(jnp.asarray, args[:2]))
    mask = jnp.asarray(args[4])
    coords = jvolume.composite(weights, jnp.asarray(points), jnp.zeros(3), mask)
    means = jvolume.average_aux(weights, {k: jnp.asarray(v) for k, v in aux.items()}, mask)

    leaves = [t(a).requires_grad_() for a in args[:4]]
    aux_leaves = {k: t(v).requires_grad_() for k, v in aux.items()}
    outs = render.composite_samples(*leaves, t(args[4]), t(points), aux_leaves)
    np.testing.assert_allclose(outs[3].detach().numpy(), np.asarray(coords), atol=1e-5, rtol=1e-5)
    assert list(outs[4]) == list(aux)
    for name in aux:
        np.testing.assert_allclose(outs[4][name].item(), float(means[name]), atol=1e-6, rtol=1e-5)
    # The aux means' gradients reach the densities and the aux values.
    loss = outs[4]["normal_mse"] + 2 * outs[4]["orientation"]
    got = torch.autograd.grad(loss, [leaves[0], *aux_leaves.values()])

    def jax_loss(densities, a, b):
        w = jvolume.termination_weights(densities, jnp.asarray(args[1]))
        m = jvolume.average_aux(w, {"normal_mse": a, "orientation": b}, mask)
        return m["normal_mse"] + 2 * m["orientation"]

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(args[0]), *map(jnp.asarray, aux.values()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-5)


def test_wrapper_takes_views_and_full_tiles_and_refuses_32_bit_overflow():
    """Views that are not contiguous are copied once; a frame tile's
    8192 x 192 passes the 32-bit check, 2^24 rays x 128 samples do not
    (refused before anything is copied)."""
    n, k = 8192, 192
    one = torch.zeros(1)
    args = [one.expand(n, k), one.expand(n, k), one.expand(n, k, 3), torch.zeros(3),
            torch.ones(1, dtype=torch.bool).expand(n), one.expand(n, k, 3)]
    *prepared, per_sample = kc._prepared(*args)
    assert per_sample and all(p.is_contiguous() for p in prepared)
    assert [tuple(p.shape) for p in prepared] == [tuple(a.shape) for a in args]
    n, k = 1 << 24, 128
    big = [one.expand(n, k), one.expand(n, 1), one.expand(n, k, 3), torch.zeros(3),
           torch.ones(1, dtype=torch.bool).expand(n), None]
    with pytest.raises(ValueError, match="32-bit"):
        kc._prepared(*big)


@pytest.mark.parametrize("case", ["on the cpu", "k 0", "widths", "rgbs", "mask", "9 extras", "f64 extras", "cotangent"])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(case):
    args, cotangents = inputs(7, k=4, extras=3)
    cpu = [None if a is None else t(a) for a in args]
    if case == "k 0":
        cpu[0] = cpu[0][:, :0]
    elif case == "widths":
        cpu[1] = torch.ones(N, 2)
    elif case == "rgbs":
        cpu[2] = cpu[2][..., :2]
    elif case == "mask":
        cpu[4] = cpu[4].to(torch.uint8)
    elif case == "9 extras":
        cpu[5] = torch.zeros(N, 4, 9)
    elif case == "f64 extras":
        cpu[5] = cpu[5].double()
    message = {"on the cpu": "CUDA", "9 extras": "1 to 8 extras", "k 0": "K >= 1",
               "cotangent": "cotangent of outputs"}.get(case, "want [a-z]+ torch")
    with pytest.raises(ValueError, match=message):
        if case == "cotangent":
            kc.composite_backward_cuda(*cpu, t(cotangents[0][:, :2]), None, None)
        else:
            kc.composite_forward_cuda(*cpu)
    assert kc.MAX_EXTRAS == 8 and kc.RAYS_PER_BLOCK == 8
