"""The pool-layout composite pair's host side, on the CPU: the rays a warp
its wrappers pick from the pool's rows a ray, the block count that sizes
the background gradient's scratch (with the library faked), the ablation
script's pooled variants, and the plain pooled route against the JAX
package's composite ops at the edge cases the kernels are held to on the
card (every ray one row, rays of 0 and 64 rows, runs of 31, 33, 1 rows
across chunks and groups, a budget-6 tile's survivors).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu.ops import volume as jvolume
from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.kernels import composite as kc
from learn_nerf_tpu_torch.scripts import composite_ablations

from .torch_helpers import t

torch.set_num_threads(1)

PATTERNS = {
    "ones": lambda rng, n, k: np.ones(n, np.int64),
    "0 and 64": lambda rng, n, k: np.resize([0, 64], n),
    "31, 33, 1": lambda rng, n, k: np.resize([31, 33, 1], n),
    "a tile's survivors": lambda rng, n, k: np.minimum(rng.binomial(192, 4.6 / 192, n), k),
}


@pytest.mark.parametrize("n,budget,rays", [
    (4096, 16, 1), (8192, 6, 4), (8192, 32, 1), (8192, 12, 2), (8192, 3, 8), (8192, 1, 16), (8192, 0, 32),
    (37, 64, 1), (1, 5, 4)])
def test_pooled_rays_per_warp_follow_the_rows_a_ray(n, budget, rays):
    """A warp a ray from the train step's budget 16 up (measured faster
    there), four rays at a budget-6 tile, more as the rays shorten."""
    assert kc.pooled_rays_per_warp(n, n * budget) == rays
    assert kc.pooled_blocks(n) == -(-n // kc.RAYS_PER_BLOCK)


def _pool(seed, n, k, rows, pattern=None, extras=3):
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, k + 1, n) if pattern is None else PATTERNS[pattern](rng, n, k)
    starts = np.concatenate([[0], np.minimum(np.cumsum(counts), rows)]).astype(np.int32)
    values = [(rng.uniform(0, 8, rows) * (rng.rand(rows) < 0.8)).astype(np.float32), starts,
              rng.uniform(0.05, 0.4, (n, 1)).astype(np.float32), rng.uniform(-1, 1, (rows, 3)).astype(np.float32),
              np.array([-1.0, 0.3, 1.0], np.float32), rng.rand(n) < 0.85,
              rng.uniform(-1, 1, (rows, extras)).astype(np.float32)]
    cotangents = [rng.randn(*s).astype(np.float32) for s in ((n, 3), (n, 1), (n, extras))]
    return values, cotangents


@pytest.fixture
def faked_library(monkeypatch):
    """The pool-layout wrappers on CPU tensors with the kernel library faked:
    each launch records its arguments and returns 0."""
    calls = []

    def record(name):
        def entry(*args):
            calls.append((name, args))
            return 0
        return entry

    monkeypatch.setattr(build, "_library", types.SimpleNamespace(
        nerf_composite_pooled_forward=record("forward"), nerf_composite_pooled_backward=record("backward"),
        nerf_error_string=lambda err: b"faked"))
    monkeypatch.setattr(kc, "_require_card", lambda device: None)
    monkeypatch.setattr(build, "current_stream", lambda device: 0)
    monkeypatch.setattr(kc, "_scratch", {})
    return calls


@pytest.mark.parametrize("n,k,rows", [(4096, 32, 4096 * 16), (8192, 32, 8192 * 6), (8195, 32, 8195 * 6),
                                      (37, 64, 140), (1, 5, 5)])
def test_pooled_launches_size_the_background_scratch_from_their_block_formula(faked_library, n, k, rows):
    """Both launches pass the rays a group of the wrappers' rule, and the
    backward's background scratch holds 3 floats for each of the
    pooled_blocks(n) blocks the kernel launches (a warp a ray, whatever the
    groups): no more, no fewer."""
    values, cotangents = _pool(n, n, k, rows)
    args = [t(v) for v in values]
    rays = kc.pooled_rays_per_warp(n, rows)
    kc.composite_pooled_forward_cuda(*args, k)
    kc.composite_pooled_backward_cuda(*args, k, *map(t, cotangents))
    (forward, f_args), (backward, b_args) = faked_library
    assert (forward, backward) == ("forward", "backward")
    assert f_args[7:12] == (n, k, 3, rows, rays) and b_args[10:15] == (n, k, 3, rows, rays)
    ticket, partials = kc._scratch[args[0].device]
    assert partials.numel() == 3 * kc.pooled_blocks(n) and ticket.numel() == 1
    assert b_args[18:20] == (partials.data_ptr(), ticket.data_ptr())


def test_pooled_launches_refuse_rays_a_warp_the_kernels_do_not_take(faked_library, monkeypatch):
    monkeypatch.setattr(kc, "pooled_rays_per_warp", lambda n, rows: 3)
    values, _ = _pool(0, 37, 6, 140)
    with pytest.raises(ValueError, match="rays a warp"):
        kc.composite_pooled_forward_cuda(*map(t, values), 6)
    assert not faked_library


def test_pooled_ablation_variants_apply_to_the_sources():
    """Each pooled variant's source is under csrc/, each of its edits finds
    its text there, and its rays a warp is one the kernels take."""
    for name, (source, edits, rays) in composite_ablations.POOLED_VARIANTS.items():
        text = (build.CSRC_DIR / source).read_text()
        for old, _ in edits:
            assert old in text, (name, old)
        assert rays is None or rays in kc.POOLED_RAYS_PER_WARP, name
    assert composite_ablations.POOLED_VARIANTS["parent"][0] == "ablations/composite_pooled_parent.cu"


def test_pooled_ablation_runs_tile_looks_like_a_served_frames():
    """The ablations' and chip_smoke's runs tile: a run of 36 rays in each
    image row of 256 own ~31 rows each, as the served frame's tiles do
    (1,153-1,170 of 8,192 rays, 30.4-30.9 rows), within the pool."""
    n, k, budget, mean, run = composite_ablations.POOLED_SHAPES["tile 8192 x 6 of 32, runs"]
    counts = composite_ablations.pool_counts(np.random.RandomState(0), n, k, mean, run)
    owning = counts > 0
    assert 1100 <= owning.sum() <= 1170 and 29 <= counts[owning].mean() <= 32 and counts.sum() <= n * budget
    assert (owning.reshape(-1, composite_ablations.IMAGE_SIDE).sum(axis=1) == run).all()


def test_pooled_ablations_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        composite_ablations.main(["--pooled"])


def _jax_dense(values, cotangents, k):
    """The pool gathered to [N, k] slots through the JAX package's
    termination_weights and composite, with its VJP: outputs, alphas,
    extras' blend, and the gradients of the densities, colours and extras
    scattered back to pool order."""
    densities, starts, deltas, rgbs, background, mask, extras = values
    n, rows = starts.shape[0] - 1, densities.shape[0]
    slot = np.arange(k)[None, :]
    valid = slot < (starts[1:] - starts[:-1])[:, None]
    index = np.where(valid, starts[:-1, None] + slot, 0)

    def gathered(v):
        return np.where(valid.reshape(n, k, *([1] * (v.ndim - 1))), v[index], 0.0).astype(np.float32)

    def blend(d, r, e):
        w = jvolume.termination_weights(d, jnp.broadcast_to(deltas, d.shape))
        return (jvolume.composite(w, r, background, mask), jvolume.composite_alpha(w, mask),
                jvolume.composite(w, e, jnp.zeros(e.shape[-1]), mask))

    outs, vjp = jax.vjp(blend, *map(jnp.asarray, (gathered(densities), gathered(rgbs), gathered(extras))))
    grads = vjp(tuple(map(jnp.asarray, cotangents)))

    def scattered(g, v):
        pool = np.zeros_like(v)
        np.add.at(pool, index[valid], np.asarray(g)[valid])
        return pool

    return [np.asarray(o) for o in outs], [scattered(g, v) for g, v in zip(grads, (densities, rgbs, extras))]


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_pooled_plain_route_matches_jax_at_the_edge_cases(pattern):
    n, k = 67, 64
    values, cotangents = _pool(len(pattern), n, k, n * 22, pattern)
    want, want_grads = _jax_dense(values, cotangents, k)
    args = [t(v) for v in values]
    leaves = [args[i].requires_grad_() for i in (0, 3, 6)]
    before = kc.pooled_counter.plain_calls
    outs = kc.render_composite_pooled(leaves[0], args[1], args[2], leaves[1], args[4], args[5], leaves[2], k)
    assert kc.pooled_counter.plain_calls == before + 1
    for out, ref in zip(outs, want):
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad(outs, leaves, list(map(t, cotangents)))
    tail = int(values[1][-1])
    for grad, ref in zip(grads, want_grads):
        np.testing.assert_allclose(grad.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=1e-5)
        assert not grad[tail:].any()
