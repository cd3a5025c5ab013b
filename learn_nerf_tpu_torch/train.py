"""Training: the losses, the gradient step and the two stateful loops
(port of ``learn_nerf_tpu.train``): :class:`TrainLoop` over the coarse/fine
hierarchy, and :class:`OccupancyTrainLoop` on the occupancy-grid fast path.

Loss contract of the JAX package: ``MSE(coarse) + MSE(fine)`` (the
occupancy path: ``MSE(fine)``) ``+ sum of weighted aux losses`` with
default weights ``normal_mse=3e-4, neg_normal=0.1``, plus an optional
mean-density penalty at uniform random bbox points; the logged dict carries
the per-term losses under the ``coarse`` / ``fine`` prefixes plus
``grad_norm`` and ``param_norm``.  The optimizer is Adam in optax's form
(``m_hat / (sqrt(v_hat) + eps)``, which ``torch.optim.Adam`` shares), and
both loops take the one gradient step of :func:`grad_step`.

Where the JAX package threads a parameter tree through pure functions, the
port's field models own their parameters; a loop trains its models' (by
checkpoint key, ``coarse`` and ``fine``; the occupancy loop has no coarse
model) and the background ``[3]``.
Where it folds PRNG keys inside the jitted step, the port seeds one
generator per step from ``(base seed, tag, step)`` (:func:`fold_seed`), so
a resumed run draws what an unbroken one would.  Every draw can also be
given explicitly (``u_coarse=``, ``u_fine=``, ``u=``, ``density_draws=``,
``grid_ids=``, ``grid_jitter=``), which is how the parity tests feed both
packages the same numbers.

On the card both loops' ``step_auto`` and ``step_auto_many`` replay a
captured CUDA graph of the step (:mod:`.step_graph`): a host prologue (the
occupancy loop's grid refresh when due, the step's draws into static
buffers, the batch copied into its buffer), one replay of the body (the
loss, its gradients and the norms), then Adam and the EMA, eagerly, as on
every route.  The loops stay eager under a process group, in ``step()``
with the caller's draws (the reference route the graph is held against)
and on the CPU (the same prologue, the body run eagerly).

On the card the hierarchy's step runs the composite kernels, forward and
backward, once a pass (:mod:`.kernels.composite`), and with Instant-NGP
models the all-level hash-grid encode and its table-gradient kernel once a
model (through :class:`~.kernels.hashgrid_encode.HashGridEncode`).  The
occupancy step runs the same kernels once (a pooled step runs the
composite pair in the pool's layout).  A bf16 vanilla model trains on its
flax-rounded route (:meth:`~.models.vanilla.NeRFModel.set_bf16_route`, which
the loops select), whose products are plain ``torch`` matmuls.  The Ref-NeRF
models (``models.ref_nerf``, no subclasses of ``NeRFModel``, always f32)
train through the same losses with their aux terms; the hybrid's step also
runs the kernel of the encoding's gradient in the points and its backward
once a model (:mod:`.kernels.hashgrid_dx`).

Pooled training (``pool_budget_per_ray``, the JAX package's flagship
``--occ_train_budget auto``): from ``pool_start_step`` on, each step packs
the batch's survivors into one pool of ``batch * budget`` samples, so the
field model runs on the samples that exist (:func:`compute_losses_occupancy_pooled`).
Where the JAX loop draws the auto budget's demand batch with
``fold_in(PRNGKey(17), host step)``, the port seeds a generator with
``fold_seed(17, 0, host step)``.

Both loops write the params pickle both packages read (:meth:`save`) and
the port's own full train state (:meth:`save_full`, the format of
:func:`~.checkpoint.save_train_state`).

Data parallelism (``mesh=``, a :class:`~.parallel.mesh.Mesh` of one card
and the process group): each rank trains on its own rows of the global
batch, and the step equals the JAX step on the global batch with
replicated parameters.  The parameters and the background are broadcast
from rank 0 at construction and after a load; after ``backward()`` one
coalesced all-reduce averages every gradient (one explicit reduce feeding
Adam, where ``DistributedDataParallel`` would hook only the models'
forwards: the loops also call their models for the grid refresh, the
demand measure and the density penalty); one more averages the logged
values (``fine_pool_dropped`` is summed), so every rank logs the global
ones.  Each stratified draw the generator makes is drawn for the global
batch and cut to the rank's rows, and the draws that do not depend on the
batch (the density penalty, the grid refresh) are the same on every rank,
so parameters and grids stay bit-equal across ranks.  The auto pool
budget averages its measured demand over the ranks, so all pick one
bucket; a pooled step pools ``n * budget`` samples a rank, which equals
the JAX package's global pool whenever nothing is dropped (when samples
are dropped, each rank drops its own trailing rays, not the global
batch's).  Rank 0 alone writes checkpoints, then every rank passes a
barrier.
"""

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .acceleration import OccupancyGrid, OccupancyGridState, StaticGridState, auto_budget_from_demand, bbox_tensors
from .checkpoint import (
    checkpoint_from_flax,
    checkpoint_to_flax,
    load_params_pickle,
    load_train_state,
    save_params_pickle,
    save_train_state,
)
from .models.base import FieldModel
from .models.vanilla import NeRFModel
from .occ_render import OccupancyRenderer
from .ops.sampling import uniform
from .parallel.mesh import Mesh, all_reduce_mean_, barrier, broadcast_, reduce_values, shard_batch
from .render import Renderer
from .step_graph import step_graphs

Tensor = torch.Tensor
Schedule = Callable[[int], float]

# Stream tags of step_auto's per-step seeds (the JAX loop folds the same
# two tags into its base key), and the base seed of the auto pool budget's
# demand draws (the JAX loop's PRNGKey(17)).
TRAIN_TAG, GRID_TAG = 0, 1
DEMAND_SEED = 17


def default_loss_weights() -> Dict[str, float]:
    return dict(normal_mse=3e-4, neg_normal=0.1)


def tree_norm(tensors: Iterable[Tensor]) -> Tensor:
    """L2 norm over all elements of all tensors (0-dim)."""
    tensors = [t.detach() for t in tensors]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``: from ``init_value`` down to
    ``alpha * init_value`` over ``decay_steps`` optimizer steps, flat after."""
    if decay_steps <= 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(max(count, 0), decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha)

    return schedule


def fold_seed(base_seed: int, tag: int, step: int) -> int:
    """A 63-bit generator seed from ``(base seed, stream tag, step)``: a
    pure function of its arguments (splitmix64's finalizer over the three),
    so a resumed run continues the stream of an unbroken one."""
    mask = (1 << 64) - 1
    z = (base_seed * 0x9E3779B97F4A7C15 + tag * 0xD1B54A32D192ED03 + step * 0x94D049BB133111EB) & mask
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    return (z ^ (z >> 31)) >> 1


def average_density(
    model: FieldModel,
    bbox_min: Tensor,
    bbox_max: Tensor,
    batch_size: int,
    coords_u: Optional[Tensor] = None,
    dirs_normal: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Mean model density at uniform random points in the bbox.

    The JAX function reuses ONE key for the uniform coordinates and the
    normal directions; here both draws are arguments.

    :param coords_u: optional ``[batch_size, 3]`` uniforms in ``[0, 1)``.
    :param dirs_normal: optional ``[batch_size, 3]`` standard normals.
    """
    device = bbox_min.device
    if coords_u is None:
        coords_u = torch.rand((batch_size, 3), generator=generator, device=device)
    if dirs_normal is None:
        dirs_normal = torch.randn((batch_size, 3), generator=generator, device=device)
    coords = coords_u * (bbox_max - bbox_min) + bbox_min
    dirs = dirs_normal / torch.linalg.vector_norm(dirs_normal, dim=-1, keepdim=True)
    densities, _, _ = model(coords, dirs)
    return densities.mean()


def compute_losses(
    renderer: Renderer,
    background: Tensor,
    batch: Tensor,
    loss_weights: Dict[str, float],
    density_penalty: Optional[float] = None,
    density_penalty_batch_size: int = 128,
    u_coarse: Optional[Tensor] = None,
    u_fine: Optional[Tensor] = None,
    density_draws: Optional[Tuple[Tensor, Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Total loss and the logging dict of one ray batch through the
    coarse/fine hierarchy (``learn_nerf_tpu.train.compute_losses``).  The
    parameters are ``renderer.coarse``'s and ``renderer.fine``'s.

    :param batch: ``[N, 3, 3]`` rows of (origin, direction, target colour).
    :param u_coarse: optional ``[N, coarse_ts]`` uniforms of the stratified
        coarse draw; ``u_fine`` optional ``[N, fine_ts]`` of the inverse-CDF
        draw (see :meth:`~.render.Renderer.render_rays`).
    :param density_draws: optional ``(uniforms [B, 3], normals [B, 3])`` of
        the density penalty, shared by both models as the JAX function
        shares its one key; drawn after the render's draws when absent.
    """
    out = renderer.render_rays(batch[:, :2], background, generator=generator, u_coarse=u_coarse, u_fine=u_fine)
    targets = batch[:, 2]
    coarse_loss = ((out["coarse"]["outputs"] - targets) ** 2).mean()
    fine_loss = ((out["fine"]["outputs"] - targets) ** 2).mean()
    loss_dict = dict(coarse=coarse_loss, fine=fine_loss)
    total = coarse_loss + fine_loss
    for prefix in ("coarse", "fine"):
        for name, value in out[f"{prefix}_aux"].items():
            loss_dict[f"{prefix}_{name}"] = value
            total = total + loss_weights[name] * value
    if density_penalty is not None:
        device = batch.device
        if density_draws is None:
            density_draws = (
                torch.rand((density_penalty_batch_size, 3), generator=generator, device=device),
                torch.randn((density_penalty_batch_size, 3), generator=generator, device=device),
            )
        for prefix, model in (("fine", renderer.fine), ("coarse", renderer.coarse)):
            penalty = average_density(model, *bbox_tensors(renderer, device), density_penalty_batch_size,
                                      *density_draws)
            loss_dict[f"{prefix}_density"] = penalty
            total = total + density_penalty * penalty
    return total, loss_dict


def _single_model_loss_tail(
    renderer: OccupancyRenderer,
    outputs: Tensor,
    aux: Dict[str, Tensor],
    targets: Tensor,
    loss_weights: Dict[str, float],
    density_penalty: Optional[float],
    density_penalty_batch_size: int,
    density_draws: Optional[Tuple[Tensor, Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """MSE + weighted aux + optional density penalty, logged under the
    ``fine`` prefix."""
    fine_loss = ((outputs - targets) ** 2).mean()
    loss_dict = dict(fine=fine_loss)
    total = fine_loss
    for name, value in aux.items():
        loss_dict[f"fine_{name}"] = value
        total = total + loss_weights[name] * value
    if density_penalty is not None:
        coords_u, dirs_normal = density_draws if density_draws is not None else (None, None)
        penalty = average_density(
            renderer.model, *bbox_tensors(renderer, outputs.device), density_penalty_batch_size,
            coords_u=coords_u, dirs_normal=dirs_normal, generator=generator,
        )
        loss_dict["fine_density"] = penalty
        total = total + density_penalty * penalty
    return total, loss_dict


def compute_losses_occupancy(
    renderer: OccupancyRenderer,
    background: Tensor,
    batch: Tensor,
    grid_state: OccupancyGridState,
    loss_weights: Dict[str, float],
    density_penalty: Optional[float] = None,
    density_penalty_batch_size: int = 128,
    u: Optional[Tensor] = None,
    density_draws: Optional[Tuple[Tensor, Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    tables: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Total loss and the logging dict of one ray batch on the occupancy
    path.  The field's parameters are ``renderer.model``'s.

    :param batch: ``[N, 3, 3]`` rows of (origin, direction, target colour).
    :param u: optional ``[N, candidates]`` uniforms for the candidate draw.
    :param density_draws: optional ``(uniforms [B, 3], normals [B, 3])`` of
        the density penalty.
    :param tables: optional selection tables
        (:meth:`~.occ_render.OccupancyRenderer.selection_tables`): the
        captured step passes its static ``words``.
    """
    out, aux = renderer.render_rays(batch[:, :2], background, grid_state, u=u, generator=generator, tables=tables)
    return _single_model_loss_tail(
        renderer, out["outputs"], aux, batch[:, 2], loss_weights, density_penalty,
        density_penalty_batch_size, density_draws=density_draws, generator=generator,
    )


def compute_losses_occupancy_pooled(
    renderer: OccupancyRenderer,
    background: Tensor,
    batch: Tensor,
    grid_state: OccupancyGridState,
    loss_weights: Dict[str, float],
    budget: int,
    density_penalty: Optional[float] = None,
    density_penalty_batch_size: int = 128,
    transmittance_eps: float = 0.0,
    u: Optional[Tensor] = None,
    density_draws: Optional[Tuple[Tensor, Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    tables: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The pooled variant of :func:`compute_losses_occupancy`: the field
    model runs on one pool of ``budget`` samples
    (:meth:`~.occ_render.OccupancyRenderer.render_rays_pooled`), and the
    logged dict adds ``fine_pool_dropped``, the survivors that did not fit
    (0 in a healthy run: a dropped sample starves its ray of gradient).
    ``transmittance_eps`` > 0 prunes candidates the grid marks occluded
    before pooling.  The same draws and tables as the dense loss.
    """
    out = renderer.render_rays_pooled(
        batch[:, :2], background, grid_state, budget, transmittance_eps, u=u, generator=generator, tables=tables
    )
    total, loss_dict = _single_model_loss_tail(
        renderer, out["outputs"], out["aux"], batch[:, 2], loss_weights, density_penalty,
        density_penalty_batch_size, density_draws=density_draws, generator=generator,
    )
    loss_dict["fine_pool_dropped"] = out["dropped"]
    return total, loss_dict


def grad_step(loop: "_Trainer", loss_fn: Callable[[], Tuple[Tensor, Dict[str, Tensor]]], graphs=None,
              key=None) -> Dict[str, Tensor]:
    """THE gradient step both loops take (JAX's ``_grad_step``): the body
    (:func:`grad_body`: the loss with its logging dict from ``loss_fn()``,
    the gradients and the norms), the Adam step at the schedule's lr, the
    step counters and the optional EMA.  With ``graphs`` (a
    :class:`~.step_graph.StepGraphs`), the body runs as the replay of
    ``key``'s CUDA graph, which leaves its gradients in the leaves'
    ``.grad``.  Returns the logging dict of 0-dim tensors (on the device:
    read them late)."""
    body = lambda: grad_body(loop, loss_fn)  # noqa: E731
    values = body() if graphs is None else graphs.run(key, body, loop._leaves())
    for group in loop.optimizer.param_groups:
        group["lr"] = loop._schedule(loop._opt_count)
    loop.optimizer.step()
    loop._opt_count += 1
    loop.step_count += 1
    if loop.ema_decay is not None:
        loop._ema_step()
    return values


def grad_body(loop: "_Trainer", loss_fn: Callable[[], Tuple[Tensor, Dict[str, Tensor]]]) -> Dict[str, Tensor]:
    """The device work of a gradient step up to the optimizer: the loss and
    its logging dict from ``loss_fn()``, the gradients and ``grad_norm`` /
    ``param_norm`` (before the update).  Under data parallelism the
    gradients are averaged over the ranks before the norms, and the logged
    values reduced (:meth:`_Trainer._reduce`).  No host-side state moves
    here: it is what a step graph captures."""
    loop.optimizer.zero_grad(set_to_none=True)
    total, values = loss_fn()
    total.backward()
    leaves = loop._leaves()
    if loop._dp is not None:
        all_reduce_mean_([p.grad for p in leaves], loop._dp)
    values = loop._reduce({k: v.detach() for k, v in values.items()})
    values["grad_norm"] = tree_norm(p.grad for p in leaves)
    values["param_norm"] = tree_norm(leaves)
    return values


class _Trainer:
    """What both loops share: the trained models (``self._models``, by
    checkpoint key) and the background, Adam and its lr schedule, the step
    counters, the EMA average, the eval parameters and the full train
    state.  A subclass sets ``LOOP`` (the full state's kind), builds its
    models on ``self.device`` and calls :meth:`_init_training`."""

    LOOP = ""

    def _init_mesh(self, mesh: Optional[Mesh], device, model: FieldModel) -> None:
        """Set ``self.mesh`` (by default one device: ``device``, else where
        ``model`` lies, and no process group), ``self.device``, its card,
        and ``self._dp``, the mesh when its process group runs the step's
        collectives (else None)."""
        if mesh is None:
            mesh = Mesh(devices=(torch.device(device) if device is not None else next(model.parameters()).device,))
        if len(mesh.devices) != 1:
            raise ValueError(f"a train loop trains on one card a process; this mesh has {len(mesh.devices)} "
                             "(launch one process a card: torchrun --nproc_per_node N)")
        self.mesh, self.device = mesh, mesh.devices[0]
        self._dp = mesh if mesh.group is not None else None

    def _init_training(
        self,
        models: Dict[str, FieldModel],
        lr: Union[float, Schedule],
        adam_b1: float,
        adam_b2: float,
        adam_eps: float,
        ema_decay: Optional[float],
    ) -> None:
        for model in models.values():
            # The loops differentiate through every model: a bf16 vanilla
            # model trains on its flax-rounded route, never the fused one.
            if isinstance(model, NeRFModel):
                model.set_bf16_route("flax")
        self._models = models
        self.background = nn.Parameter(torch.tensor([-1.0, -1.0, -1.0], device=self.device))
        self._broadcast_params()
        self._schedule = lr if callable(lr) else constant_schedule(float(lr))
        self.optimizer = torch.optim.Adam(
            self._leaves(), lr=self._schedule(0), betas=(adam_b1, adam_b2), eps=adam_eps,
            foreach=True,
        )
        # Optimizer steps taken (drives the lr schedule; a params pickle
        # does not restore it, the full state does), and the train-state
        # step (drives step_auto's seeds; both checkpoints restore it).
        self._opt_count = 0
        self.step_count = 0
        self.ema_decay = ema_decay
        self._ema_models: Optional[Dict[str, FieldModel]] = None
        self._ema_background: Optional[Tensor] = None
        if ema_decay is not None:
            self._seed_ema()
        self._generator = torch.Generator(device=self.device)
        # The hot route's buffers, per batch size (_step_inputs), and the
        # step graphs that replay its body on the card (None elsewhere).
        self._inputs: Dict[int, Dict[str, Tensor]] = {}
        self._graphs = step_graphs(self.device, self._dp)

    @property
    def graph_replays(self) -> int:
        """Steps the card ran as a graph replay (0 where steps run eagerly)."""
        return 0 if self._graphs is None else self._graphs.replays

    @property
    def captures(self) -> int:
        """Step graphs captured (0 where steps run eagerly)."""
        return 0 if self._graphs is None else self._graphs.captures

    def _leaves(self) -> list:
        return [p for m in self._models.values() for p in m.parameters()] + [self.background]

    # -- data parallelism -------------------------------------------------

    def _broadcast_params(self) -> None:
        """Rank 0's parameters and background on every rank."""
        if self._dp is not None:
            broadcast_(self._leaves(), self._dp)

    def _reduce(self, values: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The logged values over the ranks: ``fine_pool_dropped`` summed,
        the losses and aux means averaged."""
        if self._dp is None:
            return values
        return reduce_values(values, self._dp, summed=("fine_pool_dropped",))

    def _rank_draws(self, n: int, draws: Dict[str, Any], widths: Dict[str, int]) -> Dict[str, Any]:
        """``draws`` with each stratified draw that is left to the generator
        (``widths``: name to columns, in the order the loss draws them)
        drawn for the GLOBAL batch of ``P * n`` rays and cut to this rank's
        rows, so a P-rank step draws what one process draws on the
        concatenated batch.  Unchanged without data parallelism."""
        generator = draws.get("generator")
        if self._dp is None or self._dp.process_count == 1 or generator is None:
            return draws
        r, p = self._dp.process_index, self._dp.process_count
        draws = dict(draws)
        for name, width in widths.items():
            if draws.get(name) is None:
                draws[name] = uniform((p * n, width), self.device, generator)[r * n:(r + 1) * n]
        return draws

    # -- the hot route's prologue -------------------------------------------

    def _step_inputs(self, batch: Tensor, widths: Dict[str, int]) -> Dict[str, Tensor]:
        """The static inputs of the hot route's body at ``batch``'s size,
        made at its first use: the batch, one ``[n, width]`` buffer of
        uniforms for each stratified draw of ``widths`` (name to columns)
        and, with the density penalty, its uniforms and normals ``[B, 3]``."""
        n = batch.shape[0]
        inputs = self._inputs.get(n)
        if inputs is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            inputs = self._inputs[n] = dict(batch=torch.empty_like(batch),
                                            **{name: torch.empty((n, w), **f32) for name, w in widths.items()})
            if self.density_penalty is not None:
                b = self.density_penalty_batch_size
                inputs.update(coords_u=torch.empty((b, 3), **f32), dirs_normal=torch.empty((b, 3), **f32))
        return inputs

    def _draw_inputs(self, inputs: Dict[str, Tensor], batch: Tensor, names: Sequence[str]):
        """The prologue's writes, in the order the eager loss draws: the
        uniforms of each of ``names`` from the loop's generator, then the
        density penalty's uniforms and normals; then ``batch`` copied into
        its buffer.  Returns the penalty's draws (None without it)."""
        generator = self._generator
        for name in names:
            inputs[name].uniform_(generator=generator)
        draws = None
        if self.density_penalty is not None:
            draws = (inputs["coords_u"].uniform_(generator=generator),
                     inputs["dirs_normal"].normal_(generator=generator))
        inputs["batch"].copy_(batch)
        return draws

    def _write(self, write: Callable[[], None]) -> None:
        """Rank 0 writes a checkpoint, then every rank passes a barrier (no
        rank reads or writes the file before it is whole)."""
        if self._dp is None or self._dp.process_index == 0:
            write()
        if self._dp is not None:
            barrier(self._dp)

    def _seed_ema(self) -> None:
        """An independent copy of the parameters to seed the average."""
        self._ema_models = {name: copy.deepcopy(m).requires_grad_(False) for name, m in self._models.items()}
        self._ema_background = self.background.detach().clone()

    def _ema_step(self) -> None:
        """``ema <- decay * ema + (1 - decay) * params``, in place."""
        ema = [p for m in self._ema_models.values() for p in m.parameters()] + [self._ema_background]
        with torch.no_grad():
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, [p.detach() for p in self._leaves()], alpha=1.0 - self.ema_decay)

    def _eval_models(self) -> Tuple[Dict[str, FieldModel], Tensor]:
        """The models and background of :attr:`eval_params`."""
        if self.ema_decay is not None and self._ema_models is not None:
            return self._ema_models, self._ema_background
        return self._models, self.background

    @property
    def eval_params(self) -> Dict[str, Any]:
        """What rendering and checkpoints use: the Polyak average when
        ``ema_decay`` is set, the raw train parameters otherwise (each
        model as a state dict)."""
        models, background = self._eval_models()
        return dict({name: m.state_dict() for name, m in models.items()}, background=background.detach())

    def _place(self, batch) -> Tensor:
        return shard_batch(self.mesh, batch)

    # -- checkpointing ----------------------------------------------------

    def _layout(self) -> Dict[str, int]:
        return self._models["fine"].flax_layout()

    def _save_pickle(self, path: str, **extra) -> None:
        """Write the params pickle both packages render (atomic): the eval
        parameters (the EMA average when enabled) as flax trees, and
        ``extra``."""
        self._write(lambda: save_params_pickle(
            path, checkpoint_to_flax(dict(self.eval_params, **extra), **self._layout())))

    def _load_pickle(self, path: str) -> Dict[str, Any]:
        """Load the models and the background from a params pickle written
        by either package, reseed the average from them, and return the
        pickle for the loop's own keys.  Adam's moments are not in it: the
        optimizer keeps whatever state it has (a fresh loop's is empty)."""
        payload = load_params_pickle(path)
        ckpt = checkpoint_from_flax(payload, **self._layout())
        for name, model in self._models.items():
            model.load_state_dict(ckpt[name])
        with torch.no_grad():
            self.background.copy_(torch.as_tensor(np.asarray(payload["background"], dtype=np.float32)))
        self._broadcast_params()
        if self._ema_models is not None:
            self._seed_ema()  # a params pickle has one tree: seed the average from it
        return payload

    def _full_state(self) -> Dict[str, Any]:
        def params(models, background):
            return dict({name: m.state_dict() for name, m in models.items()}, background=background.detach())

        return dict(
            loop=self.LOOP,
            params=params(self._models, self.background),
            optimizer=self.optimizer.state_dict(),
            opt_count=self._opt_count,
            step=self.step_count,
            ema=None if self._ema_models is None else params(self._ema_models, self._ema_background),
        )

    def save_full(self, path: str) -> None:
        """Write the full train state (atomic): parameters, Adam's moments
        and step, both step counters and the average, so a resumed run
        continues the uninterrupted one (the JAX package's ``save_full``, in
        the port's own format: :func:`~.checkpoint.save_train_state`)."""
        self._write(lambda: save_train_state(path, self._full_state()))

    def load_full(self, path: str) -> Dict[str, Any]:
        """Restore a state written by :meth:`save_full` of a loop of the
        same kind and models; its average is reconciled with this loop's
        ``ema_decay`` (:func:`~.checkpoint._reconcile_ema`).  Returns the
        state for the loop's own keys."""
        state = load_train_state(path, self.LOOP, ema_enabled=self.ema_decay is not None)

        def load(models, background, saved):
            for name, model in models.items():
                model.load_state_dict(saved[name])
            with torch.no_grad():
                background.copy_(saved["background"])

        load(self._models, self.background, state["params"])
        self._broadcast_params()
        self.optimizer.load_state_dict(state["optimizer"])
        self._opt_count, self.step_count = int(state["opt_count"]), int(state["step"])
        if self.ema_decay is not None:
            load(self._ema_models, self._ema_background, state["ema"])
        return state


class TrainLoop(_Trainer):
    """Training loop over a coarse/fine hierarchy (``learn_nerf_tpu.train.
    TrainLoop``): each step renders the batch through both models
    (:func:`compute_losses`) and takes :func:`grad_step`.

    On the card, :meth:`step_auto` and :meth:`step_auto_many` replay a
    captured CUDA graph of each step (:mod:`.step_graph`), one graph per
    batch size, captured at its first use after the run's first (eager)
    step; ``graph_replays`` and ``captures`` count them.  The loop stays
    eager under a process group and in :meth:`step`, which takes the
    caller's draws, on every device.

    :param coarse: the coarse field model; ``fine`` the fine one.  The loop
        moves both to ``device`` and trains their parameters in place.
    :param lr: a float, or a schedule of the optimizer step
        (:func:`cosine_decay_schedule`).
    :param coarse_ts: stratified samples a ray; ``fine_ts`` the
        importance samples added to them for the fine pass.
    :param mesh: data parallelism (see the module doc): one card, and the
        process group of the run.
    :param device: where to train (default: the mesh's card, else where
        the fine model lies).
    """

    LOOP = "hierarchy"

    def __init__(
        self,
        coarse: FieldModel,
        fine: FieldModel,
        lr: Union[float, Schedule],
        coarse_ts: int,
        fine_ts: int,
        bbox_min,
        bbox_max,
        adam_b1: float = 0.9,
        adam_b2: float = 0.999,
        adam_eps: float = 1e-7,
        loss_weights: Optional[Dict[str, float]] = None,
        density_penalty: Optional[float] = None,
        density_penalty_batch_size: int = 128,
        ema_decay: Optional[float] = None,
        mesh: Optional[Mesh] = None,
        device: Union[None, str, torch.device] = None,
    ):
        self._init_mesh(mesh, device, fine)
        self.coarse, self.fine = coarse.to(self.device), fine.to(self.device)
        self.renderer = Renderer(
            coarse=self.coarse, fine=self.fine,
            bbox_min=tuple(np.asarray(bbox_min, dtype=np.float32).tolist()),
            bbox_max=tuple(np.asarray(bbox_max, dtype=np.float32).tolist()),
            coarse_ts=coarse_ts, fine_ts=fine_ts,
        )
        self.loss_weights = loss_weights if loss_weights is not None else default_loss_weights()
        self.density_penalty = density_penalty
        self.density_penalty_batch_size = density_penalty_batch_size
        self._init_training(dict(coarse=self.coarse, fine=self.fine), lr, adam_b1, adam_b2, adam_eps, ema_decay)

    def _loss(self, renderer: Renderer, background: Tensor, batch: Tensor, **draws):
        draws = self._rank_draws(batch.shape[0], draws, dict(u_coarse=self.renderer.coarse_ts,
                                                             u_fine=self.renderer.fine_ts))
        return compute_losses(
            renderer, background, batch, self.loss_weights, density_penalty=self.density_penalty,
            density_penalty_batch_size=self.density_penalty_batch_size, **draws)

    def _grad_step(self, batch: Tensor, **draws) -> Dict[str, Tensor]:
        return grad_step(self, lambda: self._loss(self.renderer, self.background, batch, **draws))

    def step(
        self,
        batch,
        generator: Optional[torch.Generator] = None,
        u_coarse: Optional[Tensor] = None,
        u_fine: Optional[Tensor] = None,
        density_draws: Optional[Tuple[Tensor, Tensor]] = None,
    ) -> Dict[str, Tensor]:
        """One in-place training step with the caller's draws; returns the
        logging dict of 0-dim tensors (on the device: read them late).

        :param batch: ``[N, 3, 3]`` rows of (origin, direction, colour).
        :param generator: draws whatever is not given explicitly.
        """
        return self._grad_step(self._place(batch), u_coarse=u_coarse, u_fine=u_fine,
                               density_draws=density_draws, generator=generator)

    def step_auto(self, base_seed: int, batch) -> Dict[str, Tensor]:
        """Hot-loop step: pass the SAME ``base_seed`` every call.  The
        step's draws come from a generator seeded with ``(base_seed, 0,
        train step)`` (the JAX loop folds ``state.step`` into its key), so
        they continue across a resume: both checkpoints keep the step.  On
        the card the step is a graph replay (:meth:`_hot_step`)."""
        self._generator.manual_seed(fold_seed(base_seed, TRAIN_TAG, self.step_count))
        batch = self._place(batch)
        if self._dp is None:
            return self._hot_step(batch)
        return self._grad_step(batch, generator=self._generator)

    def _hot_step(self, batch: Tensor) -> Dict[str, Tensor]:
        """The hot route's step.  The prologue, on the host: the step's
        draws go into static buffers in the order the eager loss draws them
        (the coarse pass's stratified uniforms, the fine pass's inverse-CDF
        uniforms, then the density penalty's uniforms and normals), and the
        batch is copied into its buffer.  The body (:func:`grad_body`)
        reads only those buffers: eagerly on the CPU, as the replay of the
        batch size's CUDA graph on the card; Adam follows eagerly
        (:func:`grad_step`)."""
        widths = dict(u_coarse=self.renderer.coarse_ts, u_fine=self.renderer.fine_ts)
        inputs = self._step_inputs(batch, widths)
        draws = self._draw_inputs(inputs, batch, list(widths))
        return grad_step(self, lambda: self._loss(self.renderer, self.background, inputs["batch"],
                                                  u_coarse=inputs["u_coarse"], u_fine=inputs["u_fine"],
                                                  density_draws=draws),
                         self._graphs, (batch.shape[0],))

    def step_auto_many(self, base_seed: int, batches: Sequence) -> Dict[str, Tensor]:
        """K hot-loop steps (a plain loop, where the JAX loop scans; on the
        card K graph replays, Adam eager between them), bit for bit K
        :meth:`step_auto` calls.  Returns the LAST step's dict.

        :param batches: ``[k, N, 3, 3]`` stacked ray batches.
        """
        values = None
        for batch in batches:
            values = self.step_auto(base_seed, batch)
        if values is None:
            raise ValueError("step_auto_many needs at least one batch")
        return values

    def eval_losses(
        self,
        batch,
        generator: Optional[torch.Generator] = None,
        u_coarse: Optional[Tensor] = None,
        u_fine: Optional[Tensor] = None,
        density_draws: Optional[Tuple[Tensor, Tensor]] = None,
    ) -> Dict[str, Tensor]:
        """The loss dict without a gradient step (test-set monitoring), on
        :attr:`eval_params`: with EMA on, the weights that are
        checkpointed and rendered."""
        models, background = self._eval_models()
        renderer = dataclasses.replace(self.renderer, coarse=models["coarse"], fine=models["fine"])
        with torch.no_grad():
            _, values = self._loss(renderer, background, self._place(batch), u_coarse=u_coarse,
                                   u_fine=u_fine, density_draws=density_draws, generator=generator)
        return self._reduce(values)

    def save(self, path: str) -> None:
        """Write the params pickle both packages render (atomic): the eval
        parameters (the EMA average when enabled) and ``train_host_step``,
        the train state's step, so a pickle resume continues the seeds."""
        self._save_pickle(path, train_host_step=np.int64(self.step_count))

    def load(self, path: str) -> None:
        """Load both models and the background from a params pickle written
        by either package, and the step from its ``train_host_step`` (the
        reference's pickles lack it: the step stays)."""
        payload = self._load_pickle(path)
        if "train_host_step" in payload:
            self.step_count = int(payload["train_host_step"])


class OccupancyTrainLoop(_Trainer):
    """Training loop for the occupancy-grid fast path (single field model).

    The occupancy grid state is carried beside the optimizer state and
    refreshed every ``update_interval`` steps, before the step, with a
    partial EMA update (:meth:`~.acceleration.OccupancyGrid.update`); the
    grid is saved into the checkpoint so rendering can reuse it.

    With ``pool_budget_per_ray`` set, steps from index ``pool_start_step``
    on take the pooled loss (:func:`compute_losses_occupancy_pooled`) with
    a pool of ``batch * budget`` samples: before that the grid is still
    culling in and a pool would overflow.  ``"auto"`` sizes the budget from
    a batch's measured mean survivor demand (``demand * 1.3`` up to a
    bucket, :func:`~.acceleration.auto_budget_from_demand`), measured again
    every ``_AUTO_REBUDGET_INTERVAL`` host steps; a change of bucket is
    printed.  ``pool_t_eps`` > 0 also prunes grid-occluded candidates, which
    the JAX package measured harmful while the grid still trains.

    On the card, :meth:`step_auto` and :meth:`step_auto_many` replay a
    captured CUDA graph of each step (:mod:`.step_graph`), one graph per
    ``(rays, pool budget or None, grid in warmup)``, captured at its first
    use after the run's first (eager) step; ``graph_replays`` and
    ``captures`` count them.  The loop stays eager under a process group
    and in :meth:`step`, which takes the caller's draws, on every device.

    :param model: the field model; the loop moves it to ``device`` and
        trains its parameters in place.
    :param lr: a float, or a schedule of the optimizer step
        (:func:`cosine_decay_schedule`).
    :param mesh: data parallelism (see the module doc): one card, and the
        process group of the run.
    :param device: where to train (default: the mesh's card, else where
        the model lies).
    """

    LOOP = "occupancy"

    def __init__(
        self,
        model: FieldModel,
        lr: Union[float, Schedule],
        bbox_min,
        bbox_max,
        candidates: int = 192,
        samples: int = 32,
        grid_resolution: int = 128,
        grid_threshold: float = 0.01,
        update_interval: int = 16,
        update_cells: int = 2**17,
        grid_refresh_samples: int = 1,
        grid_freeze_after: Optional[int] = None,
        adam_b1: float = 0.9,
        adam_b2: float = 0.999,
        adam_eps: float = 1e-7,
        loss_weights: Optional[Dict[str, float]] = None,
        density_penalty: Optional[float] = None,
        density_penalty_batch_size: int = 128,
        pool_budget_per_ray: Optional[float] = None,
        pool_start_step: int = 512,
        pool_t_eps: float = 0.0,
        grid_warmup_updates: int = 16,
        ema_decay: Optional[float] = None,
        mesh: Optional[Mesh] = None,
        device: Union[None, str, torch.device] = None,
    ):
        self._init_mesh(mesh, device, model)
        bbox_min_t = tuple(np.asarray(bbox_min, dtype=np.float32).tolist())
        bbox_max_t = tuple(np.asarray(bbox_max, dtype=np.float32).tolist())
        self.grid = OccupancyGrid(
            bbox_min=bbox_min_t, bbox_max=bbox_max_t, resolution=grid_resolution,
            threshold=grid_threshold, warmup_updates=grid_warmup_updates,
        )
        self.model = model.to(self.device)
        self.renderer = OccupancyRenderer(
            model=self.model, grid=self.grid, bbox_min=bbox_min_t, bbox_max=bbox_max_t,
            candidates=candidates, samples=samples,
        )
        self.loss_weights = loss_weights if loss_weights is not None else default_loss_weights()
        self.density_penalty = density_penalty
        self.density_penalty_batch_size = density_penalty_batch_size
        self.pool_budget_per_ray = pool_budget_per_ray
        self.pool_start_step = pool_start_step
        self.pool_t_eps = pool_t_eps
        # The "auto" budget's state (_resolve_pool_budget): reset here and
        # by load, so a resumed loop measures the loaded grid.
        self._auto_per_ray: Optional[int] = None
        self._auto_resolved_at = 0
        self.update_interval = update_interval
        self.update_cells = update_cells
        self.grid_refresh_samples = grid_refresh_samples
        self.grid_freeze_after = grid_freeze_after

        self._host_step = 0  # host steps (the refresh cadence, the pooled switch)
        self._init_training(dict(fine=self.model), lr, adam_b1, adam_b2, adam_eps, ema_decay)
        self.grid_state = self.grid.init(self.device)
        # The grid the hot route's body reads (_hot_step).
        self._static_grid = StaticGridState(self.grid)

    # -- steps ------------------------------------------------------------

    def _loss(self, renderer, background, batch, budget: Optional[int] = None, grid_state=None, tables=None,
              **draws):
        """The dense loss, or the pooled one with a pool of ``budget``, on
        ``grid_state`` (the loop's by default) and ``tables``."""
        draws = self._rank_draws(batch.shape[0], draws, dict(u=self.renderer.candidates))
        common = dict(density_penalty=self.density_penalty,
                      density_penalty_batch_size=self.density_penalty_batch_size, tables=tables, **draws)
        grid_state = self.grid_state if grid_state is None else grid_state
        if budget is None:
            return compute_losses_occupancy(renderer, background, batch, grid_state, self.loss_weights, **common)
        return compute_losses_occupancy_pooled(
            renderer, background, batch, grid_state, self.loss_weights, budget,
            transmittance_eps=self.pool_t_eps, **common)

    _AUTO_REBUDGET_INTERVAL = 256  # host steps between demand measurements

    def _pooled(self, host_step: int) -> bool:
        """Whether the step of index ``host_step`` is pooled."""
        return self.pool_budget_per_ray is not None and host_step >= self.pool_start_step

    def _resolve_pool_budget(self, batch: Tensor) -> float:
        """The per-ray pool budget: the configured number, or for
        ``"auto"`` the bucket of ``demand * 1.3``, where demand is the mean
        survivor count of ``batch`` under the pooled pass's own selection
        (``pool_t_eps`` included), measured again once
        ``_AUTO_REBUDGET_INTERVAL`` host steps have passed since the last
        measurement (under data parallelism: on the global batch, the mean
        over the ranks, so every rank picks one bucket).  The budget
        follows demand both ways; each change of bucket is printed."""
        if self.pool_budget_per_ray != "auto":
            return self.pool_budget_per_ray
        if (self._auto_per_ray is None
                or self._host_step - self._auto_resolved_at >= self._AUTO_REBUDGET_INTERVAL):
            self._generator.manual_seed(fold_seed(DEMAND_SEED, 0, self._host_step))
            draws = self._rank_draws(batch.shape[0], dict(generator=self._generator), dict(u=self.renderer.candidates))
            demand = self._reduce(dict(demand=self.renderer.mean_sample_demand(
                batch[:, :2], self.grid_state, self.pool_t_eps, **draws)))["demand"]
            demand = float(demand)
            bucket = auto_budget_from_demand(demand, self.renderer.samples)
            if bucket != self._auto_per_ray:
                print(
                    f"auto pool budget: {bucket} samples/ray at step {self._host_step} "
                    f"(measured demand {demand:.1f}, was {self._auto_per_ray})",
                    flush=True,
                )
                self._auto_per_ray = bucket
            self._auto_resolved_at = self._host_step
        return self._auto_per_ray

    def _grad_step(self, batch: Tensor, budget: Optional[int] = None, seed: Optional[int] = None,
                   **draws) -> Dict[str, Tensor]:
        """:func:`grad_step` on the dense loss, or the pooled one with a
        pool of ``budget`` samples: with the caller's ``draws``, or with
        ``seed`` (step_auto's) the step's draws from the loop's generator
        seeded with it, through :meth:`_hot_step` (outside a process
        group)."""
        if seed is not None:
            self._generator.manual_seed(seed)
            if self._dp is None:
                return self._hot_step(batch, budget)
            draws = dict(generator=self._generator)
        return grad_step(self, lambda: self._loss(self.renderer, self.background, batch, budget, **draws))

    def _hot_step(self, batch: Tensor, budget: Optional[int]) -> Dict[str, Tensor]:
        """The hot route's step.  The prologue, on the host: the grid the
        body reads follows the loop's (:class:`~.acceleration.StaticGridState`),
        the step's draws go into static buffers in the order the eager loss
        draws them (the candidate uniforms, then the density penalty's
        uniforms and normals), and the batch is copied into its buffer.
        The body (:func:`grad_body`) reads only those buffers: eagerly on the
        CPU, as a CUDA-graph replay on the card; Adam follows eagerly
        (:func:`grad_step`)."""
        inputs = self._step_inputs(batch, dict(u=self.renderer.candidates))
        grid_state = self._static_grid.follow(self.grid_state)
        draws = self._draw_inputs(inputs, batch, ["u"])
        tables = dict(words=self._static_grid.words)
        key = (batch.shape[0], budget, self.grid.in_warmup(grid_state))
        return grad_step(self, lambda: self._loss(self.renderer, self.background, inputs["batch"], budget,
                                                  grid_state=grid_state, tables=tables, u=inputs["u"],
                                                  density_draws=draws),
                         self._graphs, key)

    def _refresh_grid(self, generator=None, ids=None, jitter=None) -> None:
        self.grid_state = self.grid.update(
            self.grid_state, self.model, num_cells=self.update_cells,
            num_samples=self.grid_refresh_samples, generator=generator, ids=ids, jitter=jitter,
        )

    def _refresh_due(self) -> bool:
        """The host-side cadence: a refresh BEFORE the step whenever the
        host step is a multiple of ``update_interval``, until the freeze."""
        return self._host_step % self.update_interval == 0 and (
            self.grid_freeze_after is None or self._host_step < self.grid_freeze_after
        )

    def step(
        self,
        batch,
        generator: Optional[torch.Generator] = None,
        u: Optional[Tensor] = None,
        density_draws: Optional[Tuple[Tensor, Tensor]] = None,
        grid_ids: Optional[Tensor] = None,
        grid_jitter: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        """One in-place training step with the caller's draws, eager on
        every device (the route the step graph is held against, and
        ``train_nerf --test_data_dir``'s); returns the logging dict of 0-dim
        tensors (on the device: read them late).

        :param batch: ``[N, 3, 3]`` rows of (origin, direction, colour).
        :param generator: draws whatever is not given explicitly.
        """
        if self._refresh_due():
            self._refresh_grid(generator=generator, ids=grid_ids, jitter=grid_jitter)
        self._host_step += 1
        batch = self._place(batch)
        return self._grad_step(
            batch, self._step_budget(batch), u=u, density_draws=density_draws, generator=generator
        )

    def _step_budget(self, batch: Tensor) -> Optional[int]:
        """The pool of the step just counted (the JAX loop's
        ``_dispatch_step``: resolved after the host step's increment), or
        None for a dense step."""
        if not self._pooled(self._host_step - 1):
            return None
        return int(batch.shape[0] * self._resolve_pool_budget(batch))

    def step_auto(self, base_seed: int, batch) -> Dict[str, Tensor]:
        """Hot-loop step: pass the SAME ``base_seed`` every call.  The
        step's draws come from a generator seeded with ``(base_seed, 0,
        train step)``, a grid refresh's with ``(base_seed, 1, host
        step)``; both counters are checkpointed by :meth:`save`.  On the
        card the step is a graph replay (:meth:`_hot_step`)."""
        return self._step_auto(base_seed, batch, self._step_budget)

    def _step_auto(self, base_seed: int, batch, budget_of: Callable[[Tensor], Optional[int]]):
        """:meth:`step_auto` with the step's pool from ``budget_of(batch)``
        (None: dense), taken before the step's generator is seeded."""
        if self._refresh_due():
            self._generator.manual_seed(fold_seed(base_seed, GRID_TAG, self._host_step))
            self._refresh_grid(generator=self._generator)
        self._host_step += 1
        batch = self._place(batch)
        budget = budget_of(batch)
        return self._grad_step(batch, budget, seed=fold_seed(base_seed, TRAIN_TAG, self.step_count))

    def step_auto_many(self, base_seed: int, batches: Sequence) -> Dict[str, Tensor]:
        """K hot-loop steps, numerically K :meth:`step_auto` calls (on the
        card K graph replays, the grid refresh eager between them), with the
        JAX loop's macro-step rules: a macro step that
        straddles ``pool_start_step`` is split there, and each part holds
        one pool budget, resolved before its first step on its first batch
        (so the auto budget's re-measure falls on a macro boundary).
        Returns the LAST step's logging dict.

        :param batches: ``[k, N, 3, 3]`` stacked ray batches.
        """
        batches = list(batches)
        if not batches:
            raise ValueError("step_auto_many needs at least one batch")
        split = self.pool_start_step - self._host_step
        if self.pool_budget_per_ray is not None and 0 < split < len(batches):
            self._step_macro(base_seed, batches[:split])
            return self._step_macro(base_seed, batches[split:])
        return self._step_macro(base_seed, batches)

    def _step_macro(self, base_seed: int, batches: list) -> Dict[str, Tensor]:
        budget = None
        if self._pooled(self._host_step):
            first = self._place(batches[0])
            budget = int(first.shape[0] * self._resolve_pool_budget(first))
        values = None
        for batch in batches:
            values = self._step_auto(base_seed, batch, lambda _: budget)
        return values

    def eval_losses(
        self,
        batch,
        generator: Optional[torch.Generator] = None,
        u: Optional[Tensor] = None,
        density_draws: Optional[Tuple[Tensor, Tensor]] = None,
    ) -> Dict[str, Tensor]:
        """The loss dict without a gradient step (test-set monitoring), on
        :attr:`eval_params`: with EMA on, the weights that are
        checkpointed and rendered."""
        models, background = self._eval_models()
        renderer = dataclasses.replace(self.renderer, model=models["fine"])
        with torch.no_grad():
            _, values = self._loss(
                renderer, background, self._place(batch), u=u, density_draws=density_draws,
                generator=generator,
            )
        return self._reduce(values)

    # -- checkpointing ----------------------------------------------------

    def save(self, path: str) -> None:
        """Write the params pickle both packages render (atomic): the eval
        parameters (the EMA average when enabled) as flax trees, the
        occupancy grid's densities and resolution, and the loop's step
        counter (so a resume keeps its refresh phase and its seeds)."""
        self._save_pickle(
            path,
            occupancy_densities=self.grid_state.densities,
            occupancy_resolution=np.int32(self.grid.resolution),
            occupancy_host_step=np.int64(self._host_step),
        )

    def load(self, path: str) -> None:
        """Load parameters, grid and counters from a params pickle written
        by either package.  Adam's moments are not in it: the optimizer
        keeps whatever state it has (a fresh loop's is empty)."""
        payload = self._load_pickle(path)
        if "occupancy_densities" in payload:
            # state_from_checkpoint marks the trained grid past warmup: a
            # step-0 state would re-enter the all-occupied window.
            self.grid_state = self.grid.state_from_checkpoint(payload, self.device)
        if "occupancy_host_step" in payload:
            # Both counters: step_auto's seeds fold the train step, the
            # refresh cadence, the pooled switchover and the seeds the host
            # step, so a run saved past pool_start_step resumes pooled.
            self._host_step = int(payload["occupancy_host_step"])
            self.step_count = self._host_step
        # The auto budget is measured again on the loaded grid.
        self._auto_per_ray, self._auto_resolved_at = None, 0

    def _full_state(self) -> Dict[str, Any]:
        """The shared state, the host step, the grid with its own step, and
        the auto budget as it stood (a record: :meth:`load_full` resets it)."""
        return dict(
            super()._full_state(),
            host_step=self._host_step,
            grid=dict(densities=self.grid_state.densities, step=int(self.grid_state.step),
                      resolution=self.grid.resolution),
            auto_budget=dict(per_ray=self._auto_per_ray, resolved_at=self._auto_resolved_at),
        )

    def load_full(self, path: str) -> Dict[str, Any]:
        """Restore a state written by :meth:`save_full`: everything but the
        auto budget, which is measured again on the loaded grid, as
        :meth:`load` does, at the first pooled step."""
        state = super().load_full(path)
        grid = state["grid"]
        if int(grid["resolution"]) != self.grid.resolution:
            raise ValueError(f"{path} holds a {int(grid['resolution'])}^3 grid; this loop's is "
                             f"{self.grid.resolution}^3")
        self.grid_state = OccupancyGridState(densities=grid["densities"].to(self.device), step=int(grid["step"]))
        self._host_step = int(state["host_step"])
        self._auto_per_ray, self._auto_resolved_at = None, 0
        return state
