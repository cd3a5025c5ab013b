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

On the card the hierarchy's step runs the composite kernels, forward and
backward, once a pass (:mod:`.kernels.composite`), and with Instant-NGP
models the all-level hash-grid encode and its table-gradient kernel once a
model (through :class:`~.kernels.hashgrid_encode.HashGridEncode`).  The
occupancy step runs the same kernels once (a pooled step runs the
composite pair in the pool's layout).  A bf16 vanilla model trains on its
flax-rounded route (:meth:`~.models.vanilla.NeRFModel.set_bf16_route`, which
the loops select), whose products are plain ``torch`` matmuls.

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

Not ported yet (ROADMAP.md, Queue 1): meshes of several cards (data
parallelism); asking for one raises.
"""

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .acceleration import OccupancyGrid, OccupancyGridState, auto_budget_from_demand
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
from .render import Renderer

Tensor = torch.Tensor
Schedule = Callable[[int], float]

NOT_PORTED = "is not ported to learn_nerf_tpu_torch yet (ROADMAP.md, Queue 1: {item})"

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


def _bbox(renderer, device) -> Tuple[Tensor, Tensor]:
    return (torch.tensor(renderer.bbox_min, dtype=torch.float32, device=device),
            torch.tensor(renderer.bbox_max, dtype=torch.float32, device=device))


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
            penalty = average_density(model, *_bbox(renderer, device), density_penalty_batch_size,
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
            renderer.model, *_bbox(renderer, outputs.device), density_penalty_batch_size,
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
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Total loss and the logging dict of one ray batch on the occupancy
    path.  The field's parameters are ``renderer.model``'s.

    :param batch: ``[N, 3, 3]`` rows of (origin, direction, target colour).
    :param u: optional ``[N, candidates]`` uniforms for the candidate draw.
    :param density_draws: optional ``(uniforms [B, 3], normals [B, 3])`` of
        the density penalty.
    """
    out, aux = renderer.render_rays(batch[:, :2], background, grid_state, u=u, generator=generator)
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
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The pooled variant of :func:`compute_losses_occupancy`: the field
    model runs on one pool of ``budget`` samples
    (:meth:`~.occ_render.OccupancyRenderer.render_rays_pooled`), and the
    logged dict adds ``fine_pool_dropped``, the survivors that did not fit
    (0 in a healthy run: a dropped sample starves its ray of gradient).
    ``transmittance_eps`` > 0 prunes candidates the grid marks occluded
    before pooling.  The same draws as the dense loss.
    """
    out = renderer.render_rays_pooled(
        batch[:, :2], background, grid_state, budget, transmittance_eps, u=u, generator=generator
    )
    total, loss_dict = _single_model_loss_tail(
        renderer, out["outputs"], out["aux"], batch[:, 2], loss_weights, density_penalty,
        density_penalty_batch_size, density_draws=density_draws, generator=generator,
    )
    loss_dict["fine_pool_dropped"] = out["dropped"]
    return total, loss_dict


def grad_step(loop: "_Trainer", loss_fn: Callable[[], Tuple[Tensor, Dict[str, Tensor]]]) -> Dict[str, Tensor]:
    """THE gradient step both loops take (JAX's ``_grad_step``): the loss
    with its logging dict from ``loss_fn()``, the gradients, ``grad_norm`` /
    ``param_norm`` (before the update), the Adam step at the schedule's
    lr, the step counters and the optional EMA.  Returns the logging dict
    of 0-dim tensors (on the device: read them late)."""
    loop.optimizer.zero_grad(set_to_none=True)
    total, values = loss_fn()
    total.backward()
    leaves = loop._leaves()
    values = {k: v.detach() for k, v in values.items()}
    values["grad_norm"] = tree_norm(p.grad for p in leaves)
    values["param_norm"] = tree_norm(leaves)
    for group in loop.optimizer.param_groups:
        group["lr"] = loop._schedule(loop._opt_count)
    loop.optimizer.step()
    loop._opt_count += 1
    loop.step_count += 1
    if loop.ema_decay is not None:
        loop._ema_step()
    return values


class _Trainer:
    """What both loops share: the trained models (``self._models``, by
    checkpoint key) and the background, Adam and its lr schedule, the step
    counters, the EMA average, the eval parameters and the full train
    state.  A subclass sets ``LOOP`` (the full state's kind), builds its
    models on ``self.device`` and calls :meth:`_init_training`."""

    LOOP = ""

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

    def _leaves(self) -> list:
        return [p for m in self._models.values() for p in m.parameters()] + [self.background]

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
        if not isinstance(batch, Tensor):
            batch = torch.from_numpy(np.asarray(batch, dtype=np.float32))
        return batch.to(self.device, non_blocking=True)

    # -- checkpointing ----------------------------------------------------

    def _layout(self) -> Dict[str, int]:
        return self._models["fine"].flax_layout()

    def _save_pickle(self, path: str, **extra) -> None:
        """Write the params pickle both packages render (atomic): the eval
        parameters (the EMA average when enabled) as flax trees, and
        ``extra``."""
        save_params_pickle(path, checkpoint_to_flax(dict(self.eval_params, **extra), **self._layout()))

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
        save_train_state(path, self._full_state())

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
        self.optimizer.load_state_dict(state["optimizer"])
        self._opt_count, self.step_count = int(state["opt_count"]), int(state["step"])
        if self.ema_decay is not None:
            load(self._ema_models, self._ema_background, state["ema"])
        return state


def _refuse_mesh(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError("training over a mesh of cards " + NOT_PORTED.format(item="data parallelism"))


class TrainLoop(_Trainer):
    """Training loop over a coarse/fine hierarchy (``learn_nerf_tpu.train.
    TrainLoop``): each step renders the batch through both models
    (:func:`compute_losses`) and takes :func:`grad_step`.

    :param coarse: the coarse field model; ``fine`` the fine one.  The loop
        moves both to ``device`` and trains their parameters in place.
    :param lr: a float, or a schedule of the optimizer step
        (:func:`cosine_decay_schedule`).
    :param coarse_ts: stratified samples a ray; ``fine_ts`` the
        importance samples added to them for the fine pass.
    :param device: where to train (default: where the fine model lies).
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
        mesh: Any = None,
        device: Union[None, str, torch.device] = None,
    ):
        _refuse_mesh(mesh)
        self.device = torch.device(device) if device is not None else next(fine.parameters()).device
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
        they continue across a resume: both checkpoints keep the step."""
        self._generator.manual_seed(fold_seed(base_seed, TRAIN_TAG, self.step_count))
        return self._grad_step(self._place(batch), generator=self._generator)

    def step_auto_many(self, base_seed: int, batches: Sequence) -> Dict[str, Tensor]:
        """K hot-loop steps (a plain loop, where the JAX loop scans), bit
        for bit K :meth:`step_auto` calls.  Returns the LAST step's dict.

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
        return values

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

    :param model: the field model; the loop moves it to ``device`` and
        trains its parameters in place.
    :param lr: a float, or a schedule of the optimizer step
        (:func:`cosine_decay_schedule`).
    :param device: where to train (default: where the model lies).
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
        mesh: Any = None,
        device: Union[None, str, torch.device] = None,
    ):
        _refuse_mesh(mesh)
        bbox_min_t = tuple(np.asarray(bbox_min, dtype=np.float32).tolist())
        bbox_max_t = tuple(np.asarray(bbox_max, dtype=np.float32).tolist())
        self.device = torch.device(device) if device is not None else next(model.parameters()).device
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

    # -- steps ------------------------------------------------------------

    def _loss(self, renderer, background, batch, budget: Optional[int] = None, **draws):
        """The dense loss, or the pooled one with a pool of ``budget``."""
        common = dict(density_penalty=self.density_penalty,
                      density_penalty_batch_size=self.density_penalty_batch_size, **draws)
        if budget is None:
            return compute_losses_occupancy(
                renderer, background, batch, self.grid_state, self.loss_weights, **common)
        return compute_losses_occupancy_pooled(
            renderer, background, batch, self.grid_state, self.loss_weights, budget,
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
        measurement.  The budget follows demand both ways; each change of
        bucket is printed."""
        if self.pool_budget_per_ray != "auto":
            return self.pool_budget_per_ray
        if (self._auto_per_ray is None
                or self._host_step - self._auto_resolved_at >= self._AUTO_REBUDGET_INTERVAL):
            self._generator.manual_seed(fold_seed(DEMAND_SEED, 0, self._host_step))
            demand = float(self.renderer.mean_sample_demand(
                batch[:, :2], self.grid_state, self.pool_t_eps, generator=self._generator))
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

    def _grad_step(self, batch: Tensor, budget: Optional[int] = None, **draws) -> Dict[str, Tensor]:
        """:func:`grad_step` on the dense loss, or the pooled one with a
        pool of ``budget`` samples."""
        return grad_step(self, lambda: self._loss(self.renderer, self.background, batch, budget, **draws))

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
        """One in-place training step with the caller's draws; returns the
        logging dict of 0-dim tensors (on the device: read them late).

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
        step)``; both counters are checkpointed by :meth:`save`."""
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
        self._generator.manual_seed(fold_seed(base_seed, TRAIN_TAG, self.step_count))
        return self._grad_step(batch, budget, generator=self._generator)

    def step_auto_many(self, base_seed: int, batches: Sequence) -> Dict[str, Tensor]:
        """K hot-loop steps (a plain loop), numerically K :meth:`step_auto`
        calls, with the JAX loop's macro-step rules: a macro step that
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
        return values

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
