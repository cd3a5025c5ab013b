"""One rank of the data-parallel runs of tests/test_torch_parallel.py: the
port alone (no JAX), on the CPU, joined to the other rank over gloo by the
JAX CLI's flags (``init_distributed(coordinator, 2, rank)``).

    python tests/torch_parallel_worker.py RANK PORT INPUTS.npz OUTPUT.npz

INPUTS holds ``config`` (JSON: widths, loop options, per-step budgets) and
the GLOBAL batches and draws; each rank trains on its rows.  OUTPUT holds,
per run, every step's logged values (``<run>.values.<name>``, one per
step), the parameters at the end (``<run>.param.<name>``) and the run's
extras (the occupancy grid, the auto budget's bucket, the dropping step's
local loss and drop).
"""

import json
import sys

import numpy as np
import torch

from learn_nerf_tpu_torch import train
from learn_nerf_tpu_torch.acceleration import OccupancyGridState
from learn_nerf_tpu_torch.models import InstantNGPModel, NeRFModel
from learn_nerf_tpu_torch.parallel.mesh import default_mesh, init_distributed


def state_dict(inputs, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith(prefix)}


def record(out, run, step_values):
    """Each logged name over the steps (NaN on a step that did not log it)."""
    for name in dict.fromkeys(k for v in step_values for k in v):
        out[f"{run}.values.{name}"] = np.array([float(v[name]) if name in v else np.nan for v in step_values])


def record_params(out, run, loop):
    for name, p in zip([f"{k}.{n}" for k, m in loop._models.items() for n, _ in m.named_parameters()]
                       + ["background"], loop._leaves()):
        out[f"{run}.param.{name}"] = p.detach().numpy()


def main(rank, port, inputs_path, output_path):
    torch.set_num_threads(1)
    inputs = dict(np.load(inputs_path))
    cfg = json.loads(str(inputs.pop("config")))
    world = cfg["world"]
    assert init_distributed(f"localhost:{port}", world, rank, device_type="cpu")
    mesh = default_mesh()
    assert mesh.devices == (torch.device("cpu"),) and (mesh.process_index, mesh.process_count) == (rank, world)

    def rows(a):
        n = a.shape[0] // world
        return torch.from_numpy(a[rank * n:(rank + 1) * n])

    out = {}
    # The occupancy loop: dense steps, pooled steps at a budget that drops
    # nothing, then at one that drops (each rank pools its own rows).
    model = InstantNGPModel(**cfg["occ_ngp"], **cfg["bbox"])
    model.load_state_dict(state_dict(inputs, "occ.fine."))
    loop = train.OccupancyTrainLoop(model, mesh=mesh, **cfg["occ_loop"])
    steps = []
    for i, per_ray in enumerate(cfg["occ_budgets"]):
        loop.pool_budget_per_ray = per_ray
        batch = rows(inputs["occ.batch"][i])
        draws = dict(u=rows(inputs["occ.u"][i]),
                     density_draws=(torch.from_numpy(inputs["occ.density_u"][i]),
                                    torch.from_numpy(inputs["occ.density_n"][i])))
        if i == len(cfg["occ_budgets"]) - 1:
            # The dropping step's own loss and drop on this rank, before it.
            with torch.no_grad():
                _, local = train.compute_losses_occupancy_pooled(
                    loop.renderer, loop.background, batch, loop.grid_state, loop.loss_weights,
                    int(batch.shape[0] * per_ray), density_penalty=loop.density_penalty,
                    density_penalty_batch_size=loop.density_penalty_batch_size, **draws)
            out["occ.local_fine"], out["occ.local_dropped"] = float(local["fine"]), int(local["fine_pool_dropped"])
        steps.append(loop.step(batch, grid_ids=torch.from_numpy(inputs["occ.grid_ids"][i]),
                               grid_jitter=torch.from_numpy(inputs["occ.grid_jitter"][i]), **draws))
    record(out, "occ", steps)
    record_params(out, "occ", loop)
    out["occ.grid"] = loop.grid_state.densities.numpy()

    # The hierarchy, vanilla and NGP.
    for kind in cfg["hierarchy"]:
        widths = cfg[kind]
        models = [(NeRFModel if kind == "vanilla" else InstantNGPModel)(**w) for w in widths]
        for name, m in zip(("coarse", "fine"), models):
            m.load_state_dict(state_dict(inputs, f"{kind}.{name}."))
        loop = train.TrainLoop(*models, mesh=mesh, **cfg["hierarchy_loop"], **cfg[f"{kind}_adam"])
        steps = []
        for i in range(inputs[f"{kind}.batch"].shape[0]):
            steps.append(loop.step(
                rows(inputs[f"{kind}.batch"][i]), u_coarse=rows(inputs[f"{kind}.u_coarse"][i]),
                u_fine=rows(inputs[f"{kind}.u_fine"][i]),
                density_draws=(torch.from_numpy(inputs[f"{kind}.density_u"][i]),
                               torch.from_numpy(inputs[f"{kind}.density_n"][i]))))
        record(out, kind, steps)
        record_params(out, kind, loop)

    # The auto pool budget on ranks whose rows differ in demand, through
    # step_auto (its draws from the step's seed, cut to the rank's rows).
    model = InstantNGPModel(**cfg["occ_ngp"], **cfg["bbox"])
    model.load_state_dict(state_dict(inputs, "occ.fine."))
    loop = train.OccupancyTrainLoop(model, mesh=mesh, **cfg["auto_loop"])
    loop.grid_state = OccupancyGridState(densities=torch.from_numpy(inputs["auto.grid"]), step=loop.grid.warmup_updates)
    steps = [loop.step_auto(cfg["auto_seed"], rows(batch)) for batch in inputs["auto.batch"]]
    record(out, "auto", steps)
    record_params(out, "auto", loop)
    out["auto.bucket"] = loop._auto_per_ray
    np.savez(output_path, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
