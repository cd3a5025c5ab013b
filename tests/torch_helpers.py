"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
the same weights in both packages, and seeded NumPy inputs."""

import numpy as np
import torch

from learn_nerf_tpu_torch.checkpoint import params_from_flax
from learn_nerf_tpu_torch.models import NeRFModel


def random_flax_tree(seed, input_layers=5, mid_layers=4, hidden=256, color=128,
                     x_freqs=10, d_freqs=4):
    """A vanilla ``Dense_i`` tree with lecun-normal kernels and small
    nonzero biases (so every bias path is exercised), from a NumPy seed."""
    rng = np.random.RandomState(seed)
    x_dim, d_dim = 6 * x_freqs, 6 * d_freqs
    shapes = [(x_dim, hidden)] + [(hidden, hidden)] * (input_layers - 1)
    shapes += [(hidden + x_dim, hidden)] + [(hidden, hidden)] * (mid_layers - 1)
    shapes += [(hidden, 1), (hidden + d_dim, color), (color, 3)]
    return {
        f"Dense_{i}": dict(
            kernel=(rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
            bias=(0.1 * rng.randn(s[1])).astype(np.float32),
        )
        for i, s in enumerate(shapes)
    }


def port_model(tree, compute_dtype="float32", input_layers=5, mid_layers=4, **kw):
    """A port NeRFModel carrying the weights of a flax ``Dense_i`` tree."""
    hidden = tree["Dense_0"]["kernel"].shape[1]
    color = tree[f"Dense_{input_layers + mid_layers + 1}"]["kernel"].shape[1]
    model = NeRFModel(
        input_layers=input_layers, mid_layers=mid_layers, hidden_dim=hidden,
        color_layer_dim=color, compute_dtype=compute_dtype, **kw,
    )
    model.load_state_dict(params_from_flax(tree, input_layers, mid_layers))
    return model.eval()


def points_and_dirs(seed, n, scale=1.5):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d


def t(a):
    return torch.from_numpy(np.array(a))
