"""NeRF in the port's layout: the port's ``NeRFModel``."""

from learn_nerf_tpu_torch.models import NeRFModel

from nerfbench.roofline import nerf_macs as macs  # noqa: F401


def build_model(cfg: dict):
    return NeRFModel(input_layers=cfg["input_layers"], mid_layers=cfg["mid_layers"], hidden_dim=cfg["netwidth"],
                     color_layer_dim=cfg["view_width"], x_freqs=cfg["multires"], d_freqs=cfg["multires_views"],
                     compute_dtype=cfg["compute_dtype"])
