"""Instant-NGP: the port's ``InstantNGPModel``."""

from learn_nerf_tpu_torch.models import InstantNGPModel

from nerfbench.roofline import ngp_macs as macs  # noqa: F401


def build_model(cfg: dict):
    return InstantNGPModel(table_sizes=cfg["table_sizes"], grid_sizes=cfg["grid_sizes"],
                           bbox_min=tuple(cfg["bbox_min"]), bbox_max=tuple(cfg["bbox_max"]),
                           table_feature_dim=cfg["n_features_per_level"], d_freqs=cfg["dir_frequencies"],
                           hidden_dim=cfg["hidden_dim"], density_dim=cfg["density_dim"],
                           density_layers=cfg["density_hidden_layers"], color_layers=cfg["color_hidden_layers"],
                           compute_dtype=cfg["compute_dtype"])
