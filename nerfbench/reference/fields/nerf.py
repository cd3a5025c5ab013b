"""NeRF (Mildenhall et al. 2020) in the port's layout."""

from ..field import nerf_field as field  # noqa: F401
