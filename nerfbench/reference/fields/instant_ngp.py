"""Instant-NGP (Mueller et al. 2022)."""

from ..field import ngp_field as field  # noqa: F401
