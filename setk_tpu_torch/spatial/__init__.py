"""Steering grids, spatial features and sound-source localization."""

from setk_tpu_torch.spatial.steer import (plane_steer_vector,
                                          linear_steer_vector,
                                          circular_steer_vector,
                                          diffuse_covar, steer_vector_grid,
                                          circular_distance_matrix)
__all__ = [
    "plane_steer_vector", "linear_steer_vector", "circular_steer_vector",
    "diffuse_covar", "steer_vector_grid", "circular_distance_matrix"
]
