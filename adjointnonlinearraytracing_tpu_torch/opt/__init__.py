"""Coarse-to-fine optimisation."""

from .multires import (  # noqa: F401
    AdamState, MultiresResult, adam_init, adam_update, boundary_interior_mask, load_checkpoint,
    multires_opt, save_checkpoint, upres_adam_state, upres_scene)
