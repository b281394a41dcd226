"""Sensor models: plane propagation, image splatting, texture losses."""

from .sensors import (  # noqa: F401
    trace_rays_to_plane,
    get_tan_vecs,
    generate_sensor,
    generate_inf_sensor,
    generate_pleno_sensor,
    get_sdf_vals_near,
    get_sdf_vals_far,
    get_disps_from_tex,
    get_defls_from_tex,
    refract,
)
