"""Launch utilities: process groups and the multi-process CLI.

``python -m repro_torch.launch --devices 8 ...`` runs a mesh-backend fit
over one machine per rank and prints the achieved wire-byte telemetry as
JSON. Process-group helpers live in ``repro_torch.launch.mesh``; the
re-exports are lazy, so importing this package touches nothing.
"""
_MESH_EXPORTS = ("initialize_multi_host", "machine_mesh",
                 "process_group_backend", "spawn_local")

__all__ = list(_MESH_EXPORTS)


def __getattr__(name):
    if name in _MESH_EXPORTS:
        from repro_torch.launch import mesh
        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
