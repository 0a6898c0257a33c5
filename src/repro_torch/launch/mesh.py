"""Mesh shapes: the mesh-independent half of ``repro.launch.mesh``.

A mesh shape is an ordered mapping of axis name to size (``{"data": 16,
"model": 16}``), the duck type the JAX package's shape-only ``_DictMesh``
stands for: :func:`dp_axes` / :func:`dp_size` read a mapping or any
object with a ``shape`` mapping, and ``dist/sharding.py`` repairs specs
against one. Building a device mesh over real cards is not here.
"""
from __future__ import annotations

from collections.abc import Mapping


def axis_sizes(mesh) -> Mapping[str, int]:
    """The ``{axis: size}`` mapping of a mesh shape or of an object with one."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def production_mesh_shape(*, multi_pod: bool = False) -> dict[str, int]:
    """The JAX package's production mesh: 16x16 on one pod (256 chips),
    2x16x16 across two (512)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh: ``("pod", "data")`` when present."""
    shape = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def dp_size(mesh) -> int:
    shape = axis_sizes(mesh)
    n = 1
    for a in dp_axes(shape):
        n *= shape[a]
    return n
