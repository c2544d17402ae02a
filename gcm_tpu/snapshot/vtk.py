"""VTK XML writers: .vti (uniform grids) and .vtu (simplex meshes).

Counterpart of the reference's ``VtkSnapshotter`` (SURVEY.md §2
component 15). Host-side, dependency-free (raw-appended VTK XML, readable
by ParaView/VisIt/meshio): the engine device_gets the field pytree at the
snapshot cadence and streams it here. A C++ fast path for high-rate
snapshotting lives in gcm_tpu/native.

Conventions: point data; scalars per state component, plus an assembled
velocity vector when the model has one. Arrays are written little-endian
float32/int64 in VTK "appended" raw encoding.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Sequence

import numpy as np


def _appended_blocks(arrays):
    """Build the appended-data section: uint64 byte-count headers + raw."""
    blob = bytearray()
    offsets = []
    for a in arrays:
        offsets.append(len(blob))
        raw = a.tobytes()
        blob += struct.pack("<Q", len(raw)) + raw
    return bytes(blob), offsets


_VTK_DTYPE = {
    np.dtype(np.float32): "Float32",
    np.dtype(np.float64): "Float64",
    np.dtype(np.int32): "Int32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.uint8): "UInt8",
}


def _data_array_tag(name, arr, offset, ncomp=1):
    t = _VTK_DTYPE[arr.dtype]
    return (
        f'<DataArray type="{t}" Name="{name}" '
        f'NumberOfComponents="{ncomp}" format="appended" offset="{offset}"/>'
    )


def write_vti(
    path: str,
    shape: Sequence[int],
    spacing: Sequence[float],
    origin: Sequence[float],
    point_fields: Dict[str, np.ndarray],
) -> None:
    """Write a uniform-grid snapshot as VTK ImageData (.vti).

    ``point_fields``: name -> array of spatial shape (scalar) or
    (dim, *spatial) (vector; padded to 3 components). Arrays are index-order
    (x fastest in our layout is dim 0) — VTK wants x fastest, so we
    transpose to Fortran order on write.
    """
    shape3 = tuple(shape) + (1,) * (3 - len(shape))
    spacing3 = tuple(spacing) + (1.0,) * (3 - len(spacing))
    origin3 = tuple(origin) + (0.0,) * (3 - len(origin))
    extent = f"0 {shape3[0] - 1} 0 {shape3[1] - 1} 0 {shape3[2] - 1}"

    from gcm_tpu import native

    def f_ravel(a):
        a = np.asarray(a, np.float32)
        if a.ndim == 3:
            return native.transpose_f_order(a)   # C++ blocked transpose
        return np.asfortranarray(a).ravel(order="F")

    names, arrays, ncomps = [], [], []
    for name, arr in point_fields.items():
        arr = np.asarray(arr)
        if arr.ndim == len(shape):           # scalar field
            names.append(name); arrays.append(f_ravel(arr)); ncomps.append(1)
        else:                                 # vector field (dim, *spatial)
            d = arr.shape[0]
            v = np.zeros((3,) + arr.shape[1:], dtype=np.float32)
            v[:d] = arr
            # interleave components per point, x-fastest point order
            flat = np.stack([f_ravel(c) for c in v], axis=-1).ravel()
            names.append(name); arrays.append(flat); ncomps.append(3)

    blob, offsets = _appended_blocks(arrays)
    tags = "\n        ".join(
        _data_array_tag(n, a, o, c)
        for n, a, o, c in zip(names, arrays, offsets, ncomps)
    )
    header = f"""<?xml version="1.0"?>
<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" header_type="UInt64">
  <ImageData WholeExtent="{extent}" Origin="{origin3[0]} {origin3[1]} {origin3[2]}" Spacing="{spacing3[0]} {spacing3[1]} {spacing3[2]}">
    <Piece Extent="{extent}">
      <PointData>
        {tags}
      </PointData>
    </Piece>
  </ImageData>
  <AppendedData encoding="raw">
   _"""
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(blob)
        f.write(b"\n  </AppendedData>\n</VTKFile>\n")


_VTU_CELL_TYPE = {2: 5, 3: 10}       # triangle / tetrahedron


def write_vtu(
    path: str,
    points: np.ndarray,               # [npoints, dim]
    cells: np.ndarray,                # [ncells, dim+1] vertex indices
    point_fields: Dict[str, np.ndarray],
) -> None:
    """Write an unstructured simplex-mesh snapshot (.vtu)."""
    points = np.asarray(points, np.float32)
    cells = np.asarray(cells, np.int64)
    npts, dim = points.shape
    ncells, nverts = cells.shape
    ctype = _VTU_CELL_TYPE[dim]

    pts3 = np.zeros((npts, 3), np.float32)
    pts3[:, :dim] = points

    names, arrays, ncomps = [], [], []
    for name, arr in point_fields.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            names.append(name); arrays.append(arr.astype(np.float32)); ncomps.append(1)
        else:                                 # [dim, npoints] vector
            v = np.zeros((3, npts), np.float32)
            v[: arr.shape[0]] = arr
            names.append(name); arrays.append(v.T.ravel()); ncomps.append(3)

    mesh_arrays = [
        pts3.ravel(),
        cells.ravel(),
        (np.arange(1, ncells + 1, dtype=np.int64) * nverts),
        np.full(ncells, ctype, np.uint8),
    ]
    blob, offsets = _appended_blocks(mesh_arrays + arrays)

    field_tags = "\n        ".join(
        _data_array_tag(n, a, o, c)
        for n, a, o, c in zip(names, arrays, offsets[4:], ncomps)
    )
    header = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="1.0" byte_order="LittleEndian" header_type="UInt64">
  <UnstructuredGrid>
    <Piece NumberOfPoints="{npts}" NumberOfCells="{ncells}">
      <Points>
        {_data_array_tag("Points", mesh_arrays[0], offsets[0], 3)}
      </Points>
      <Cells>
        {_data_array_tag("connectivity", mesh_arrays[1], offsets[1])}
        {_data_array_tag("offsets", mesh_arrays[2], offsets[2])}
        {_data_array_tag("types", mesh_arrays[3], offsets[3])}
      </Cells>
      <PointData>
        {field_tags}
      </PointData>
    </Piece>
  </UnstructuredGrid>
  <AppendedData encoding="raw">
   _"""
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(blob)
        f.write(b"\n  </AppendedData>\n</VTKFile>\n")


def snapshot_fields(model, u: np.ndarray) -> Dict[str, np.ndarray]:
    """Standard per-snapshot field dict: each component + velocity vector."""
    fields = {name: u[i] for i, name in enumerate(model.comp_names)}
    fields["velocity"] = u[model.vel_slice]
    return fields


def write_pvd(path: str, entries) -> None:
    """Write a ParaView collection (.pvd) indexing a snapshot time series.

    ``entries``: iterable of (time, filename) with filenames relative to
    the .pvd's directory. The reference's VTK series is loadable the same
    way (SURVEY.md §2 component 15); ParaView then animates over physical
    time instead of file order.
    """
    from xml.sax.saxutils import quoteattr

    lines = ['<?xml version="1.0"?>',
             '<VTKFile type="Collection" version="0.1" '
             'byte_order="LittleEndian">',
             '  <Collection>']
    for t, fname in entries:
        # quoteattr: task names containing & or < must not produce invalid
        # XML that ParaView rejects (advisor r3)
        lines.append(
            f'    <DataSet timestep="{float(t)}" group="" part="0" '
            f'file={quoteattr(str(fname))}/>')
    lines += ['  </Collection>', '</VTKFile>', '']
    with open(path, "w") as f:
        f.write("\n".join(lines))
