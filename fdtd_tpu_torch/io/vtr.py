"""VTK RectilinearGrid (.vtr) snapshot writer.

Replaces the reference's Silo output (reference: main.c:550-598) with a
zero-dependency VTK XML writer that VisIt and ParaView load natively,
preserving the reference's variable names (ex/ey/ez/hx/hy/hz, plus
aEy/aHx/aHz in validation mode) and cell-centered aggregation semantics.
Appended raw-binary encoding — no base64 bloat, one pass, no external libs.
"""

from __future__ import annotations

import io
import os

import numpy as np

_VTK_TYPES = {
    np.dtype(np.float32): "Float32",
    np.dtype(np.float64): "Float64",
}


def write_vtr(
    path: str,
    coords: tuple[np.ndarray, np.ndarray, np.ndarray],
    cell_arrays: dict[str, np.ndarray],
) -> None:
    """Write a rectilinear grid with cell-centered scalar arrays.

    ``coords`` = (x, y, z) node coordinate vectors; each cell array must have
    shape (nz-1, ny-1, nx-1) in (k, j, i) C order — which is exactly VTK's
    x-fastest layout when written flat.
    """
    x, y, z = (np.ascontiguousarray(c, dtype=np.float64) for c in coords)
    nx, ny, nz = len(x), len(y), len(z)

    blocks: list[bytes] = []
    offsets: list[int] = []
    off = 0

    def add_block(arr: np.ndarray) -> int:
        nonlocal off
        raw = np.ascontiguousarray(arr).tobytes()
        header = np.uint64(len(raw)).tobytes()
        blocks.append(header + raw)
        offsets.append(off)
        off += len(header) + len(raw)
        return offsets[-1]

    xml = io.StringIO()
    xml.write('<?xml version="1.0"?>\n')
    xml.write(
        '<VTKFile type="RectilinearGrid" version="1.0" byte_order="LittleEndian" header_type="UInt64">\n'
    )
    ext = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
    xml.write(f'  <RectilinearGrid WholeExtent="{ext}">\n')
    xml.write(f'    <Piece Extent="{ext}">\n')

    xml.write("      <Coordinates>\n")
    for name, c in (("x", x), ("y", y), ("z", z)):
        o = add_block(c)
        xml.write(
            f'        <DataArray type="Float64" Name="{name}" format="appended" offset="{o}"/>\n'
        )
    xml.write("      </Coordinates>\n")

    names = list(cell_arrays)
    xml.write(f'      <CellData Scalars="{names[0] if names else ""}">\n')
    for name in names:
        arr = np.ascontiguousarray(cell_arrays[name])
        if arr.dtype not in _VTK_TYPES:
            arr = arr.astype(np.float32)
        expected = (nz - 1, ny - 1, nx - 1)
        if arr.shape != expected:
            raise ValueError(f"{name}: shape {arr.shape} != cell shape {expected}")
        o = add_block(arr)
        xml.write(
            f'        <DataArray type="{_VTK_TYPES[arr.dtype]}" Name="{name}" format="appended" offset="{o}"/>\n'
        )
    xml.write("      </CellData>\n")

    xml.write("    </Piece>\n  </RectilinearGrid>\n")
    xml.write('  <AppendedData encoding="raw">\n   _')

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(xml.getvalue().encode())
        for b in blocks:
            f.write(b)
        f.write(b"\n  </AppendedData>\n</VTKFile>\n")
    os.replace(tmp, path)


def read_vtr_cell_arrays(path: str) -> dict[str, np.ndarray]:
    """Minimal reader for round-trip tests (appended raw encoding only)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"<AppendedData")
    head = data[:head_end].decode()
    blob_start = data.index(b"_", head_end) + 1

    import re

    m = re.search(r'WholeExtent="0 (\d+) 0 (\d+) 0 (\d+)"', head)
    nx, ny, nz = (int(g) + 1 for g in m.groups())
    out = {}
    for dm in re.finditer(
        r'<DataArray type="(\w+)" Name="(\w+)" format="appended" offset="(\d+)"/>', head
    ):
        typ, name, off = dm.group(1), dm.group(2), int(dm.group(3))
        dtype = {"Float32": np.float32, "Float64": np.float64}[typ]
        pos = blob_start + off
        (nbytes,) = np.frombuffer(data[pos : pos + 8], dtype=np.uint64)
        arr = np.frombuffer(data[pos + 8 : pos + 8 + int(nbytes)], dtype=dtype)
        if name in ("x", "y", "z"):
            out[name] = arr
        else:
            out[name] = arr.reshape(nz - 1, ny - 1, nx - 1)
    return out
