"""PLY point-cloud reader/writer (ascii + binary little/big endian).

From-scratch numpy implementation with the capability the reference gets from
vendored tinyply (``external/include/tinyply.h``; used at
``src/common.cpp:79-146``): parse the header, extract the ``vertex`` element's
``x``/``y``/``z`` float properties, skip any other properties (colors,
normals) and elements (faces).  Reading is vectorized with
``numpy.frombuffer`` — no per-vertex Python loop.
"""

from __future__ import annotations

import io as _io
from typing import List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class _Element:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        self.properties: List[Tuple[str, str]] = []  # (name, numpy dtype str)
        self.list_properties: List[Tuple[str, str, str]] = []  # (name, count dt, item dt)
        self.order: List[Tuple[str, bool]] = []  # (prop name, is_list)


def _parse_header(f) -> Tuple[str, List[_Element]]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements: List[_Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").split()
        if not tokens:
            continue
        kw = tokens[0]
        if kw == "format":
            fmt = tokens[1]  # ascii | binary_little_endian | binary_big_endian
        elif kw in ("comment", "obj_info"):
            continue
        elif kw == "element":
            elements.append(_Element(tokens[1], int(tokens[2])))
        elif kw == "property":
            if not elements:
                raise ValueError("property before element in PLY header")
            el = elements[-1]
            if tokens[1] == "list":
                el.list_properties.append(
                    (tokens[4], _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]])
                )
                el.order.append((tokens[4], True))
            else:
                el.properties.append((tokens[2], _PLY_DTYPES[tokens[1]]))
                el.order.append((tokens[2], False))
        elif kw == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing 'format'")
    return fmt, elements


def read_ply(path: str, properties=("x", "y", "z"), element: str = "vertex") -> np.ndarray:
    """Read ``[N, len(properties)]`` float32 array of vertex properties."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        names = {e.name: e for e in elements}
        if element not in names:
            raise ValueError(f"PLY file has no '{element}' element: {path}")
        if fmt == "ascii":
            return _read_ascii(f, elements, element, properties)
        byteorder = "<" if fmt == "binary_little_endian" else ">"
        return _read_binary(f, elements, element, properties, byteorder)


def _read_ascii(f, elements, element, properties) -> np.ndarray:
    out = None
    for el in elements:
        if any(is_list for _, is_list in el.order):
            # list properties make rows ragged; read line-wise
            rows = [f.readline() for _ in range(el.count)]
            if el.name == element:
                raise ValueError("list properties on vertex element unsupported")
            continue
        prop_names = [n for n, _ in el.properties]
        # fixed-width rows: one text line per row
        data = np.loadtxt(
            _io.BytesIO(b"".join(f.readline() for _ in range(el.count))),
            dtype=np.float64,
            ndmin=2,
        )
        if el.name == element:
            idx = [prop_names.index(p) for p in properties]
            out = data[:, idx].astype(np.float32)
    if out is None:
        raise ValueError(f"element '{element}' not found")
    return out


def _read_binary(f, elements, element, properties, byteorder) -> np.ndarray:
    out = None
    for el in elements:
        if el.list_properties:
            if el.name == element:
                raise ValueError("list properties on vertex element unsupported")
            # variable-size rows: must walk row by row to skip
            for _ in range(el.count):
                for pname, is_list in el.order:
                    if is_list:
                        cdt, idt = next(
                            (c, i) for n, c, i in el.list_properties if n == pname
                        )
                        n = int(
                            np.frombuffer(
                                f.read(np.dtype(cdt).itemsize), byteorder + cdt
                            )[0]
                        )
                        f.read(n * np.dtype(idt).itemsize)
                    else:
                        dt = next(d for n, d in el.properties if n == pname)
                        f.read(np.dtype(dt).itemsize)
            continue
        dtype = np.dtype(
            [(n, byteorder + d) for n, d in el.properties]
        )
        raw = f.read(dtype.itemsize * el.count)
        if len(raw) < dtype.itemsize * el.count:
            raise ValueError("PLY binary payload truncated")
        if el.name == element:
            rec = np.frombuffer(raw, dtype=dtype)
            out = np.stack(
                [rec[p].astype(np.float32) for p in properties], axis=1
            )
    if out is None:
        raise ValueError(f"element '{element}' not found")
    return out


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
    comment: str = "written by goicp_tpu_torch",
):
    """Write ``[N,3]`` points (optional ``[N,3]`` uint8 colors) to PLY.

    The reference parses ``io.visualization`` but never writes it
    (``src/common.cpp:48-49``, SURVEY §5 checkpoint/resume); this implements
    the promised writer.
    """
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"comment {comment}")
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.asarray(colors, np.uint8)
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            if colors is None:
                f.write(points.astype("<f4").tobytes())
            else:
                rec = np.zeros(
                    n,
                    dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("r", "u1"), ("g", "u1"), ("b", "u1")],
                )
                rec["x"], rec["y"], rec["z"] = points.T
                rec["r"], rec["g"], rec["b"] = colors.T
                f.write(rec.tobytes())
        else:
            for i in range(n):
                row = f"{points[i,0]:.6f} {points[i,1]:.6f} {points[i,2]:.6f}"
                if colors is not None:
                    row += f" {colors[i,0]} {colors[i,1]} {colors[i,2]}"
                f.write((row + "\n").encode("ascii"))
