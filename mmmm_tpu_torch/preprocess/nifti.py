"""Minimal native NIfTI-1 reader/writer (no nibabel dependency).

Supports .nii and .nii.gz single-file images: the 348-byte header, sform/qform
affines, the common scalar dtypes, scl_slope/inter scaling, and 3-D/4-D data.
This replaces the reference's MONAI ``LoadImage`` for the offline processors
(``scripts/data/local/processors/_base.py``) — medical volumes in this project
are NIfTI or PNG/JPG; DICOM series need an external converter.

The port's own copy of ``mmmm_tpu/preprocess/nifti.py``.
"""
from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray  # (X, Y, Z[, T]) in file order
    affine: np.ndarray  # 4x4 voxel -> world (RAS mm)

    @property
    def spacing(self) -> np.ndarray:
        return np.linalg.norm(self.affine[:3, :3], axis=0)


def _quaternion_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = -1.0 if hdr["pixdim0"] < 0 else 1.0
    scale = np.array([hdr["pixdim1"], hdr["pixdim2"], hdr["pixdim3"] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * scale
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def read_nifti(path: str | Path) -> NiftiImage:
    path = Path(path)
    raw = path.read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if len(raw) < 352:
        raise ValueError(f"{path}: truncated NIfTI")
    (sizeof_hdr,) = struct.unpack("<i", raw[:4])
    endian = "<" if sizeof_hdr == 348 else ">"
    u = lambda fmt, off: struct.unpack(endian + fmt, raw[off : off + struct.calcsize(fmt)])

    dim = u("8h", 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 3)])
    (datatype,) = u("h", 70)
    (bitpix,) = u("h", 72)
    pixdim = u("8f", 76)
    (vox_offset,) = u("f", 108)
    (scl_slope,) = u("f", 112)
    (scl_inter,) = u("f", 116)
    (qform_code,) = u("h", 252)
    (sform_code,) = u("h", 254)
    quat = u("6f", 256)
    srow = np.asarray(u("12f", 280)).reshape(3, 4)
    magic = raw[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")

    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype, count, int(vox_offset)).reshape(shape, order="F")
    data = np.ascontiguousarray(data.astype(_DTYPES[datatype]))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3] = srow
    elif qform_code > 0:
        hdr = {
            "quatern_b": quat[0], "quatern_c": quat[1], "quatern_d": quat[2],
            "qoffset_x": quat[3], "qoffset_y": quat[4], "qoffset_z": quat[5],
            "pixdim0": pixdim[0], "pixdim1": pixdim[1], "pixdim2": pixdim[2],
            "pixdim3": pixdim[3],
        }
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    return NiftiImage(data, affine)


def write_nifti(path: str | Path, data: np.ndarray, affine: np.ndarray | None = None) -> None:
    path = Path(path)
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    dim = [data.ndim, *data.shape] + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, _CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", header, 72, data.dtype.itemsize * 8)
    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    struct.pack_into("<8f", header, 76, 1.0, *spacing, *([1.0] * 4))
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)  # scl_slope
    struct.pack_into("<h", header, 254, 1)  # sform_code
    struct.pack_into("<12f", header, 280, *affine[:3].reshape(-1))
    header[344:348] = b"n+1\x00"
    payload = bytes(header) + np.asfortranarray(data).tobytes(order="F")
    if path.name.endswith(".gz"):
        path.write_bytes(gzip.compress(payload))
    else:
        path.write_bytes(payload)
