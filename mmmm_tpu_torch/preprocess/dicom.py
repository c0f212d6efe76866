"""Minimal native DICOM reader (no pydicom dependency).

The reference ingests DICOM through MONAI ``LoadImage`` (ITK reader,
``scripts/data/local/processors/_base.py:104-180``; CHAOS CT/MR cases are
DICOM directories, ``processors/CHAOS.py``). This reader covers the
uncompressed transfer syntaxes those datasets ship —

  - 1.2.840.10008.1.2     implicit VR little endian
  - 1.2.840.10008.1.2.1   explicit VR little endian

— parsing just the data elements the volume pipeline needs: pixel geometry,
rescale slope/intercept, spacing, position/orientation, and PixelData.
Compressed syntaxes (JPEG*) raise with a clear message: transcode first
(e.g. ``dcmdjpeg``/``gdcmconv``).

``read_dicom_series`` stacks a directory of single-frame files into a
(D, H, W) float32 volume ordered along the slice normal (ImageOrientation x
ImagePosition projection, falling back to InstanceNumber), returning
(volume, spacing) compatible with ``Processor.load_image``.

The port's own copy of ``mmmm_tpu/preprocess/dicom.py``.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_IMPLICIT_LE = "1.2.840.10008.1.2"
_EXPLICIT_LE = "1.2.840.10008.1.2.1"

# tags we keep: (group, element) -> name
_TAGS = {
    (0x0008, 0x0060): "Modality",
    (0x0018, 0x0050): "SliceThickness",
    (0x0020, 0x0013): "InstanceNumber",
    (0x0020, 0x0032): "ImagePositionPatient",
    (0x0020, 0x0037): "ImageOrientationPatient",
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0004): "PhotometricInterpretation",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0030): "PixelSpacing",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
    (0x7FE0, 0x0010): "PixelData",
}

# explicit-VR kinds with a 2-byte reserved field + 4-byte length
_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}


def _parse_elements(buf: bytes, pos: int, explicit: bool, stop_group: int | None = None):
    """Yield (group, element, VR, value_bytes) until buffer end."""
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        if stop_group is not None and group != stop_group:
            return
        pos += 4
        if explicit or group == 0x0002:
            vr = buf[pos : pos + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        if length == 0xFFFFFFFF:
            # undefined length (sequences / encapsulated pixel data): skip
            # items until the sequence delimitation tag (FFFE, E0DD)
            depth = 1
            while pos + 8 <= n and depth:
                g2, e2 = struct.unpack_from("<HH", buf, pos)
                l2 = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
                if (g2, e2) == (0xFFFE, 0xE0DD):
                    depth -= 1
                elif (g2, e2) == (0xFFFE, 0xE000):
                    if l2 != 0xFFFFFFFF:
                        pos += l2
                else:
                    pos += 0 if l2 == 0xFFFFFFFF else l2
            yield group, elem, vr, b"", pos
            continue
        value = buf[pos : pos + length]
        pos += length
        yield group, elem, vr, value, pos


def read_dicom_file(path: str | Path) -> tuple[np.ndarray, dict]:
    """Single file -> ((frames?, H, W) float32 raw values, metadata dict)."""
    buf = Path(path).read_bytes()
    if buf[128:132] != b"DICM":
        raise ValueError(f"{path}: missing DICM magic (not a part-10 file)")
    # file meta group (0002): always explicit VR LE
    pos = 132
    transfer = _EXPLICIT_LE
    for group, elem, vr, value, pos in _parse_elements(buf, pos, True, stop_group=0x0002):
        if (group, elem) == (0x0002, 0x0010):
            transfer = value.decode("ascii").rstrip("\x00 ")
    if transfer not in (_IMPLICIT_LE, _EXPLICIT_LE):
        raise ValueError(
            f"{path}: compressed transfer syntax {transfer} unsupported — "
            "transcode to little-endian first (dcmdjpeg/gdcmconv)"
        )
    explicit = transfer == _EXPLICIT_LE

    meta: dict = {}
    pixel_data = None
    for group, elem, vr, value, pos in _parse_elements(buf, pos, explicit):
        name = _TAGS.get((group, elem))
        if name is None:
            continue
        if name == "PixelData":
            pixel_data = value
            break  # PixelData is last in practice; stop scanning
        text = value.decode("ascii", errors="replace").strip("\x00 ")
        if name in ("Rows", "Columns", "BitsAllocated", "SamplesPerPixel",
                    "PixelRepresentation"):
            meta[name] = struct.unpack("<H", value[:2])[0] if vr in (b"US", b"UN") \
                else int(text)
        elif name == "InstanceNumber":
            meta[name] = int(text) if text else 0
        elif name in ("RescaleIntercept", "RescaleSlope", "SliceThickness"):
            meta[name] = float(text) if text else None
        elif name in ("ImagePositionPatient", "ImageOrientationPatient", "PixelSpacing"):
            meta[name] = [float(x) for x in text.split("\\") if x]
        else:
            meta[name] = text
    if pixel_data is None:
        raise ValueError(f"{path}: no PixelData")

    rows, cols = meta["Rows"], meta["Columns"]
    bits = meta.get("BitsAllocated", 16)
    signed = meta.get("PixelRepresentation", 0) == 1
    dtype = {8: np.int8 if signed else np.uint8,
             16: np.int16 if signed else np.uint16,
             32: np.int32 if signed else np.uint32}[bits]
    arr = np.frombuffer(pixel_data, dtype=dtype)
    frames = arr.size // (rows * cols)
    arr = arr[: frames * rows * cols].reshape(frames, rows, cols).astype(np.float32)
    slope = meta.get("RescaleSlope") or 1.0
    intercept = meta.get("RescaleIntercept") or 0.0
    if slope != 1.0 or intercept != 0.0:
        arr = arr * slope + intercept
    return (arr if frames > 1 else arr[0]), meta


def read_dicom_series(directory: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Directory of single-frame files -> ((D, H, W) float32, spacing (3,)).

    Slices sort by ImagePositionPatient projected on the slice normal
    (cross product of the ImageOrientation row/col vectors), matching ITK's
    series ordering; files without geometry fall back to InstanceNumber.
    """
    directory = Path(directory)
    files = sorted(
        p for p in directory.iterdir()
        if p.is_file() and not p.name.startswith(".")
    )
    slices = []
    for p in files:
        try:
            frame, meta = read_dicom_file(p)
        except ValueError:
            continue
        if frame.ndim != 2:
            raise ValueError(f"{p}: multi-frame file in a series directory")
        slices.append((frame, meta))
    if not slices:
        raise ValueError(f"{directory}: no readable DICOM files")

    def sort_key(item):
        _, meta = item
        iop = meta.get("ImageOrientationPatient")
        ipp = meta.get("ImagePositionPatient")
        if iop and ipp and len(iop) == 6 and len(ipp) == 3:
            normal = np.cross(iop[:3], iop[3:])
            return float(np.dot(normal, ipp))
        return float(meta.get("InstanceNumber", 0))

    slices.sort(key=sort_key)
    vol = np.stack([s[0] for s in slices])
    meta0 = slices[0][1]
    ps = meta0.get("PixelSpacing") or [1.0, 1.0]
    if len(slices) > 1:
        z = abs(sort_key(slices[1]) - sort_key(slices[0])) or (
            meta0.get("SliceThickness") or 1.0
        )
    else:
        z = meta0.get("SliceThickness") or 1.0
    return vol, np.asarray([z, ps[0], ps[1]], np.float64)
