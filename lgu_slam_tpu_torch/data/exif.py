"""The EXIF Orientation as ``cv2.imread`` (OpenCV 5.0) reads and applies it
for the formats whose reader takes it from an EXIF block: PNG's ``eXIf``
chunk (``image_io``) and WebP's ``EXIF`` chunk (``webp``)."""

from __future__ import annotations

import numpy as np

# EXIF orientation -> the flips and transpose cv2.imread applies
# (imgcodecs' ExifTransform), on [H, W, C]
ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
          4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
          6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
          7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1],
          8: lambda a: a.transpose(1, 0, 2)[::-1]}


def orientation(block: bytes) -> int:
    """The Orientation (tag 0x112) of an EXIF block as OpenCV's
    ``ExifReader`` reads it: a TIFF header (``II`` or ``MM``, 42, the offset
    of the first IFD), then that IFD's entries in order, each one's value
    read as a SHORT in the block's byte order whatever the entry's type (a
    big-endian LONG reads its high half); entries are read up to the first
    read past the block's end, and the first Orientation entry counts.
    0 where the block holds none."""
    order = {b"II": "little", b"MM": "big"}.get(bytes(block[:2]))

    def u(pos, n):
        if order is None or pos + n > len(block):
            raise IndexError
        return int.from_bytes(block[pos:pos + n], order)
    try:
        if u(2, 2) != 42:
            return 0
        ifd = u(4, 4)
        for k in range(u(ifd, 2)):
            entry = ifd + 2 + 12 * k
            if u(entry, 2) == 0x112:
                return u(entry + 8, 2)
    except IndexError:
        pass
    return 0


def orient(img: np.ndarray, value: int) -> np.ndarray:
    """``img`` ([H, W] or [H, W, C]) flipped and transposed by EXIF
    orientation ``value`` as ``cv2.imread`` does it; other values than 2-8
    leave it as it is."""
    if value not in ORIENT:
        return img
    if img.ndim == 2:
        return np.ascontiguousarray(ORIENT[value](img[..., None])[..., 0])
    return np.ascontiguousarray(ORIENT[value](img))
