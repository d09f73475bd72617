"""What the port's BMP, GIF, TIFF, PNM and ICO readers share about PIL: its
decompression-bomb bound, applied from a file's headers where PIL's
``Image.open`` applies it, with PIL's message (the one Python copy of it;
``native/webp_decoder.cpp`` holds its own as ``kMaxPixels``); and
``NeedsPil``, raised for a file that a reader leaves to PIL."""
from __future__ import annotations

MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3  # PIL's Image.MAX_IMAGE_PIXELS


def bomb_check(width: int, height: int) -> None:
    """Raises ``ValueError`` with PIL's ``DecompressionBombError`` message for
    an image past twice ``MAX_IMAGE_PIXELS`` (PIL only warns below that)."""
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"Image size ({pixels} pixels) exceeds limit of {2 * MAX_IMAGE_PIXELS} "
                         "pixels, could be decompression bomb DOS attack.")


class NeedsPil(Exception):
    """A file that the port's readers leave to PIL: a kind they do not
    decode, or one that PIL's plugin for its magic declines, so that
    ``Image.open`` tries its other plugins. The message says which."""
