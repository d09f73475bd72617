"""The port's PNG reader (``utils/png.py``) on every PNG kind PIL reads:
gray of 1, 2, 4, 8 and 16 bits, gray + alpha, RGB and RGBA of 8 and 16
bits, palette of 1-8 bits, plain and Adam7-interlaced, against PIL's
``Image.open(p).convert("RGB")``, bit for bit. The committed fixtures of
``tests/data/png`` (written by its ``make_fixtures.py``) hold PIL's decodes
in ``expected.npz``, which the card's machine reads too (PIL is not
one of its stated packages); a
seeded sweep of sizes and filters goes through PIL itself.
"""
import io
import sys

import numpy as np
import pytest
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from vavae_tpu_torch.utils.png import decode_png, read_image_rgb, read_png

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = REPO / "tests" / "data" / "png"
sys.path.insert(0, str(FIXTURES))
import make_fixtures as png_fixtures  # noqa: E402

EXPECTED = np.load(FIXTURES / "expected.npz")


@pytest.mark.parametrize("name", sorted(EXPECTED.files))
def test_committed_fixture_matches_pil(name):
    """The file through ``read_png`` and ``read_image_rgb`` equals PIL's
    committed decode, which equals PIL's decode now."""
    path = str(FIXTURES / name)
    want = EXPECTED[name]
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)
    np.testing.assert_array_equal(read_png(path), want)
    np.testing.assert_array_equal(read_image_rgb(path), want)


def test_fixtures_cover_every_kind():
    kinds = {(ctype, depth, adam7) for ctype, (_, depths) in png_fixtures.KINDS.items()
             for depth in depths for adam7 in ("", "_adam7")}
    assert sorted(EXPECTED.files) == sorted(f"c{c}_d{d}{a}.png" for c, d, a in kinds)


@pytest.mark.parametrize("ctype", sorted(png_fixtures.KINDS))
def test_sizes_and_filters_match_pil(ctype):
    """Seeded images of each colour type and depth, plain and interlaced, at
    sizes where Adam7 passes are empty (1×1, 3×9) or partial."""
    rs = np.random.default_rng(ctype)
    c, depths = png_fixtures.KINDS[ctype]
    for depth in depths:
        for interlace in (0, 1):
            for h, w in ((1, 1), (3, 9), (8, 8), (13, 11), (2, 17)):
                s = rs.integers(0, 1 << depth, (h, w, c))
                palette = (rs.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
                           if ctype == 3 else None)
                data = png_fixtures.encode(s, depth, ctype, interlace, rs, palette)
                with Image.open(io.BytesIO(data)) as im:
                    want = np.asarray(im.convert("RGB"))
                got = decode_png(data)
                rgb = np.repeat(got[..., :1], 3, 2) if got.shape[2] < 3 else got[..., :3]
                np.testing.assert_array_equal(rgb, want, err_msg=f"{ctype} {depth} {interlace}")


@pytest.mark.parametrize("depth,ctype,interlace", [(4, 2, 0), (16, 3, 0), (2, 6, 0), (8, 2, 2)])
def test_invalid_headers_raise(depth, ctype, interlace):
    """Depths a colour type does not allow, and an unknown interlace method,
    which PIL refuses too."""
    rs = np.random.default_rng(0)
    data = bytearray(png_fixtures.encode(np.zeros((2, 2, 3), np.int64), 8, 2, 0, rs))
    data[24:29] = bytes([depth, ctype, 0, 0, interlace])  # IHDR's fields (the CRC is not checked)
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(bytes(data))
    with pytest.raises(OSError):  # PIL's UnidentifiedImageError
        with Image.open(io.BytesIO(bytes(data))) as im:
            im.convert("RGB")
