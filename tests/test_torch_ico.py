"""The port's ICO and CUR reader (``utils/ico.py``, over ``utils/png.py`` and
``utils/bmp.py``'s DIB entry) against PIL 12's ``IcoImagePlugin`` and
``CurImagePlugin`` + ``convert("RGB")``, bit for bit: the committed
fixtures (``tests/data/ico/make_fixtures.py``: PIL's own icons of PNG and
BMP payloads, hand-built DIBs of every depth with their masks, the entry
PIL picks, sizes the directory gets wrong, cursors), random icons and
cursors, files cut short. Files PIL refuses raise naming the file; files
its plugins decline as they open them (which ``Image.open`` then offers to
its other plugins: an uncompressed TGA file starts with a cursor's magic)
go to PIL.
"""
import io
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from vavae_tpu_torch.utils.ico import decode_ico, ico_head_refusal
from vavae_tpu_torch.utils.pil_limits import NeedsPil
from vavae_tpu_torch.utils.png import read_image_rgb, refused_images

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = REPO / "tests" / "data" / "ico"
PATHS = sorted(p for p in FIXTURES.iterdir() if p.suffix in (".ico", ".cur"))
GOOD = [p for p in PATHS if not p.stem.startswith("refused_")]
REFUSED = [p for p in PATHS if p.stem.startswith("refused_")]


def _make():
    import importlib.util

    spec = importlib.util.spec_from_file_location("ico_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make()


@pytest.fixture(scope="module")
def expected():
    return dict(np.load(FIXTURES / "expected.npz"))


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None


def _same_outcome(data: bytes, what) -> bool:
    """Holds the port to PIL on ``data``; False (nothing held) for a file
    the plugins decline, which the port leaves to PIL."""
    try:
        got = decode_ico(data)
    except NeedsPil:
        return False
    except ValueError:
        got = None
    want = _pil(data)
    assert (want is None) == (got is None), (what, "PIL refuses" if want is None else "port refuses")
    if want is not None:
        np.testing.assert_array_equal(got, want, err_msg=str(what))
    return True


@pytest.mark.parametrize("path", GOOD, ids=lambda p: p.stem)
def test_fixtures_match_pil(path, expected):
    """Each committed fixture reads bit-equal to PIL's committed and live
    decode through ``read_image_rgb``."""
    np.testing.assert_array_equal(read_image_rgb(str(path)), expected[path.stem])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(path) as im:
            assert im.format == ("CUR" if path.suffix == ".cur" else "ICO")
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), expected[path.stem])


def test_pinned_choices(expected):
    """Of entries of one size the lowest depth is read (4 bits before 24 and
    32); a size byte of 0 counts as 256; the PNG's own size stands where the
    directory's disagrees; a cursor reads the entry larger in both sizes."""
    np.testing.assert_array_equal(expected["same_size_lowest_depth_first"],
                                  expected["dib_4bit"])
    np.testing.assert_array_equal(expected["size_byte_0_is_256"], expected["dib_24bit"])
    assert expected["directory_size_disagrees"].shape == (30, 40, 3)
    np.testing.assert_array_equal(expected["cursor_larger_second"], expected["dib_24bit"])


@pytest.mark.parametrize("path", REFUSED, ids=lambda p: p.stem)
def test_refused_fixtures_raise_as_pil(path):
    """Each file PIL refuses raises naming the file: from the port's reader
    (``ValueError``), or, for a directory of no entries, which the plugin
    declines, from PIL."""
    assert _pil(path.read_bytes()) is None
    with pytest.raises(Exception, match=str(path)):  # noqa: B017 - PIL's own type
        read_image_rgb(str(path))
    try:
        decode_ico(path.read_bytes())
    except NeedsPil:
        assert path.stem == "refused_no_entries"
    except ValueError:
        pass


def test_header_refusals():
    """``ico_head_refusal`` names what the directory and payload headers
    refuse, and passes the good fixtures."""
    reasons = {}
    for path in PATHS:
        with open(path, "rb") as f:
            try:
                reasons[path.stem] = ico_head_refusal(f.read(4), f)
            except NeedsPil:
                reasons[path.stem] = "PIL"
    assert {s: r for s, r in reasons.items() if r} == {
        "refused_alpha_cut": "buffer is not large enough",
        "refused_cursor_png": "BMP header cut short",
        "refused_mask_past_file": "not enough image data", "refused_no_entries": "PIL"}
    assert refused_images([str(p) for p in GOOD]) == []


@pytest.mark.parametrize("path", GOOD, ids=lambda p: p.stem)
def test_cut_files_as_pil(path):
    """Each fixture cut at 10 places: refused or decoded as PIL does."""
    data = path.read_bytes()
    rs = np.random.default_rng(len(data))
    for cut in sorted(set(rs.integers(6, len(data), 9).tolist() + [len(data) - 1])):
        _same_outcome(data[:cut], ("cut", cut))


def test_random_icons_and_cursors_as_pil():
    """Random directories of PNG and DIB entries (1-3, of random sizes,
    depths, colour counts and size bytes), as icons and cursors."""
    rs = np.random.default_rng(0)
    held = 0
    for t in range(150):
        entries = []
        for _ in range(int(rs.integers(1, 4))):
            w, h = int(rs.integers(1, 40)), int(rs.integers(1, 40))
            kind = int(rs.integers(0, 5))
            img = rs.integers(0, 256, (h, w, 4)).astype(np.uint8)
            mask = rs.integers(0, 2, (h, w))
            pal = lambda n: np.concatenate(  # noqa: E731
                [rs.integers(0, 256, (n, 3)), np.zeros((n, 1), int)], 1).astype(np.uint8).tobytes()
            if kind == 0:
                b = io.BytesIO()
                Image.fromarray(img, "RGBA").save(b, "PNG")
                payload, bpp = b.getvalue(), 32
            elif kind == 1:
                payload, bpp = MAKE.dib(img[..., [2, 1, 0, 3]], 32, mask), 32
            elif kind == 2:
                payload, bpp = MAKE.dib(img[..., [2, 1, 0]], 24, mask), 24
            elif kind == 3:
                payload, bpp = MAKE.dib(rs.integers(0, 16, (h, w)), 4, mask, pal(16)), 4
            else:
                payload, bpp = MAKE.dib(rs.integers(0, 256, (h, w)), 8, mask, pal(256)), 8
            wb = w if rs.random() < 0.8 else int(rs.integers(0, 256))
            hb = h if rs.random() < 0.8 else int(rs.integers(0, 256))
            if rs.random() < 0.2:
                bpp = int(rs.choice([0, 1, 8, 32]))
            entries.append((wb % 256, hb % 256, int(rs.integers(0, 3)) * 8, bpp, payload, None))
        held += _same_outcome(MAKE.icon(entries, cursor=t % 5 == 0), t)
    assert held == 150


def test_decompression_bomb_refused_as_pil(tmp_path):
    """A PNG payload whose IHDR is past twice PIL's ``MAX_IMAGE_PIXELS`` is
    refused with PIL's message, before it is decoded."""
    png = bytearray(MAKE._png(np.zeros((2, 2, 3), np.uint8)))
    png[16:24] = (40000).to_bytes(4, "big") + (30000).to_bytes(4, "big")
    png[29:33] = zlib.crc32(bytes(png[12:29])).to_bytes(4, "big")  # PIL checks IHDR's CRC
    data = MAKE.icon([(0, 0, 0, 32, bytes(png), None)])
    with pytest.raises(Image.DecompressionBombError) as pil:
        Image.open(io.BytesIO(data))
    path = tmp_path / "bomb.ico"
    path.write_bytes(data)
    with pytest.raises(ValueError) as port:
        read_image_rgb(str(path))
    assert str(port.value) == f"{path}: {pil.value}"
