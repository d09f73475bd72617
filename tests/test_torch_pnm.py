"""The port's PNM reader (``utils/pnm.py``) against PIL 12's
``PpmImagePlugin`` + ``convert("RGB")``, bit for bit: the committed fixtures
(``tests/data/pnm/make_fixtures.py``: P1-P6 and Pf, plain and raw, comments
and whitespace in headers, maxvals that scale, round to even or clip),
random headers and bodies, files cut short, and PIL's own writes of every
mode it saves as PNM (hypothesis); the files PIL refuses raise
``ValueError`` naming the file.
"""
import io
import warnings

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from vavae_tpu_torch.utils.pnm import decode_pnm, pnm_head_refusal
from vavae_tpu_torch.utils.png import read_image_rgb, refused_images

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = REPO / "tests" / "data" / "pnm"
PATHS = sorted(p for p in FIXTURES.iterdir() if p.suffix in (".pbm", ".pgm", ".ppm", ".pfm"))
GOOD = [p for p in PATHS if not p.stem.startswith("refused_")]
REFUSED = [p for p in PATHS if p.stem.startswith("refused_")]


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


def _same_outcome(data: bytes, what) -> None:
    want = _pil(data)
    try:
        got = decode_pnm(data)
    except ValueError:
        got = None
    assert (want is None) == (got is None), (what, "PIL refuses" if want is None else "port refuses")
    if want is not None:
        np.testing.assert_array_equal(got, want, err_msg=str(what))


@pytest.mark.parametrize("path", GOOD, ids=lambda p: p.stem)
def test_fixtures_match_pil(path, expected):
    """Each committed fixture reads bit-equal to PIL's committed and live
    decode through ``read_image_rgb``."""
    np.testing.assert_array_equal(read_image_rgb(str(path)), expected[path.stem])
    with Image.open(path) as im:
        assert im.format == "PPM"
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), expected[path.stem])


def test_pinned_scalings(expected):
    """maxval 100 reads 50 as 128 and 51 as 130; a 16-bit maxval of 1000
    reads 700 as 178 (178.5 rounded to even) and 999 as 255; a 16-bit P5 at
    maxval 65535 is clipped at 255, not scaled."""
    np.testing.assert_array_equal(expected["p5_maxval_100_half"][:, 0, 0], [128, 130])
    np.testing.assert_array_equal(expected["p6_maxval_1000_round_even"][0, 0], [178, 0, 255])
    raw = (FIXTURES / "p5_maxval_65535_clipped.pgm").read_bytes()
    v = np.frombuffer(raw[-37 * 29 * 2:], ">u2").reshape(29, 37)
    np.testing.assert_array_equal(expected["p5_maxval_65535_clipped"][..., 0], np.minimum(v, 255))


@pytest.mark.parametrize("path", REFUSED, ids=lambda p: p.stem)
def test_refused_fixtures_raise_as_pil(path):
    """Each file PIL refuses raises ``ValueError`` naming the file."""
    with pytest.raises(Exception):  # noqa: B017 - PIL's refusals differ in type
        with Image.open(path) as im:
            im.convert("RGB")
    with pytest.raises(ValueError, match=f"^{path}: "):
        read_image_rgb(str(path))


def test_header_refusals(tmp_path):
    """``pnm_head_refusal`` finds what the header alone refuses, reading past
    the first bytes only for a header that runs past them; ``refused_images``
    lists those files."""
    with open(FIXTURES / "refused_maxval_0.pgm", "rb") as f:
        assert pnm_head_refusal(f.read(4), f).startswith("maxval must be")
    long_comment = b"P5\n#" + b"x" * 40_000 + b"\n2 1 255\n\0\0"
    path = tmp_path / "long.pgm"
    path.write_bytes(long_comment)
    with open(path, "rb") as f:
        assert pnm_head_refusal(f.read(16), f) is None
    np.testing.assert_array_equal(read_image_rgb(str(path)), _pil(long_comment))
    by_header = {"refused_long_token": "Token too long in file header: 12345678901",
                 "refused_maxval_0": "maxval must be greater than 0 and less than 65536",
                 "refused_unknown_magic": "not a PPM file"}  # the others fail in the pixels
    assert refused_images([str(p) for p in PATHS]) == [
        (str(p), by_header[p.stem]) for p in PATHS if p.stem in by_header]


@pytest.mark.parametrize("path", GOOD, ids=lambda p: p.stem)
def test_cut_files_as_pil(path):
    """Each fixture cut at 10 places: refused or decoded as PIL does."""
    data = path.read_bytes()
    rs = np.random.default_rng(len(data))
    for cut in sorted(set(rs.integers(1, len(data), 8).tolist() + [2, len(data) - 1])):
        _same_outcome(data[:cut], ("cut", cut))


def test_random_headers_and_bodies_as_pil():
    """Random files of every magic: sizes, separators and comments, maxvals
    that scale or clip, plain tokens past maxval, scales of Pf."""
    rs = np.random.default_rng(0)
    seps = [b" ", b"\n", b"\t", b"\r\n", b" # c\n", b"#x\r", b"\x0b", b"\x0c"]
    for t in range(350):
        magic = [b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf"][t % 7]
        w, h = int(rs.integers(1, 9)), int(rs.integers(1, 6))
        maxval = int(rs.choice([1, 7, 100, 255, 256, 1000, 65535, 65534]))
        sep = seps[int(rs.integers(0, len(seps)))]
        head = magic + b"\n" + str(w).encode() + sep + str(h).encode() + sep
        bands = 3 if magic in (b"P3", b"P6") else 1
        if magic == b"Pf":
            head += [b"-1.0", b"1.0", b"0.5", b"-2"][t % 4] + b"\n"
            body = rs.normal(100, 150, w * h).astype("<f4" if t % 2 else ">f4").tobytes()
        elif magic in (b"P1", b"P4"):
            bits = rs.integers(0, 2, (h, w))
            body = (b" ".join(str(int(b)).encode() for b in bits.ravel()) if magic == b"P1"
                    else np.packbits(bits, axis=1).tobytes())
        else:
            head += str(maxval).encode() + b"\n"
            v = rs.integers(0, maxval + (3 if t % 11 == 0 else 1), w * h * bands)
            if magic in (b"P2", b"P3"):
                body = b" ".join(str(int(x)).encode() for x in v)
            else:
                body = v.astype(">u2" if maxval > 255 else np.uint8).tobytes()
        _same_outcome(head + body, t)


@pytest.mark.parametrize("case", [b"P6 +3 1_0 255\n", b"P5 0 1 255\n", b"P5 1 1 0\n",
                                  b"P5 1 1 65536\n", b"Pf 1 1 0\n", b"Pf 1 1 nan\n",
                                  b"P6#c\n1 1 255\n", b"P5 01234567890 1 255\n", b"P3 1 1 255 1#x\n2 3",
                                  b"P1 3 1 01a", b"P2 1 1 300 299", b"P5\x0b1\x0c1\r255\n"],
                         ids=lambda c: repr(c)[2:20])
def test_header_cases_as_pil(case):
    """Python's ``int`` reading a header (a sign, an underscore), sizes,
    maxvals and scales PIL refuses, a comment right after the magic, a
    token of 11 bytes, and plain tokens PIL refuses."""
    _same_outcome(case + bytes(64), case)


def test_decompression_bomb_refused_as_pil(tmp_path):
    """A header past twice PIL's ``MAX_IMAGE_PIXELS`` is refused with PIL's
    message, from the header."""
    data = b"P5 20000 20000 255\n" + bytes(16)
    with pytest.raises(Image.DecompressionBombError) as pil:
        Image.open(io.BytesIO(data))
    path = tmp_path / "bomb.pgm"
    path.write_bytes(data)
    with pytest.raises(ValueError) as port:
        read_image_rgb(str(path))
    assert str(port.value) == f"{path}: {pil.value}"


@st.composite
def _pil_images(draw):
    mode = draw(st.sampled_from(["1", "L", "I;16", "RGB", "F"]))
    w, h = draw(st.integers(1, 24)), draw(st.integers(1, 24))
    seed = draw(st.integers(0, 2**31))
    rs = np.random.default_rng(seed)
    if mode == "1":
        return Image.fromarray(rs.integers(0, 2, (h, w)).astype(bool))
    if mode == "L":
        return Image.fromarray(rs.integers(0, 256, (h, w)).astype(np.uint8))
    if mode == "I;16":
        return Image.fromarray(rs.integers(0, 1 << draw(st.sampled_from([8, 9, 16])),
                                           (h, w)).astype(np.uint16))
    if mode == "RGB":
        return Image.fromarray(rs.integers(0, 256, (h, w, 3)).astype(np.uint8))
    return Image.fromarray((rs.normal(0, 200, (h, w))).astype(np.float32))


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_pil_images())
def test_pil_writes_round_trip(img):
    """PIL's PNM writes of modes 1, L, I;16, RGB and F read as PIL reads
    them."""
    b = io.BytesIO()
    img.save(b, "PPM")
    _same_outcome(b.getvalue(), img.mode)
