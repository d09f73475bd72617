"""The port's BMP reader (``utils/bmp.py``) against PIL 12's
``BmpImagePlugin`` + ``convert("RGB")``, bit for bit: the committed
fixtures (``tests/data/bmp/make_fixtures.py``: PIL's own files and the
byte-by-byte ones, RLE8/RLE4, 16-bit, bitfields, V4/V5 and core headers,
top-down), headers rewritten field by field, files cut short, random RLE
streams; the files PIL refuses raise ``ValueError`` naming the file. An
image folder and an FID folder of ``.bmp`` and ``.webp`` files give the
JAX package's items, and extraction over such a folder its latents.
"""
import io
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

from test_torch_common import REPO, one_thread  # noqa: F401
from test_torch_extract import (  # noqa: F401
    S,
    _assert_same_output,
    posterior_mode,
    vaes,
)
from vavae_tpu.data.image_folder import ImageFolderDataset as JaxFolder
from vavae_tpu.eval import fid as jfid
from vavae_tpu.pipelines import extract_features as jext
from vavae_tpu_torch.data.image_folder import ImageFolderDataset
from vavae_tpu_torch.eval import fid as tfid
from vavae_tpu_torch.pipelines import extract_features as text
from vavae_tpu_torch.utils.bmp import bmp_refusal, decode_bmp
from vavae_tpu_torch.utils.png import read_image_rgb

pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURES = REPO / "tests" / "data" / "bmp"
WEBP = REPO / "tests" / "data" / "webp"
STEMS = sorted(p.stem for p in FIXTURES.glob("*.bmp"))


def _make():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bmp_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _make()


@pytest.fixture(scope="module")
def expected():
    return dict(np.load(FIXTURES / "expected.npz"))


def _pil(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None


def _same_outcome(data: bytes, what) -> None:
    want = _pil(data)
    try:
        got = decode_bmp(data)
    except ValueError:
        got = None
    assert (want is None) == (got is None), (what, "PIL refuses" if want is None else "port refuses")
    if want is not None:
        np.testing.assert_array_equal(got, want, err_msg=str(what))


@pytest.mark.parametrize("stem", STEMS)
def test_fixtures_match_pil(stem, expected):
    """Each committed fixture reads bit-equal to PIL's decode through
    ``read_image_rgb``."""
    path = FIXTURES / f"{stem}.bmp"
    np.testing.assert_array_equal(read_image_rgb(str(path)), expected[stem])
    np.testing.assert_array_equal(_pil(path.read_bytes()), expected[stem])


def _variants():
    """Files whose header fields differ from a valid one: each field set to
    values PIL takes and values it refuses."""
    rgb = MAKE._photo(9, 13, 3)
    idx = (np.add.outer(np.arange(9), np.arange(13)) % 7).astype(np.uint8)
    pal = MAKE._palette(7, 1)
    rows24 = MAKE._rows(rgb[..., ::-1], 24)
    out = {}
    for bits in (0, 2, 8, 24, 48, 64):
        out[f"bits_{bits}"] = MAKE.bmp(13, 9, bits, rows24)
    for comp in (1, 2, 4, 5, 6):
        out[f"compression_{comp}_24bit"] = MAKE.bmp(13, 9, 24, rows24, compression=comp)
    for header in (16, 40, 52, 56, 64, 108, 124, 200):
        out[f"header_{header}"] = MAKE.bmp(13, 9, 8, MAKE._rows(idx, 8), header=header,
                                           palette=pal, colors=7)
    for colors in (1, 2, 7, 300):
        out[f"colors_{colors}"] = MAKE.bmp(13, 9, 8, MAKE._rows(idx, 8), palette=pal, colors=colors)
    gray = bytes(b for i in range(16) for b in (i, i, i, 0))
    out["gray_palette_4bit"] = MAKE.bmp(13, 9, 4, MAKE._rows(idx, 4), palette=gray, colors=16)
    out["gray_palette_4bit_narrow"] = MAKE.bmp(3, 9, 4, MAKE._rows(idx[:, :3], 4), palette=gray, colors=16)
    out["bw_palette_8bit"] = MAKE.bmp(13, 9, 8, MAKE._rows(idx % 2 * 255, 8),
                                      palette=bytes([0, 0, 0, 0, 255, 255, 255, 0]), colors=2)
    out["gray_256"] = MAKE.bmp(13, 9, 8, MAKE._rows(idx * 30, 8),
                               palette=bytes(b for i in range(256) for b in (i, i, i, 0)))
    out["core_offset_quirk"] = MAKE.bmp(13, 9, 8, MAKE._rows(idx, 8), header=12,
                                        palette=MAKE._palette(256, 2, 3), offset=26)
    for masks in ((0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000), (0xF800, 0x7E0, 0x1F)):
        out[f"masks_24bit_{masks[0]:x}"] = MAKE.bmp(13, 9, 24, rows24, compression=3, masks=masks)
    a = np.full((9, 13, 1), 200, np.uint8)
    for masks in ((0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                  (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0), (0xFF00, 0xFF, 0xFF0000, 0),
                  (0x3FF00000, 0xFFC00, 0x3FF, 0)):
        out[f"masks_32bit_{masks[0]:x}_{masks[3]:x}"] = MAKE.bmp(
            13, 9, 32, MAKE._rows(np.concatenate([rgb, a], -1), 32), header=124, compression=3,
            masks=masks)
    out["rle8_in_24bit"] = MAKE.bmp(24, 5, 24, MAKE._rle8_stream(24), compression=1)
    out["rle8_in_4bit"] = MAKE.bmp(24, 5, 4, MAKE._rle8_stream(24), compression=1,
                                   palette=MAKE._palette(16, 3))
    out["rle8_gray"] = MAKE.bmp(24, 5, 8, MAKE._rle8_stream(24), compression=1,
                                palette=bytes(b for i in range(256) for b in (i, i, i, 0)))
    out["rle8_bw"] = MAKE.bmp(24, 5, 8, MAKE._rle8_stream(24), compression=1,
                              palette=bytes([0, 0, 0, 0, 255, 255, 255, 0]), colors=2)
    out["width_0"] = MAKE.bmp(0, 9, 24, b"")
    out["height_0"] = MAKE.bmp(13, 0, 24, b"")
    out["pixels_past_file"] = MAKE.bmp(13, 9, 24, rows24, offset=10_000)
    out["last_row_unpadded"] = MAKE.bmp(13, 9, 24, rows24[:-1])
    out["last_row_short"] = MAKE.bmp(13, 9, 24, rows24[:-3])
    return out


VARIANTS = _variants()


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_header_variants_as_pil(case):
    """Depths, compressions, header sizes, palette sizes, gray and
    black-and-white palettes (whose indices PIL reads as gray, bit-packed
    for two colours), bitfield masks PIL takes and refuses, RLE in other
    depths, empty and short images: refused or decoded as PIL does."""
    _same_outcome(VARIANTS[case], case)


@pytest.mark.parametrize("stem", STEMS)
def test_cut_files_as_pil(stem):
    """Each fixture cut at 12 places: refused or decoded as PIL does (an
    RLE stream that stops early leaves PIL short of image data)."""
    data = (FIXTURES / f"{stem}.bmp").read_bytes()
    rs = np.random.default_rng(len(data))
    for cut in sorted(set(rs.integers(2, len(data), 10).tolist() + [14, len(data) - 1])):
        _same_outcome(data[:cut], ("cut", cut))


def test_random_rle_streams_as_pil():
    """Random RLE8 and RLE4 streams, biased to the escape codes (end of
    line, end of bitmap, delta, absolute runs at odd offsets)."""
    rs = np.random.default_rng(5)
    for t in range(150):
        w, h, rle4 = int(rs.integers(1, 20)), int(rs.integers(1, 6)), bool(t % 2)
        body = rs.integers(0, 256, int(rs.integers(0, 80))).astype(np.uint8)
        body[::2] = np.where(rs.random(len(body[::2])) < 0.5, body[::2] % 8, body[::2])
        data = MAKE.bmp(w, h, 4 if rle4 else 8, body.tobytes(), compression=2 if rle4 else 1,
                        palette=MAKE._palette(16 if rle4 else 256, t))
        _same_outcome(data, ("rle", t, w, h, rle4))


def test_refusals_name_the_file(tmp_path):
    """A refused file raises ``ValueError`` naming it; ``bmp_refusal``
    finds the header refusals without decoding the pixels."""
    bad = tmp_path / "bad.bmp"
    bad.write_bytes(VARIANTS["masks_32bit_3ff00000_0"])
    with pytest.raises(ValueError, match=f"{bad}: unsupported BMP bitfields layout"):
        read_image_rgb(str(bad))
    assert bmp_refusal(str(bad)) == "unsupported BMP bitfields layout"
    short = tmp_path / "short.bmp"
    short.write_bytes(VARIANTS["last_row_short"])
    with pytest.raises(ValueError, match=f"{short}: BMP pixel data cut short"):
        read_image_rgb(str(short))
    assert bmp_refusal(str(short)) is None
    assert bmp_refusal(str(FIXTURES / "rle4.bmp")) is None


@pytest.fixture(scope="module")
def mixed_folder(tmp_path_factory):
    """Two classes of BMP and WebP fixtures (with upper-case names, which
    neither package's class scan takes), as a user's image folder holds."""
    root = tmp_path_factory.mktemp("mixed")
    files = {"class_a": ["pil_rgb24.bmp", "rle8.bmp", "core_p8.bmp", "lossy_q50_m6.webp",
                         "anim_lossless_alpha_offset.webp"],
             "class_b": ["bgra32_v5_bitfields.bmp", "rgb565_bitfields.bmp",
                         "lossless_palette_11.webp", "lossy_alpha_raw_filter2.webp"]}
    for cls, names in files.items():
        (root / cls).mkdir()
        for name in names:
            src = (FIXTURES if name.endswith(".bmp") else WEBP) / name
            shutil.copy(src, root / cls / name)
    return root


def test_image_folder_and_fid_folder_match_jax(mixed_folder, tmp_path):
    """``ImageFolderDataset`` items and the FID folder reader's batches
    equal the JAX package's (which reads through PIL)."""
    ds, jds = ImageFolderDataset(str(mixed_folder), image_size=24), JaxFolder(str(mixed_folder), image_size=24)
    assert ds.items == jds.items and len(ds) == 9
    for i in range(len(ds)):
        (gx, gy), (wx, wy) = ds[i], jds[i]
        np.testing.assert_array_equal(gx, wx)
        assert gy == wy
    flat = tmp_path / "flat"
    flat.mkdir()
    for p in sorted(mixed_folder.glob("class_b/*")):
        shutil.copy(p, flat / p.name)
    got = list(tfid._iter_folder(str(flat), 1, None))
    want = list(jfid._iter_folder(str(flat), 1, None))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_extract_reads_webp_and_bmp_as_jax(vaes, mixed_folder, tmp_path, posterior_mode):  # noqa: F811
    """Extraction over a folder of ``.bmp`` and ``.webp`` files writes the
    JAX package's shards and statistics (posterior mode on both sides)."""
    jv, tv, _ = vaes
    kw = dict(batch_size=4, image_size=S, shard_size=8, seed=0)
    jext.extract(str(mixed_folder), str(tmp_path / "jax"), jv, **kw)
    text.extract(str(mixed_folder), str(tmp_path / "port"), tv, **kw)
    _assert_same_output(tmp_path / "port", tmp_path / "jax")


def test_extract_lists_refused_webp_and_bmp(vaes, mixed_folder, tmp_path):  # noqa: F811
    """WebP and BMP files the port's decoders refuse on their headers are
    named in the one error, beside JPEGs, before anything is encoded."""
    _, tv, _ = vaes
    root = tmp_path / "images"
    shutil.copytree(mixed_folder, root)
    (root / "class_a" / "x.bmp").write_bytes(VARIANTS["compression_4_24bit"])
    data = (WEBP / "lossy_q50_m6.webp").read_bytes()
    (root / "class_b" / "y.webp").write_bytes(data[:len(data) - 9])
    with pytest.raises(ValueError, match="2 of 11 images are JPEGs, WebP or BMP files") as e:
        text.extract(str(root), str(tmp_path / "out"), tv, batch_size=2, image_size=S)
    assert f"{root / 'class_a/x.bmp'}: unsupported BMP compression (4)" in str(e.value)
    assert f"{root / 'class_b/y.webp'}: WebP: file truncated" in str(e.value)
    assert not list((tmp_path / "out").glob("*.safetensors"))
