"""``utils/pil_resize.py`` against PIL itself: bit for bit, BOX and BICUBIC,
up and down, on random and smooth RGB images (PIL's 8-bit resampler is
integer arithmetic after its double-precision coefficients, so exact
equality is the requirement, not a tolerance)."""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from vavae_tpu_torch.utils.pil_resize import coefficients, resize_uint8

PIL_FILTERS = {"box": Image.BOX, "bicubic": Image.BICUBIC}


def _image(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    if kind == "random":
        return rs.integers(0, 256, (h, w, 3)).astype(np.uint8)
    # smooth gradients with hard edges: BICUBIC's negative lobes overshoot
    # at the edges, so the clip to [0, 255] is exercised
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([127.5 + 127.5 * np.sin(xx / (3 + 4 * c) + yy / 9.0 + c) for c in range(3)], -1)
    img[h // 3: h // 2, :] = 255
    img[:, w // 4: w // 3] = 0
    return img.astype(np.uint8)


def _pil(img: np.ndarray, size, name: str) -> np.ndarray:
    return np.asarray(Image.fromarray(img).resize(size, PIL_FILTERS[name]))


@pytest.mark.parametrize("name", ["box", "bicubic"])
@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("src", [(20, 17), (97, 64), (384, 320), (700, 523)])
@pytest.mark.parametrize("dst", [(8, 9), (45, 31), (256, 256), (600, 401)])
def test_resize_matches_pil_grid(src, dst, kind, name):
    """(W, H) in → (W, H) out, down and up, each axis its own factor."""
    img = _image(kind, src[1], src[0], seed=sum(src) + sum(dst))
    np.testing.assert_array_equal(resize_uint8(img, dst, name), _pil(img, dst, name))


@settings(max_examples=60, deadline=None, database=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90), oh=st.integers(1, 120),
       ow=st.integers(1, 120), name=st.sampled_from(["box", "bicubic"]),
       kind=st.sampled_from(["random", "smooth"]), seed=st.integers(0, 2**16))
def test_resize_matches_pil_any_size(h, w, oh, ow, name, kind, seed):
    img = _image(kind, h, w, seed)
    np.testing.assert_array_equal(resize_uint8(img, (ow, oh), name), _pil(img, (ow, oh), name))


@pytest.mark.parametrize("name", ["box", "bicubic"])
def test_resize_skips_an_unchanged_axis(name):
    """A pass whose size is unchanged is skipped, as in PIL (a pass at
    scale 1 would still filter: BICUBIC's support spans neighbours)."""
    img = _image("random", 40, 50, seed=3)
    np.testing.assert_array_equal(resize_uint8(img, (50, 40), name), img)
    for size in ((50, 23), (77, 40)):
        np.testing.assert_array_equal(resize_uint8(img, size, name), _pil(img, size, name))


def test_adm_crop_chain_matches_pil():
    """The chain of the ADM crop at the f16d32 VAE's 256²: a 640×560 image
    takes one BOX halving, then BICUBIC to 293×256."""
    img = _image("random", 560, 640, seed=5)
    half = resize_uint8(img, (320, 280), "box")
    want = Image.fromarray(img).resize((320, 280), Image.BOX)
    np.testing.assert_array_equal(half, np.asarray(want))
    np.testing.assert_array_equal(resize_uint8(half, (293, 256), "bicubic"),
                                  np.asarray(want.resize((293, 256), Image.BICUBIC)))


def test_coefficients_are_cached_and_read_only():
    a = coefficients(300, 256, "bicubic")
    assert coefficients(300, 256, "bicubic") is a
    assert not a[0].flags.writeable and not a[1].flags.writeable
    idx, k = a
    assert idx.shape == k.shape and idx.min() >= 0 and idx.max() < 300
    # each row of weights sums to one in 22-bit fixed point, up to rounding
    assert np.abs(k.sum(axis=1) - (1 << 22)).max() <= k.shape[1]


def test_resize_rejects_bad_input():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="resample"):
        resize_uint8(img, (2, 2), "lanczos")
    with pytest.raises(ValueError, match="uint8"):
        resize_uint8(img.astype(np.float32), (2, 2))
    with pytest.raises(ValueError, match="positive"):
        resize_uint8(img, (0, 2))
