"""A 5x7 bitmap font for the port's plots: the digits and the letters and
signs of the t-SNE plot's title (``entropy=0.912 gini=0.345``), drawn into
uint8 RGB images by ``draw_text`` (no antialiasing), so the title needs no
font library."""
from __future__ import annotations

import numpy as np

WIDTH, HEIGHT = 5, 7
SCALE = 2  # each glyph pixel a 2x2 block

# each glyph: 7 rows of 5 columns, "#" inked
_GLYPHS = {
    "0": [".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."],
    "1": ["..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."],
    "2": [".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"],
    "3": ["#####", "...#.", "..#..", "...#.", "....#", "#...#", ".###."],
    "4": ["...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."],
    "5": ["#####", "#....", "####.", "....#", "....#", "#...#", ".###."],
    "6": ["..##.", ".#...", "#....", "####.", "#...#", "#...#", ".###."],
    "7": ["#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."],
    "8": [".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."],
    "9": [".###.", "#...#", "#...#", ".####", "....#", "...#.", ".##.."],
    "e": [".....", ".....", ".###.", "#...#", "#####", "#....", ".###."],
    "g": [".....", ".####", "#...#", "#...#", ".####", "....#", ".###."],
    "i": ["..#..", ".....", ".##..", "..#..", "..#..", "..#..", ".###."],
    "n": [".....", ".....", "#.##.", "##..#", "#...#", "#...#", "#...#"],
    "o": [".....", ".....", ".###.", "#...#", "#...#", "#...#", ".###."],
    "p": [".....", ".....", "####.", "#...#", "####.", "#....", "#...."],
    "r": [".....", ".....", "#.##.", "##..#", "#....", "#....", "#...."],
    "t": [".#...", ".#...", "###..", ".#...", ".#...", ".#..#", "..##."],
    "y": [".....", ".....", "#...#", "#...#", ".####", "....#", ".###."],
    ".": [".....", ".....", ".....", ".....", ".....", ".##..", ".##.."],
    "=": [".....", ".....", "#####", ".....", "#####", ".....", "....."],
    " ": ["....."] * 7,
}
GLYPHS = {c: np.array([[ch == "#" for ch in row] for row in rows]) for c, rows in _GLYPHS.items()}


def text_size(text: str) -> tuple[int, int]:
    """(height, width) in pixels of ``text``: glyphs 5 wide with a column
    between them, 7 tall, at ``SCALE``."""
    return HEIGHT * SCALE, max(0, (WIDTH + 1) * len(text) - 1) * SCALE


def draw_text(img: np.ndarray, text: str, top: int, left: int) -> None:
    """Inks ``text`` black into ``img`` (H, W, 3) uint8 in place, its top-left
    corner at (top, left); what falls outside the image is dropped. Unknown
    characters raise."""
    for k, ch in enumerate(text):
        if ch not in GLYPHS:
            raise ValueError(f"no glyph for {ch!r}")
        ys, xs = np.nonzero(np.kron(GLYPHS[ch], np.ones((SCALE, SCALE), bool)))
        ys, xs = ys + top, xs + left + k * (WIDTH + 1) * SCALE
        keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
        img[ys[keep], xs[keep]] = 0
