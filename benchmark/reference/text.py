"""Host-side pieces of the Echo-TTS recipe: text normalisation and byte
tokens (BOS 0, UTF-8 bytes), and the end-of-speech flattening-point crop."""
from __future__ import annotations

import numpy as np
import torch

_REPLACEMENTS = [("…", "..."), ("’", "'"), ("”", '"'), ("\n", " "), (":", ","),
                 (";", ","), ("—", ", ")]


def normalize(text: str) -> str:
    for a, b in _REPLACEMENTS:
        text = text.replace(a, b)
    if (not text.startswith("[") and not text.startswith("(")
            and "S1" not in text and "S2" not in text):
        text = "[S1] " + text
    return text


def text_ids(text: str, length: int, normalize_text: bool = True):
    """(ids (1, length) int64, mask (1, length) bool): BOS, the UTF-8
    bytes, cut at `length` and zero-padded to it."""
    if normalize_text:
        text = normalize(text)
    b = [0] + list(text.encode("utf-8"))
    b = b[:length]
    ids = np.zeros((1, length), np.int64)
    mask = np.zeros((1, length), bool)
    ids[0, :len(b)] = b
    mask[0, :len(b)] = True
    return ids, mask


def flattening_point(latent: torch.Tensor, window: int = 20, std_threshold: float = 0.05,
                     mean_tol: float = 0.1) -> int:
    """First index whose [i, i + window) window of the (T, C) latents,
    zero-padded past T, has unbiased std < std_threshold and |mean| <
    mean_tol; T when there is none."""
    t, c = latent.shape
    x = torch.cat([latent.double(), latent.new_zeros((window, c), dtype=torch.float64)])
    win = x.unfold(0, window, 1)[:t]  # (T, C, window)
    flat = win.reshape(t, -1)
    ok = (flat.std(dim=1) < std_threshold) & (flat.mean(dim=1).abs() < mean_tol)
    idx = torch.nonzero(ok)
    return int(idx[0, 0]) if idx.numel() else t
