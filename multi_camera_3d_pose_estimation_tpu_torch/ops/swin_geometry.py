"""Swin window geometry: static index tables and window layouts.

The port's own copies of the JAX package's geometry helpers, with the same
semantics (integer tables equal bit for bit, layouts equal exactly):

- from ``models/swin.py``: `rel_position_index`, `shift_regions`,
  `shift_mask`, `partition_windows` / `reverse_windows` (``_window_partition``
  / ``_window_reverse``: an already padded and rolled map);
- from ``ops/pallas/swin_block.py``: `window_partition` / `window_reverse`
  (pad + roll + partition, the block kernel's token layout),
  `window_origin_index`, `window_roll_perm` and `valid_mask`.

Tables are numpy, computed once per geometry (`functools.lru_cache`);
`device_table` keeps one copy per device so the forward pass does no
host-to-device copy after the first.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "rel_position_index",
    "shift_regions",
    "shift_mask",
    "partition_windows",
    "reverse_windows",
    "window_partition",
    "window_reverse",
    "window_origin_index",
    "window_roll_perm",
    "valid_mask",
    "padded_dims",
    "device_table",
]


def padded_dims(H: int, W: int, win: int) -> tuple[int, int]:
    """(Hp, Wp): H and W rounded up to window multiples."""
    return -(-H // win) * win, -(-W // win) * win


@lru_cache(maxsize=None)
def rel_position_index(w: int) -> np.ndarray:
    """(w², w²) index into the (2w−1)² relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


@lru_cache(maxsize=None)
def shift_regions(hp: int, wp: int, win: int, shift: int) -> np.ndarray:
    """(nW, w²) per-token region ids of the shifted-window mask, on the
    padded (hp, wp) grid: three h-slices × three w-slices after the roll."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(hp // win, win, wp // win, win)
    return m.transpose(0, 2, 1, 3).reshape(-1, win * win)


def regions_to_mask(regions: np.ndarray) -> np.ndarray:
    """(nW, n) region ids -> (nW, n, n) additive mask, −100 across regions."""
    r = np.asarray(regions)
    return np.where(r[:, None, :] != r[:, :, None], -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=None)
def shift_mask(hp: int, wp: int, win: int, shift: int) -> np.ndarray:
    """(nW, w², w²) additive attention mask of shifted windows (−100)."""
    return regions_to_mask(shift_regions(hp, wp, win, shift))


def partition_windows(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B·nW, w², C)."""
    B, Hp, Wp, C = x.shape
    x = x.reshape(B, Hp // win, win, Wp // win, win, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, C)


def reverse_windows(x: torch.Tensor, win: int, B: int, Hp: int, Wp: int) -> torch.Tensor:
    """(B·nW, w², C) -> (B, Hp, Wp, C)."""
    C = x.shape[-1]
    x = x.reshape(B, Hp // win, Wp // win, win, win, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)


def window_partition(x: torch.Tensor, win: int, shift: int) -> torch.Tensor:
    """(B, H, W, C) image -> (B·nW·n, C) window-order tokens: zero pad to
    window multiples, roll by −shift, partition (the mmcv order)."""
    B, H, W, C = x.shape
    Hp, Wp = padded_dims(H, W, win)
    if Hp != H or Wp != W:
        x = torch.nn.functional.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    return partition_windows(x, win).reshape(-1, C)


def window_reverse(xw: torch.Tensor, B: int, H: int, W: int, win: int,
                   shift: int) -> torch.Tensor:
    """Inverse of `window_partition`: (B·nW·n, C) -> (B, H, W, C)."""
    C = xw.shape[-1]
    Hp, Wp = padded_dims(H, W, win)
    out = reverse_windows(xw.reshape(-1, win * win, C), win, B, Hp, Wp)
    if shift:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    return out[:, :H, :W, :]


@lru_cache(maxsize=None)
def window_origin_index(Hp: int, Wp: int, win: int, shift: int) -> np.ndarray:
    """(nW·n,) padded-grid flat index of each window-order token."""
    oi = (np.arange(Hp) + shift) % Hp
    oj = (np.arange(Wp) + shift) % Wp
    grid = oi[:, None] * Wp + oj[None, :]
    return grid.reshape(Hp // win, win, Wp // win, win).transpose(0, 2, 1, 3).reshape(-1)


@lru_cache(maxsize=None)
def window_roll_perm(H: int, W: int, win: int, s_from: int, s_to: int) -> np.ndarray:
    """Token permutation between two window layouts of one (H, W) map:
    ``next_layout[q] = prev_layout[perm[q]]`` (one block's window reversal
    composed with the next block's partition)."""
    Hp, Wp = padded_dims(H, W, win)
    a = window_origin_index(Hp, Wp, win, s_from)
    b = window_origin_index(Hp, Wp, win, s_to)
    inv_a = np.empty(Hp * Wp, np.int64)
    inv_a[a] = np.arange(a.size)
    return inv_a[b]


@lru_cache(maxsize=None)
def valid_mask(h: int, w: int, hp: int, wp: int, win: int, shift: int) -> np.ndarray:
    """(nW, n) 1.0 where the rolled, padded token is a real map token:
    position p of the rolled map holds original index (p + shift) mod dim."""
    rows = (np.arange(hp) + shift) % hp < h
    cols = (np.arange(wp) + shift) % wp < w
    img = (rows[:, None] & cols[None, :]).astype(np.float32)
    m = img.reshape(hp // win, win, wp // win, win)
    return m.transpose(0, 2, 1, 3).reshape(-1, win * win)


_DEVICE_TABLES: dict = {}


def device_table(fn, *args, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(fn(*args))`` on ``device``, made once per key."""
    key = (fn.__name__, args, str(device), dtype)
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(fn(*args)), dtype=dtype, device=device)
        _DEVICE_TABLES[key] = t
    return t
