"""Constant tables on a device, made once per key.

A constant built with ``torch.tensor(..., device=)`` at every call is a
pageable host-to-device copy, which waits for the whole stream: inside the
block pipeline that wait stalls the host until the card has run everything
queued before it.  `device_table` makes each table once, and every later
call reads it from the device with no copy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["device_table"]

_DEVICE_TABLES: dict = {}


def device_table(fn, *args, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(fn(*args))`` on ``device``, made once per key.

    Made by a blocking copy, so the table is complete before any stream
    reads it, and with inference mode off, so that a table first asked for
    under ``torch.inference_mode()`` (the pipeline) can later index tensors
    that autograd tracks (the model's parameters).  Callers only read it."""
    key = (fn.__name__, args, str(device), dtype)
    t = _DEVICE_TABLES.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(np.ascontiguousarray(fn(*args)), dtype=dtype, device=device)
        _DEVICE_TABLES[key] = t
    return t
