"""The state carried between the encode and decode stages, to and from numpy.

A codec has no learned weights; what one implementation can hand another
is the arrays between its stages. `state_from_numpy` turns such arrays,
as numpy (for example the JAX package's outputs), into this port's
tensors on a chosen device: unsigned 32-bit arrays become int32 bit-views
(the port's kernel-boundary form), booleans and uint8 bytes stay as they
are, other integers become int32. `state_to_numpy` turns them back, restoring uint32 for the
names that are unsigned.

Known names and their dtypes in numpy:
  words4 u32 [B, W], htab i32 [B, 4W], tabf / tabq i32 [B, 4W],
  mpos i32 [B, CAP_M + 8], mld u32 [B, CAP_M + 8], nmatch i32 [B],
  kbad bool [B], freq i32 [B, 320], lltab u32 [B, 288], dtab u32 [B, 32],
  n_valid / ins_from / start i32 [B], chunks u8 [B, L];
  decode: words i32 [B, Lw] (body words), start_word / align / span
  i32 [W], tables i32 [B, 576], offs i32 [B, S + 1], tapeA / tapeB u32
  [cap, W] (two-plane) or tape u32 [cap, W] (single-plane; the JAX
  package's are [G, cap, 8, 128]), cons / bad / rem i32 [W], outw u32
  [B, out_words].

The checkpointed decode's state is plain host data already, under the
JAX package's field names (`bit`, `window`, `produced`, `adler`,
`finished`): `DeviceInflateState(**dataclasses.asdict(snapshot))` turns a
snapshot taken there into one that resumes here, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device

UNSIGNED = frozenset({"words4", "mld", "lltab", "dtab", "tapeA", "tapeB", "tape", "outw"})


def state_from_numpy(arrays: dict, device=None) -> dict:
    """{name: numpy array} -> {name: tensor on `device`}: the GPU when
    `device` is None (raising when there is none), else `device`."""
    device = _device.resolve_device(device)
    out = {}
    for name, a in arrays.items():
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype in (np.bool_, np.uint8):
            t = torch.from_numpy(a.copy())
        elif a.dtype == np.uint32:
            t = torch.from_numpy(a.view(np.int32).copy())
        elif a.dtype.kind in "iu":
            if a.size and (a.min() < -(2**31) or a.max() >= 2**31):
                raise ValueError(f"{name}: values do not fit int32")
            t = torch.from_numpy(a.astype(np.int32))
        else:
            raise TypeError(f"{name}: unsupported dtype {a.dtype}")
        out[name] = t.to(device)
    return out


def state_to_numpy(state: dict) -> dict:
    """{name: tensor} -> {name: numpy array}, uint32 for unsigned names."""
    out = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        if name in UNSIGNED and a.dtype == np.int32:
            a = a.view(np.uint32)
        out[name] = a
    return out

