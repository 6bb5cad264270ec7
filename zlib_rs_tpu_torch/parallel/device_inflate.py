"""RFC 1951 decode tables shared by the decode engines.

The port's copy of the token kinds and the length/distance base and
extra-bit tables of zlib_rs_tpu/parallel/device_inflate.py (lines
62-96). The lockstep engine of that module is not ported.
"""

from __future__ import annotations

import numpy as np

KIND_LIT = 0
KIND_MATCH = 1
KIND_EOB = 2
KIND_INVALID = 4

# length codes 257..285: base length and extra bits
_LBASE = np.zeros(29, np.int32)
_LEXTRA = np.zeros(29, np.int32)
_l = 3
for _i in range(8):
    _LBASE[_i] = _l
    _l += 1
for _e in range(1, 6):
    for _k in range(4):
        _i += 1
        _LBASE[_i] = _l
        _LEXTRA[_i] = _e
        _l += 1 << _e
_LBASE[28] = 258
_LEXTRA[28] = 0

# distance codes 0..29: base distance and extra bits
_DBASE = np.zeros(30, np.int32)
_DEXTRA = np.zeros(30, np.int32)
_DBASE[:4] = [1, 2, 3, 4]
_d = 5
_i = 3
for _e in range(1, 14):
    for _k in range(2):
        _i += 1
        _DBASE[_i] = _d
        _DEXTRA[_i] = _e
        _d += 1 << _e
