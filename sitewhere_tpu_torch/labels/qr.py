"""QR code encoder: byte mode, versions 1-10, EC levels L/M/Q/H.

A complete, dependency-free implementation of ISO/IEC 18004 encoding —
Reed-Solomon ECC over GF(256), block interleaving, the eight data masks with
penalty-scored selection, format/version BCH codes — producing a boolean
module matrix. Replaces the reference's ZXing dependency
(service-label-generation/src/main/java/com/sitewhere/labels/symbology/
QrCodeGenerator.java, which delegates to QRCode.from(uri)); the entity-URI
payloads that service encodes (sitewhere://device/<token>, ~20-80 bytes) fit
comfortably in versions 1-10 (v10-L holds 271 bytes).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# -- GF(256) arithmetic (polynomial 0x11d) -----------------------------------

_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11d
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _rs_generator(n_ec: int) -> List[int]:
    """Generator polynomial coefficients (monic, ascending degree order of
    the remainder algorithm: g[0] is the x^{n_ec-1} coefficient side)."""
    gen = [1]
    for i in range(n_ec):
        nxt = [0] * (len(gen) + 1)
        for j, c in enumerate(gen):
            nxt[j] ^= _gf_mul(c, _EXP[i])
            nxt[j + 1] ^= c
        gen = nxt
    return gen[::-1]  # highest degree first


def rs_ecc(data: Sequence[int], n_ec: int) -> List[int]:
    """Reed-Solomon error-correction codewords for a data block."""
    gen = _rs_generator(n_ec)
    rem = list(data) + [0] * n_ec
    for i in range(len(data)):
        factor = rem[i]
        if factor:
            for j in range(1, len(gen)):
                rem[i + j] ^= _gf_mul(gen[j], factor)
    return rem[len(data):]


# -- capacity tables, versions 1-10 ------------------------------------------
# (ec_per_block, blocks1, data1, blocks2, data2) per level
_EC_TABLE = {
    1: {"L": (7, 1, 19, 0, 0), "M": (10, 1, 16, 0, 0),
        "Q": (13, 1, 13, 0, 0), "H": (17, 1, 9, 0, 0)},
    2: {"L": (10, 1, 34, 0, 0), "M": (16, 1, 28, 0, 0),
        "Q": (22, 1, 22, 0, 0), "H": (28, 1, 16, 0, 0)},
    3: {"L": (15, 1, 55, 0, 0), "M": (26, 1, 44, 0, 0),
        "Q": (18, 2, 17, 0, 0), "H": (22, 2, 13, 0, 0)},
    4: {"L": (20, 1, 80, 0, 0), "M": (18, 2, 32, 0, 0),
        "Q": (26, 2, 24, 0, 0), "H": (16, 4, 9, 0, 0)},
    5: {"L": (26, 1, 108, 0, 0), "M": (24, 2, 43, 0, 0),
        "Q": (18, 2, 15, 2, 16), "H": (22, 2, 11, 2, 12)},
    6: {"L": (18, 2, 68, 0, 0), "M": (16, 4, 27, 0, 0),
        "Q": (24, 4, 19, 0, 0), "H": (28, 4, 15, 0, 0)},
    7: {"L": (20, 2, 78, 0, 0), "M": (18, 4, 31, 0, 0),
        "Q": (18, 2, 14, 4, 15), "H": (26, 4, 13, 1, 14)},
    8: {"L": (24, 2, 97, 0, 0), "M": (22, 2, 38, 2, 39),
        "Q": (22, 4, 18, 2, 19), "H": (26, 4, 14, 2, 15)},
    9: {"L": (30, 2, 116, 0, 0), "M": (22, 3, 36, 2, 37),
        "Q": (20, 4, 16, 4, 17), "H": (24, 4, 12, 4, 13)},
    10: {"L": (18, 2, 68, 2, 69), "M": (26, 4, 43, 1, 44),
         "Q": (24, 6, 19, 2, 20), "H": (28, 6, 15, 2, 16)},
}

_ALIGNMENT = {
    1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30], 6: [6, 34],
    7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46], 10: [6, 28, 50],
}

_EC_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}


def data_capacity(version: int, level: str) -> int:
    """Max byte-mode payload bytes for a (version, level)."""
    ec, b1, d1, b2, d2 = _EC_TABLE[version][level]
    total_data = b1 * d1 + b2 * d2
    # mode (4 bits) + char count (8 bits for v<=9, 16 for v10)
    overhead_bits = 4 + (16 if version >= 10 else 8)
    return total_data - (overhead_bits + 7) // 8


def pick_version(n_bytes: int, level: str) -> int:
    for v in range(1, 11):
        if data_capacity(v, level) >= n_bytes:
            return v
    raise ValueError(f"payload of {n_bytes} bytes exceeds version-10-{level} "
                     f"capacity ({data_capacity(10, level)})")


# -- bit stream + codewords ---------------------------------------------------

def _encode_codewords(payload: bytes, version: int, level: str) -> List[int]:
    ec, b1, d1, b2, d2 = _EC_TABLE[version][level]
    n_data = b1 * d1 + b2 * d2
    bits: List[int] = []

    def put(value: int, n: int):
        for i in range(n - 1, -1, -1):
            bits.append((value >> i) & 1)

    put(0b0100, 4)  # byte mode
    put(len(payload), 16 if version >= 10 else 8)
    for byte in payload:
        put(byte, 8)
    # terminator (up to 4 zero bits), pad to byte boundary
    free = n_data * 8 - len(bits)
    put(0, min(4, free))
    if len(bits) % 8:
        put(0, 8 - len(bits) % 8)
    codewords = [int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8)]
    pad = [0xEC, 0x11]
    i = 0
    while len(codewords) < n_data:
        codewords.append(pad[i % 2])
        i += 1
    return codewords


def _interleave(codewords: List[int], version: int, level: str) -> List[int]:
    ec, b1, d1, b2, d2 = _EC_TABLE[version][level]
    blocks: List[List[int]] = []
    pos = 0
    for _ in range(b1):
        blocks.append(codewords[pos:pos + d1])
        pos += d1
    for _ in range(b2):
        blocks.append(codewords[pos:pos + d2])
        pos += d2
    eccs = [rs_ecc(blk, ec) for blk in blocks]
    out: List[int] = []
    for i in range(max(d1, d2)):
        for blk in blocks:
            if i < len(blk):
                out.append(blk[i])
    for i in range(ec):
        for e in eccs:
            out.append(e[i])
    return out


# -- matrix construction ------------------------------------------------------

def _function_modules(version: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (matrix with function patterns placed, reserved mask)."""
    size = 17 + 4 * version
    m = np.zeros((size, size), bool)
    reserved = np.zeros((size, size), bool)

    def finder(r, c):
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                rr, cc = r + dr, c + dc
                if not (0 <= rr < size and 0 <= cc < size):
                    continue
                inside = 0 <= dr <= 6 and 0 <= dc <= 6
                dark = inside and (dr in (0, 6) or dc in (0, 6)
                                   or (2 <= dr <= 4 and 2 <= dc <= 4))
                m[rr, cc] = dark
                reserved[rr, cc] = True

    finder(0, 0)
    finder(0, size - 7)
    finder(size - 7, 0)
    # timing patterns
    for i in range(8, size - 8):
        m[6, i] = m[i, 6] = (i % 2 == 0)
        reserved[6, i] = reserved[i, 6] = True
    # alignment patterns
    centers = _ALIGNMENT[version]
    for r in centers:
        for c in centers:
            if (r < 9 and c < 9) or (r < 9 and c > size - 10) \
                    or (r > size - 10 and c < 9):
                continue  # overlaps a finder
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    m[r + dr, c + dc] = (max(abs(dr), abs(dc)) != 1)
                    reserved[r + dr, c + dc] = True
    # format info areas
    for i in range(9):
        reserved[8, i] = reserved[i, 8] = True
    for i in range(8):
        reserved[8, size - 1 - i] = reserved[size - 1 - i, 8] = True
    m[size - 8, 8] = True  # dark module
    reserved[size - 8, 8] = True
    # version info (v >= 7)
    if version >= 7:
        reserved[size - 11:size - 8, 0:6] = True
        reserved[0:6, size - 11:size - 8] = True
    return m, reserved


def _place_data(m: np.ndarray, reserved: np.ndarray,
                codewords: List[int]) -> List[Tuple[int, int]]:
    """Zigzag placement; returns the (row, col) of each data bit in order."""
    size = m.shape[0]
    bits = [(cw >> (7 - i)) & 1 for cw in codewords for i in range(8)]
    coords: List[Tuple[int, int]] = []
    bit_i = 0
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:  # skip the vertical timing column entirely
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for row in rows:
            for c in (col, col - 1):
                if reserved[row, c]:
                    continue
                if bit_i < len(bits):
                    m[row, c] = bool(bits[bit_i])
                coords.append((row, c))
                bit_i += 1
        upward = not upward
        col -= 2
    return coords


_MASKS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


def _penalty(m: np.ndarray) -> int:
    size = m.shape[0]
    score = 0
    # N1: runs of >= 5 same-color modules
    for grid in (m, m.T):
        for row in grid:
            run = 1
            for i in range(1, size):
                if row[i] == row[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        score += 3 + run - 5
                    run = 1
            if run >= 5:
                score += 3 + run - 5
    # N2: 2x2 blocks
    blocks = (m[:-1, :-1] == m[1:, :-1]) & (m[:-1, :-1] == m[:-1, 1:]) \
        & (m[:-1, :-1] == m[1:, 1:])
    score += 3 * int(blocks.sum())
    # N3: finder-like 1011101 pattern with 4 light modules on either side
    pat1 = np.array([1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0], bool)
    pat2 = pat1[::-1]
    for grid in (m, m.T):
        for row in grid:
            for i in range(size - 10):
                win = row[i:i + 11]
                if np.array_equal(win, pat1) or np.array_equal(win, pat2):
                    score += 40
    # N4: dark-module balance
    dark_pct = m.sum() * 100.0 / (size * size)
    score += 10 * int(abs(dark_pct - 50) // 5)
    return score


def _bch_format(level: str, mask: int) -> int:
    data = (_EC_BITS[level] << 3) | mask
    rem = data << 10
    gen = 0b10100110111
    for i in range(14, 9, -1):
        if rem & (1 << i):
            rem ^= gen << (i - 10)
    return ((data << 10) | rem) ^ 0b101010000010010


def _bch_version(version: int) -> int:
    rem = version << 12
    gen = 0b1111100100101
    for i in range(17, 11, -1):
        if rem & (1 << i):
            rem ^= gen << (i - 12)
    return (version << 12) | rem


def _write_format(m: np.ndarray, level: str, mask: int) -> None:
    size = m.shape[0]
    fmt = _bch_format(level, mask)
    bits = [(fmt >> i) & 1 for i in range(14, -1, -1)]  # bit14 first
    # around the top-left finder
    pos_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
             (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    # split between bottom-left and top-right
    pos_b = [(size - 1, 8), (size - 2, 8), (size - 3, 8), (size - 4, 8),
             (size - 5, 8), (size - 6, 8), (size - 7, 8),
             (8, size - 8), (8, size - 7), (8, size - 6), (8, size - 5),
             (8, size - 4), (8, size - 3), (8, size - 2), (8, size - 1)]
    for (r, c), b in zip(pos_a, bits):
        m[r, c] = bool(b)
    for (r, c), b in zip(pos_b, bits):
        m[r, c] = bool(b)


def _write_version(m: np.ndarray, version: int) -> None:
    if version < 7:
        return
    size = m.shape[0]
    v = _bch_version(version)
    for i in range(18):
        bit = bool((v >> i) & 1)
        m[size - 11 + i % 3, i // 3] = bit
        m[i // 3, size - 11 + i % 3] = bit


def encode_qr(payload: bytes, level: str = "M",
              version: Optional[int] = None,
              mask: Optional[int] = None) -> np.ndarray:
    """Encode bytes into a QR module matrix (True = dark). The mask is chosen
    by the standard's four penalty rules unless forced via `mask` (0-7)."""
    if isinstance(payload, str):
        payload = payload.encode()
    if level not in _EC_BITS:
        raise ValueError(f"EC level {level!r}: expected one of L, M, Q, H")
    if version is None:
        version = pick_version(len(payload), level)
    elif not 1 <= version <= 10:
        raise ValueError("version must be in 1..10")
    elif data_capacity(version, level) < len(payload):
        raise ValueError(f"payload too large for version {version}-{level}")
    if mask is not None and not 0 <= mask <= 7:
        raise ValueError("mask must be in 0..7")
    codewords = _interleave(_encode_codewords(payload, version, level),
                            version, level)
    base, reserved = _function_modules(version)
    coords = _place_data(base, reserved, codewords)

    best: Optional[np.ndarray] = None
    best_score = None
    candidates = range(8) if mask is None else [mask]
    for mask_id in candidates:
        mask_fn = _MASKS[mask_id]
        m = base.copy()
        for (r, c) in coords:
            if mask_fn(r, c):
                m[r, c] = not m[r, c]
        _write_format(m, level, mask_id)
        _write_version(m, version)
        score = _penalty(m)
        if best_score is None or score < best_score:
            best, best_score = m, score
    return best


def qr_matrix_to_image(matrix: np.ndarray, scale: int = 8,
                       border: int = 4) -> np.ndarray:
    """Module matrix -> uint8 grayscale image (0=dark, 255=light) with the
    standard quiet zone."""
    size = matrix.shape[0]
    img = np.full(((size + 2 * border) * scale, (size + 2 * border) * scale),
                  255, np.uint8)
    modules = np.where(matrix, 0, 255).astype(np.uint8)
    scaled = np.kron(modules, np.ones((scale, scale), np.uint8))
    off = border * scale
    img[off:off + size * scale, off:off + size * scale] = scaled
    return img
