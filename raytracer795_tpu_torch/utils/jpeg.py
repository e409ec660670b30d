"""Baseline JPEG decoder in numpy, equal byte for byte to libjpeg's output.

The JAX package reads JPEG textures through ``PIL.Image.convert("RGB")``,
which decodes with libjpeg(-turbo) at its defaults. To give the same bytes,
this decoder copies libjpeg's own integer arithmetic rather than an
arbitrary IDCT:

- the "islow" integer IDCT of jidctint.c (13-bit constants, 2 extra bits
  between the passes, descales rounding half up) and its range-limit table;
- h2v2_fancy_upsample of jdsample.c for 4:2:0 chroma: the triangle filter,
  3/4 of the nearer and 1/4 of the farther sample in each direction, with
  its +8/+7 rounding and edge rows and columns replicated;
- the fixed-point YCbCr->RGB tables of jdcolor.c (16 fraction bits).

Sequential Huffman-coded files are read (SOF0, SOF1), gray or YCbCr, with
restart intervals, and 4:4:4 or 4:2:0 sampling. Progressive and
arithmetic-coded files, other samplings and Adobe RGB or CMYK files raise
NotImplementedError naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

# natural (row-major) index of each zigzag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# jidctint.c: FIX(x) = round(x * 2**13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0_298, _F0_390, _F0_541, _F0_765 = 2446, 3196, 4433, 6270
_F0_899, _F1_175, _F1_501, _F1_847 = 7373, 9633, 12299, 15137
_F1_961, _F2_053, _F2_562, _F3_072 = 16069, 16819, 20995, 25172


def _range_limit() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by (x & 1023): x + 128 clamped
    to [0, 255] for x in [-512, 512)."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.int64)


_IDCT_LIMIT = _range_limit()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x, shift):
    """jpeg_idct_islow's 1-D pass over axis 1 of x [N, 8, ...], descaled
    by ``shift``: the even part rotates (2, 6) by c6, the odd part is the
    butterfly of (1, 3, 5, 7)."""
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * _F0_541
    tmp2 = z1 + z3 * -_F1_847
    tmp3 = z1 + z2 * _F0_765
    tmp0 = (x[:, 0] + x[:, 4]) << _CONST_BITS
    tmp1 = (x[:, 0] - x[:, 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0, t1, t2, t3 = t0 * _F0_298, t1 * _F2_053, t2 * _F3_072, t3 * _F1_501
    z1, z2 = z1 * -_F0_899, z2 * -_F2_562
    z3, z4 = z3 * -_F1_961 + z5, z4 * -_F0_390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return np.stack([_descale(v, shift) for v in out], axis=1)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Samples [N, 8, 8] (0..255) of N blocks of quantized coefficients
    [N, 8, 8] in natural order, with the quantization table [8, 8]."""
    x = coef.astype(np.int64) * quant.astype(np.int64)
    ws = _idct_1d(x, _CONST_BITS - _PASS1_BITS)              # columns
    rows = _idct_1d(ws.transpose(0, 2, 1),
                    _CONST_BITS + _PASS1_BITS + 3).transpose(0, 2, 1)
    return _IDCT_LIMIT[rows & 1023]


def h2v2_fancy_upsample(p: np.ndarray) -> np.ndarray:
    """[h, w] -> [2h, 2w]: jdsample.c's triangle filter. Each output
    sample is 3/4 of the nearer input row plus 1/4 of the farther one,
    then the same across columns; edges replicate their row or column."""
    p = p.astype(np.int64)
    up = np.concatenate([p[:1], p[:-1]])
    down = np.concatenate([p[1:], p[-1:]])
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int64)
    for k, near in ((0, up), (1, down)):
        cs = p * 3 + near
        left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        out[k::2, 0::2] = (cs * 3 + left + 8) >> 4
        out[k::2, 1::2] = (cs * 3 + right + 7) >> 4
    return out


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert with its fixed-point tables: [H, W, 3]."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)
    half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255)


class _Bits:
    """MSB-first bit reader over one entropy-coded segment (0xFF00
    unstuffed). Past the end it reads zeros, as libjpeg does at a marker."""

    def __init__(self, data: bytes):
        self.bits = "".join(f"{b:08b}" for b in data)
        self.pos = 0

    def read(self, n: int) -> int:
        s = self.bits[self.pos:self.pos + n]
        self.pos += n
        return int(s.ljust(n, "0"), 2) if n else 0

    def decode(self, table) -> int:
        maxcode, valptr, mincode, values = table
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.read(1)
            if code <= maxcode[length]:
                return values[valptr[length] + code - mincode[length]]
        raise ValueError("bad Huffman code")

    def receive_extend(self, s: int) -> int:
        v = self.read(s)
        return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _huff_table(counts, values):
    """MAXCODE, VALPTR, MINCODE (ITU T.81 F.2.2.3) and the symbols."""
    maxcode, valptr, mincode = [-1] * 17, [0] * 17, [0] * 17
    code = k = 0
    for length in range(1, 17):
        n = counts[length - 1]
        if n:
            valptr[length], mincode[length] = k, code
            code += n
            k += n
            maxcode[length] = code - 1
        code <<= 1
    return maxcode, valptr, mincode, list(values)


def _segments(data: bytes, pos: int):
    """The entropy-coded data from ``pos`` up to the next marker that is
    not a restart: (its restart intervals, unstuffed, end position)."""
    segs, cur = [], bytearray()
    while True:
        b = data[pos]
        if b != 0xFF:
            cur.append(b)
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0x00:
            cur.append(0xFF)
            pos += 2
        elif m == 0xFF:
            pos += 1
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            pos += 2
        else:
            segs.append(bytes(cur))
            return segs, pos


def read_jpeg(path: str) -> np.ndarray:
    """[H, W, 3] float32 byte values of a baseline JPEG: what
    ``PIL.Image.convert("RGB")`` gives."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"not a JPEG file: {path}")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame = None
    restart = 0
    coefs = {}
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: expected a marker at byte {pos}")
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m == 0xD9:                       # EOI
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if m == 0xDB:                       # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                qt[tq] = table.reshape(8, 8)
                i += 1 + n
        elif m == 0xC4:                     # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                table = _huff_table(counts, seg[i + 17:i + 17 + n])
                (ac_tabs if tc else dc_tabs)[th] = table
                i += 17 + n
        elif m == 0xDD:                     # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xEE and seg[:5] == b"Adobe" and seg[11] != 1:
            raise NotImplementedError(f"{path}: Adobe RGB or CMYK JPEG")
        elif m in (0xC0, 0xC1):             # baseline / extended sequential
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise NotImplementedError(f"{path}: {prec}-bit samples")
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4,
                      seg[7 + 3 * k] & 15, seg[8 + 3 * k]) for k in range(nc)]
            frame = (h, w, comps)
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = _cdiv(w, 8 * hmax), _cdiv(h, 8 * vmax)
            for cid, hs, vs, _ in comps:
                coefs[cid] = np.zeros((mcuy * vs, mcux * hs, 64), np.int64)
        elif 0xC2 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError(
                f"{path}: progressive, lossless or arithmetic-coded JPEG "
                f"(SOF marker 0x{m:02X}) is not read")
        elif m == 0xDA:                     # SOS
            ns = seg[0]
            scomps = [(seg[1 + 2 * k], seg[2 + 2 * k] >> 4,
                       seg[2 + 2 * k] & 15) for k in range(ns)]
            segs, pos = _segments(data, pos)
            _decode_scan(frame, scomps, segs, restart, coefs, dc_tabs,
                         ac_tabs)
    if frame is None:
        raise ValueError(f"{path}: no frame header")
    h, w, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    planes = []
    for cid, hs, vs, tq in comps:
        c = coefs[cid]
        by, bx = c.shape[:2]
        blocks = idct_islow(c.reshape(-1, 8, 8), qt[tq])
        plane = blocks.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(
            by * 8, bx * 8)
        dh, dw = _cdiv(h * vs, vmax), _cdiv(w * hs, hmax)
        plane = plane[:dh, :dw]
        if (hmax // hs, vmax // vs) == (2, 2) and dw > 2:
            plane = h2v2_fancy_upsample(plane)
        elif (hmax, vmax) != (hs, vs):
            raise NotImplementedError(
                f"{path}: component {cid} is sampled {hs}x{vs} of "
                f"{hmax}x{vmax}; only 4:4:4 and 4:2:0 are read")
        planes.append(plane[:h, :w])
    if len(planes) == 1:
        rgb = np.repeat(planes[0][..., None], 3, axis=2)
    elif len(planes) == 3:
        rgb = ycc_to_rgb(*planes)
    else:
        raise NotImplementedError(f"{path}: {len(planes)} components")
    return rgb.astype(np.float32)


def _decode_scan(frame, scomps, segs, restart, coefs, dc_tabs, ac_tabs):
    """Huffman-decode one sequential scan into ``coefs`` (natural order)."""
    h, w, comps = frame
    info = {c[0]: c for c in comps}
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if len(scomps) == 1:
        cid = scomps[0][0]
        _, hs, vs, _ = info[cid]
        nx = _cdiv(_cdiv(w * hs, hmax), 8)
        ny = _cdiv(_cdiv(h * vs, vmax), 8)
        units = [[(cid, y, x)] for y in range(ny) for x in range(nx)]
    else:
        mcux, mcuy = _cdiv(w, 8 * hmax), _cdiv(h, 8 * vmax)
        units = [[(cid, my * info[cid][2] + v, mx * info[cid][1] + u)
                  for cid, _, _ in scomps
                  for v in range(info[cid][2]) for u in range(info[cid][1])]
                 for my in range(mcuy) for mx in range(mcux)]
    tabs = {cid: (dc_tabs[td], ac_tabs[ta]) for cid, td, ta in scomps}
    per_seg = restart or len(units)
    for s, start in enumerate(range(0, len(units), per_seg)):
        bits = _Bits(segs[s] if s < len(segs) else b"")
        pred = dict.fromkeys(tabs, 0)
        for unit in units[start:start + per_seg]:
            for cid, by, bx in unit:
                dc, ac = tabs[cid]
                block = coefs[cid][by, bx]
                t = bits.decode(dc)
                pred[cid] += bits.receive_extend(t)
                block[0] = pred[cid]
                k = 1
                while k < 64:
                    rs = bits.decode(ac)
                    r, sz = rs >> 4, rs & 15
                    if sz:
                        k += r
                        block[_ZIGZAG[min(k, 63)]] = bits.receive_extend(sz)
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
