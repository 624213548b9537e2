"""Image codecs of the port, with no image library: a baseline JPEG
encoder for the live view, a PNG writer, and the PNG reader.

The port's path imports no cv2, PIL or matplotlib, so the viewer and the
daemon encode and decode here:

* ``encode_jpeg``: baseline JPEG of a u8 gray [H, W] or BGR [H, W, 3]
  image with the IJG-scaled standard tables at quality 80 (what the live
  view asks of cv2), 4:4:4 sampling, the standard Huffman tables and
  byte stuffing, in tensor ops on the image's device (the card for the
  live view; a numpy image on the CPU).  The DCT, zig-zag and quantiser
  are one [N, 64] x [64, 64] product, the Huffman codes table lookups,
  and the items' places and the bit packing come from running sums, with
  no loop over blocks; only the stuffed bytes are read back.
* ``encode_png`` / ``write_png``: unfiltered 8-bit gray or colour PNGs.
* ``native_loader`` / ``read_png_gray``: the repository's PNG decoder
  (``native/loader.cc``: zlib inflate and the five row filters, 8-bit
  gray, gray + alpha, RGB and RGBA to gray), built for the host on first
  use; ``euroc.frames`` streams through it and ``read_png_gray`` reads
  one file, ``None`` for a truncated one.
"""
from __future__ import annotations

import functools
import struct
import zlib
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

# ITU T.81 Annex K tables: quantisation (natural order) and the Huffman
# tables as (codes per length 1..16, symbols)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]

_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "00010203110405213106124151076171132232810814429"
    "1a1b1c109233352f0156272d10a162434e125f11718191a26"
    "2728292a35363738393a434445464748494a535455565758"
    "595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
    "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
    "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each zig-zag position."""
    cells = [(y, x) for y in range(8) for x in range(8)]
    cells.sort(key=lambda c: (c[0] + c[1],
                              c[1] if (c[0] + c[1]) % 2 == 0 else c[0]))
    return np.array([y * 8 + x for y, x in cells])


_ZIGZAG = _zigzag()


def _dct_matrix() -> np.ndarray:
    """[64, 64] f32: flattened 8x8 block (row-major) -> its 2-D DCT-II
    coefficients (JPEG's FDCT, orthonormal)."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.sqrt(2 / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    c[0] /= np.sqrt(2)
    return np.kron(c, c).T.astype(np.float32)


_DCT = _dct_matrix()


JPEG_QUALITY = 80


def quant_table(base: np.ndarray) -> np.ndarray:
    """IJG's scaling of a base table to ``JPEG_QUALITY`` (50-100: scale
    200 - 2 q percent), clamped to 1..255 (baseline)."""
    scale = 200 - 2 * JPEG_QUALITY
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman(spec):
    """Code and length per symbol ([256] each) of a table given as (codes
    per length, symbols): canonical codes, as T.81 Annex C assigns."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


# [4, 2, 256] i64: (DC code, DC length, AC code, AC length) x (luma,
# chroma) x symbol
_CODES = np.stack([np.stack(pair) for pair in zip(
    *[_huffman(spec) + _huffman(spec2) for spec, spec2 in (
        (_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA))])])


# JFIF's RGB -> YCbCr (Cb and Cr then offset by 128)
_RGB_TO_YCC = np.array([[0.299, 0.587, 0.114],
                        [-0.168736, -0.331264, 0.5],
                        [0.5, -0.418688, -0.081312]], np.float32)


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """The Huffman codes; per table (luma, chroma), one [64, 64] matrix
    taking a flattened 8x8 block (row-major, level-shifted) to its
    quantised coefficients in zig-zag order before rounding (the DCT, the
    zig-zag and the division by the quantiser in one product); and the
    colour conversion, on ``device``."""
    mats = np.stack([_DCT[:, _ZIGZAG] / quant_table(base)[_ZIGZAG]
                     for base in (_Q_LUMA, _Q_CHROMA)]).astype(np.float32)
    return (torch.tensor(_CODES, device=device),
            torch.tensor(mats, device=device),
            torch.tensor(_RGB_TO_YCC, device=device))


def _bit_size(v: torch.Tensor) -> torch.Tensor:
    """JPEG magnitude category: the bit length of |v| (0 for 0)."""
    return torch.frexp(v.abs().to(torch.float32))[1].to(torch.int64)


def _coded(code, length, v, size):
    """Item value and bit length: a Huffman code followed by the ``size``
    low bits of v (v - 1 in ones' complement for a negative v)."""
    extra = torch.where(v >= 0, v, v + (1 << size) - 1)
    return (code << size) | extra, length + size


def _entropy_items(zz: torch.Tensor, table: torch.Tensor, codes):
    """The coded items of blocks ``zz`` [N, 64] i64 (quantised, zig-zag
    order, in scan order, DC already the difference to the component's
    previous block) whose Huffman tables are ``table`` [N] (0 luma, 1
    chroma): (values, bit lengths) in stream order.  Per block: its DC,
    then per nonzero AC coefficient a ZRL for each full run of 16 zeros
    before it and the coefficient, then an EOB where the block ends in
    zeros; each item's slot comes from running counts, not a loop."""
    dc_code, dc_len, ac_code, ac_len = codes
    n, dev = zz.shape[0], zz.device
    size = _bit_size(zz[:, 0])
    dc_vals, dc_lens = _coded(dc_code[table, size], dc_len[table, size],
                              zz[:, 0], size)
    nz = torch.nonzero(zz[:, 1:])
    b, k = nz[:, 0], nz[:, 1] + 1
    v = zz[b, k]
    first = torch.ones_like(b, dtype=torch.bool)
    first[1:] = b[1:] != b[:-1]
    prev = torch.zeros_like(k)
    prev[1:] = k[:-1]
    prev[first] = 0
    run = k - prev - 1
    n_zrl = run >> 4
    size = _bit_size(v)
    tb = table[b]
    sym = ((run & 15) << 4) | size
    coef_vals, coef_lens = _coded(ac_code[tb, sym], ac_len[tb, sym], v, size)
    last_k = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce(
        0, b, k, reduce="amax")
    eob = last_k < 63
    per_nz = n_zrl + 1
    items = (1 + eob.to(torch.int64)).index_add(0, b, per_nz)
    off = torch.cumsum(items, 0) - items
    total, n_zrls = torch.stack([off[-1] + items[-1], n_zrl.sum()]).tolist()
    vals = torch.zeros(total, dtype=torch.int64, device=dev)
    lens = torch.zeros_like(vals)
    vals[off], lens[off] = dc_vals, dc_lens
    excl = torch.cumsum(per_nz, 0) - per_nz
    base = torch.zeros(n, dtype=torch.int64, device=dev)
    base[b[first]] = excl[first]
    pos = off[b] + 1 + (excl - base[b]) + n_zrl
    vals[pos], lens[pos] = coef_vals, coef_lens
    owner = torch.repeat_interleave(n_zrl, output_size=n_zrls)
    j = (torch.arange(n_zrls, device=dev)
         - torch.repeat_interleave(torch.cumsum(n_zrl, 0) - n_zrl, n_zrl,
                                   output_size=n_zrls))
    zpos = pos[owner] - n_zrl[owner] + j
    vals[zpos], lens[zpos] = ac_code[tb[owner], 0xF0], ac_len[tb[owner], 0xF0]
    epos = (off + items - 1)[eob]
    vals[epos], lens[epos] = ac_code[table[eob], 0], ac_len[table[eob], 0]
    return vals, lens


def _pack_bits(vals: torch.Tensor, lens: torch.Tensor) -> bytes:
    """Concatenate the items' bits MSB first, pad the last byte with
    ones and stuff a 0x00 after every 0xFF byte.  Each item (at most 27
    bits) is shifted to its offset within the three 16-bit words it may
    span; the items' bits are disjoint, so adding them per word is their
    OR."""
    end = torch.cumsum(lens, 0)
    start = end - lens
    nbits = int(end[-1])
    word = start >> 4
    shifted = vals << (48 - (start & 15) - lens)
    words = torch.zeros((nbits >> 4) + 3, dtype=torch.int64,
                        device=vals.device)
    for lane in range(3):
        words.index_add_(0, word + lane, (shifted >> (32 - 16 * lane)) & 0xFFFF)
    out = torch.stack([words >> 8, words & 0xFF], 1).reshape(-1)
    out = out[:(nbits + 7) // 8]
    if nbits % 8:
        out[-1] |= (1 << (8 - nbits % 8)) - 1
    ff = (out == 0xFF).to(torch.int64)
    dst = torch.arange(len(out), device=out.device) + torch.cumsum(ff, 0) - ff
    # room for a 0x00 after every byte; the stuffed stream ends after the
    # last byte written, i.e. len(out) plus its count of 0xFF bytes
    stuffed = torch.zeros(2 * len(out), dtype=torch.uint8, device=out.device)
    stuffed[dst] = out.to(torch.uint8)
    host = stuffed.cpu().numpy()
    return host[:len(out) + int((host == 0xFF).sum())].tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_jpeg(img, device=None) -> bytes:
    """Baseline JPEG (JFIF) at ``JPEG_QUALITY`` of ``img``, u8 gray [H, W] or BGR [H, W, 3]
    (numpy or a tensor), computed on ``device`` (default: the tensor's
    device, the CPU for numpy): colour conversion, the DCT and
    quantisation, the entropy items and the bit packing are tensor ops
    there, and only the stuffed bytes come back."""
    img = torch.as_tensor(img)
    if img.dtype != torch.uint8 or img.dim() not in (2, 3) or (
            img.dim() == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_jpeg: u8 [H, W] or [H, W, 3], got "
                         f"{img.dtype} {tuple(img.shape)}")
    dev = torch.device(device) if device is not None else img.device
    codes, mats, rgb_to_ycc = _device_tables(dev)
    h, w = img.shape[:2]
    x = img.to(dev).to(torch.float32)     # u8 over the bus, then widened
    if x.dim() == 2:
        planes = x[None]
    else:
        planes = torch.einsum("ck,hwk->chw", rgb_to_ycc, x.flip(2))
        planes[1:] += 128.0
    nc = planes.shape[0]
    planes = torch.nn.functional.pad(planes[None], (0, -w % 8, 0, -h % 8),
                                     mode="replicate")[0] - 128.0
    hp, wp = planes.shape[1:]
    blocks = (planes.reshape(nc, hp // 8, 8, wp // 8, 8)
              .permute(0, 1, 3, 2, 4).reshape(nc, -1, 64))
    table = torch.clamp(torch.arange(nc, device=dev), max=1)
    zz = torch.round(torch.bmm(blocks, mats[table])).to(torch.int64)
    zz[:, 1:, 0] -= zz[:, :-1, 0].clone()       # DC differences
    # interleave the components block by block (one 8x8 MCU each)
    zz = zz.transpose(0, 1).reshape(-1, 64)
    vals, lens = _entropy_items(zz, table.repeat(zz.shape[0] // nc), codes)
    quants = [quant_table(base) for base in (_Q_LUMA, _Q_CHROMA)]
    head = [b"\xff\xd8",
            _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(min(nc, 2)):
        head.append(_segment(0xFFDB, bytes([t]) + bytes(
            quants[t][_ZIGZAG].astype(np.uint8))))
    head.append(_segment(0xFFC0, struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([c + 1, 0x11, min(c, 1)]) for c in range(nc))))
    specs = [(0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA),
             (0x11, _AC_CHROMA)][:2 if nc == 1 else 4]
    for tc_th, (counts, symbols) in specs:
        head.append(_segment(0xFFC4, bytes([tc_th]) + bytes(counts)
                             + bytes(symbols)))
    head.append(_segment(0xFFDA, bytes([nc]) + b"".join(
        bytes([c + 1, 0x11 * min(c, 1)]) for c in range(nc))
        + b"\x00\x3f\x00"))
    return b"".join(head) + _pack_bits(vals, lens) + b"\xff\xd9"


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit PNG of u8 gray [H, W] (colour type 0) or BGR [H, W, 3]
    (written as RGB, colour type 2); no filtering, zlib level 6."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3:
        img = img[..., ::-1]
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1)
    ctype = 2 if img.ndim == 3 else 0
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """``encode_png(img)`` written to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


@functools.lru_cache(maxsize=None)
def native_loader():
    """ctypes handle of the repository's PNG loader (``native/loader.cc``:
    one-shot ``decode_png_gray`` and the ``loader_*`` prefetch ring),
    built for this host on first use; raises when it does not build or
    load."""
    import ctypes

    from mam3slam_tpu_torch import _build

    lib = _build.host_library("loader")
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.loader_open.restype = ctypes.c_void_p
    lib.loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_int64, ctypes.c_int64]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int64, c_int_p, c_int_p]
    lib.loader_close.argtypes = [ctypes.c_void_p]
    lib.decode_png_gray.restype = ctypes.c_int
    lib.decode_png_gray.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                    ctypes.c_int64, c_int_p, c_int_p]
    return lib


_IEND = _chunk(b"IEND", b"")


def read_png_gray(path: str) -> Optional[np.ndarray]:
    """The u8 gray [H, W] image of the PNG file at ``path``, decoded by
    ``native_loader`` (8-bit, colour types 0, 2, 4 and 6, not interlaced;
    colour to gray as BT.601, within one grey level of cv2's
    IMREAD_GRAYSCALE).  ``None`` when the file does not decode or does not
    end in its IEND chunk, as cv2 gives for a file still being written."""
    import ctypes

    with open(path, "rb") as f:
        head = f.read(24)
        f.seek(max(f.seek(0, 2) - len(_IEND), 0))
        tail = f.read()
    if len(head) < 24 or head[:8] != _PNG_SIG or tail != _IEND:
        return None
    w, h = struct.unpack(">II", head[16:24])
    out = np.empty((h, w), np.uint8)
    wi, hi = ctypes.c_int(), ctypes.c_int()
    rc = native_loader().decode_png_gray(path.encode(), out.ctypes.data,
                                         out.nbytes, ctypes.byref(wi),
                                         ctypes.byref(hi))
    return out if rc == 1 and (wi.value, hi.value) == (w, h) else None
