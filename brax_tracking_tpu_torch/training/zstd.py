"""A decode-only Zstandard (RFC 8878) decoder in Python and numpy.

The JAX package's orbax checkpoints store every array chunk and every
OCDBT node as a zstd frame (``training/ocdbt.py``). The card's machine has
no ``zstandard`` and Python has no zstd module, so the port reads them
with this decoder. ``decompress`` takes one or more frames in a row
(skippable frames are skipped) and returns their content:

- single-segment and windowed frames; raw, RLE and compressed blocks;
- literals raw, RLE, or Huffman-coded in 1 or 4 streams, the Huffman table
  given by FSE-coded or direct weights or repeated from the previous block
  (treeless);
- sequences with FSE tables in predefined, RLE, compressed and repeat
  modes, and the three repeat offsets;
- the content checksum (the low 32 bits of XXH64, ``xxh64`` here) where the
  frame carries one.

A frame that needs a dictionary raises; orbax uses none. Any malformed
input raises ``ZstdError``.

Speed: the Huffman decode is vectorised. For every bit position of a
stream one numpy pass peeks the next code and its length, jump tables
compose 8 codes per step, and the Python loop only walks every 8th code;
the positions in between are filled in by numpy gathers. The
sequence loop is plain Python (float32 checkpoints have few matches).
"""

from __future__ import annotations

import numpy as np

_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK, _SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
_BLOCK_MAX = 1 << 17


class ZstdError(ValueError):
    """Malformed or unsupported zstd input."""


# --- XXH64 -------------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (((acc << 31) | (acc >> 33)) & _M64) * _P1 & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (bytes-like) with ``seed``."""
    data = bytes(data)
    n = len(data)
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=4 * stripes).tolist()
        for i in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        i = 32 * stripes
    else:
        h, i = (seed + _P5) & _M64, 0
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= int.from_bytes(data[i:i + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= data[i] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# --- bit readers ---------------------------------------------------------------


class _ForwardBits:
    """Little-endian bits from the start of ``data`` (FSE table headers)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> int:
        lo = self.pos >> 3
        chunk = self.data[lo:lo + 8]
        if (self.pos + n + 7) >> 3 > len(self.data):
            raise ZstdError("FSE table header runs past its block")
        v = (int.from_bytes(chunk, "little") >> (self.pos & 7)) & ((1 << n) - 1)
        self.pos += n
        return v

    def peek(self, n: int) -> int:
        lo = self.pos >> 3
        return (int.from_bytes(self.data[lo:lo + 8], "little") >> (self.pos & 7)) & ((1 << n) - 1)

    def nbytes(self) -> int:
        return (self.pos + 7) >> 3


class _BackwardBits:
    """A zstd backward bitstream: read from its end down to bit 0, the
    highest set bit of the last byte marking the end; past bit 0 the
    stream reads zeros, and ``pos`` goes negative (the overflow the FSE
    decoders test)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bitstream without its end marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        if p < 0:
            if p + n <= 0:
                return 0
            v = int.from_bytes(self.data[:8], "little") & ((1 << (p + n)) - 1)
            return v << -p
        lo = p >> 3
        return (int.from_bytes(self.data[lo:lo + 8], "little") >> (p & 7)) & ((1 << n) - 1)


# --- FSE ---------------------------------------------------------------------------


def _read_fse_header(data: bytes, max_log: int, max_symbol: int):
    """The normalized counts of an FSE table description at the start of
    ``data``: (counts, accuracy log, bytes read)."""
    bits = _ForwardBits(data)
    log = bits.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table has too many symbols")
        mx = 2 * threshold - 1 - remaining
        v = bits.peek(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            bits.read(nbits - 1)
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bits.read(nbits)
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                rep = bits.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return counts, log, bits.nbytes()


def _fse_table(counts, log: int):
    """The decoding table of normalized ``counts`` at accuracy ``log``:
    (symbol, bits to read, baseline of the next state) per state, as
    three lists."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE counts do not fill the table")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbol[u]
        n = nxt[s]
        nxt[s] += 1
        nb = log - (n.bit_length() - 1)
        nbits[u] = nb
        base[u] = (n << nb) - size
    return symbol, nbits, base


# --- Huffman literals -----------------------------------------------------------------


def _huffman_weights(data: bytes):
    """The weights of a Huffman tree description: (weights, bytes read)."""
    if not data:
        raise ZstdError("missing Huffman tree description")
    head = data[0]
    if head >= 128:
        n = head - 127
        nbytes = (n + 1) // 2
        if 1 + nbytes > len(data):
            raise ZstdError("truncated Huffman weights")
        w = []
        for b in data[1:1 + nbytes]:
            w.extend((b >> 4, b & 15))
        return w[:n], 1 + nbytes
    if head == 0 or 1 + head > len(data):
        raise ZstdError("bad FSE-coded Huffman weights")
    src = data[1:1 + head]
    counts, log, used = _read_fse_header(src, 6, 255)
    symbol, nbits, base = _fse_table(counts, log)
    bits = _BackwardBits(src[used:])
    s1, s2 = bits.read(log), bits.read(log)
    w = []
    while True:
        if len(w) > 254:
            raise ZstdError("too many Huffman weights")
        w.append(symbol[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            w.append(symbol[s2])
            break
        w.append(symbol[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            w.append(symbol[s1])
            break
    return w, 1 + head


def _huffman_table(data: bytes):
    """The decoding table of a Huffman tree description: (symbol per
    peek, code length per peek, max code length), and bytes read."""
    w, used = _huffman_weights(data)
    total = sum(1 << (x - 1) for x in w if x)
    if total == 0 or max(w) > 11:
        raise ZstdError("bad Huffman weights")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ZstdError("Huffman weights do not complete a tree")
    w.append(left.bit_length())
    if max_bits > 11:
        raise ZstdError("Huffman code longer than 11 bits")
    sym = np.zeros(1 << max_bits, np.uint8)
    nb = np.zeros(1 << max_bits, np.int32)
    start, starts = 0, {}
    for weight in range(1, max_bits + 1):
        starts[weight] = start
        start += w.count(weight) << (weight - 1)
    for s, weight in enumerate(w):
        if weight:
            n = 1 << (weight - 1)
            a = starts[weight]
            sym[a:a + n] = s
            nb[a:a + n] = max_bits + 1 - weight
            starts[weight] = a + n
    return (sym, nb, max_bits), used


_JUMP_LEVELS = 3  # the Python loop walks every 8th code


def _huffman_stream(src: bytes, n_out: int, table) -> np.ndarray:
    """``n_out`` symbols of one Huffman stream, which must be used up."""
    sym, nb, max_bits = table
    if n_out == 0:
        return np.zeros(0, np.uint8)
    b = np.frombuffer(src, np.uint8)
    if b.size == 0 or b[-1] == 0:
        raise ZstdError("Huffman stream without its end marker")
    total = 8 * (b.size - 1) + int(b[-1]).bit_length() - 1
    # three-byte windows at every byte, after zero bytes that stand for
    # the bits below bit 0; full[q]: the max_bits bits from window bit q
    pad = 2
    bb = np.concatenate([np.zeros(pad, np.uint8), b, np.zeros(2, np.uint8)]).astype(np.int32)
    w = bb[:-2] | (bb[1:-1] << 8) | (bb[2:] << 16)
    full = ((w[:, None] >> np.arange(8, dtype=np.int32)) & ((1 << max_bits) - 1)).ravel()
    # peek[p]: the max_bits bits below bit p, bit p - 1 the most significant
    start = 8 * pad - max_bits
    peek = full[start:start + total + 1]
    # nxt[p]: the position after the code at p; total + 1 absorbs an overrun
    after = np.arange(total + 1, dtype=np.int32) - np.take(nb, peek)
    nxt = np.append(np.where(after >= 0, after, total + 1).astype(np.int32), np.int32(total + 1))
    jumps = [nxt]
    for _ in range(_JUMP_LEVELS):
        jumps.append(np.take(jumps[-1], jumps[-1]))
    far = jumps[-1].item
    stride = 1 << _JUMP_LEVELS
    p, walk = total, []
    for _ in range(-(-n_out // stride)):
        walk.append(p)
        p = far(p)
    at = np.array(walk, np.int32)
    for level in range(_JUMP_LEVELS - 1, -1, -1):
        at = np.stack([at, np.take(jumps[level], at)], axis=1).reshape(-1)
    at = at[:n_out]
    if nxt[at[-1]] != 0 or (at > total).any():
        raise ZstdError("Huffman stream not used up exactly")
    return np.take(sym, np.take(peek, at))


def _literals(block: bytes, state: dict):
    """The literals section at the start of ``block``: (literals, bytes
    read). ``state["huffman"]`` keeps the last Huffman table."""
    if not block:
        raise ZstdError("empty compressed block")
    b0 = block[0]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if size_format in (0, 2):
            regen, head = b0 >> 3, 1
        elif size_format == 1:
            regen, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            regen, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 0:
            if head + regen > len(block):
                raise ZstdError("truncated raw literals")
            return block[head:head + regen], head + regen
        if head >= len(block):
            raise ZstdError("truncated RLE literals")
        return bytes([block[head]]) * regen, head + 1
    head, width = ((3, 10), (3, 10), (4, 14), (5, 18))[size_format]
    if len(block) < head:
        raise ZstdError("truncated literals header")
    h = int.from_bytes(block[:head], "little")
    regen = (h >> 4) & ((1 << width) - 1)
    comp = (h >> (4 + width)) & ((1 << width) - 1)
    streams = 1 if size_format == 0 else 4
    if head + comp > len(block) or regen > _BLOCK_MAX:
        raise ZstdError("literals past their block")
    src = block[head:head + comp]
    if kind == 2:
        state["huffman"], used = _huffman_table(src)
        src = src[used:]
    elif state.get("huffman") is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    table = state["huffman"]
    if streams == 1:
        out = _huffman_stream(src, regen, table)
    else:
        if len(src) < 6:
            raise ZstdError("truncated jump table")
        s1, s2, s3 = (int.from_bytes(src[i:i + 2], "little") for i in (0, 2, 4))
        edges = np.cumsum([6, s1, s2, s3])
        if edges[-1] > len(src):
            raise ZstdError("jump table past the literals")
        per = (regen + 3) // 4
        sizes = [per, per, per, regen - 3 * per]
        if sizes[3] < 0:
            raise ZstdError("bad 4-stream literal size")
        bounds = list(edges) + [len(src)]
        out = np.concatenate([
            _huffman_stream(src[bounds[i]:bounds[i + 1]], sizes[i], table) for i in range(4)
        ])
    return out.tobytes(), head + comp


# --- sequences ---------------------------------------------------------------

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
                1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (name, default table, max accuracy log, max symbol)
_SEQ_KINDS = (("ll", _LL_DEFAULT, 9, 35), ("of", _OF_DEFAULT, 8, 31), ("ml", _ML_DEFAULT, 9, 52))
_DEFAULT_TABLES = {}


def _seq_table(mode: int, data: bytes, kind, state: dict):
    """The decoding table of one sequence field in ``mode``, and bytes read."""
    name, default, max_log, max_symbol = kind
    if mode == 0:
        if name not in _DEFAULT_TABLES:
            _DEFAULT_TABLES[name] = (_fse_table(*default), default[1])
        table, used = _DEFAULT_TABLES[name], 0
    elif mode == 1:
        if not data or data[0] > max_symbol:
            raise ZstdError("bad RLE sequence symbol")
        table, used = (([data[0]], [0], [0]), 0), 1
    elif mode == 2:
        counts, log, used = _read_fse_header(data, max_log, max_symbol)
        table = (_fse_table(counts, log), log)
    else:
        table, used = state.get(name), 0
        if table is None:
            raise ZstdError("repeat sequence table without an earlier one")
    state[name] = table
    return table, used


def _sequences(data: bytes, state: dict):
    """The (literal length, offset, match length) triples of a sequences
    section; ``state`` carries the repeat offsets and tables."""
    if not data:
        raise ZstdError("missing sequences section")
    b0 = data[0]
    if b0 == 0:
        if len(data) != 1:
            raise ZstdError("bytes after an empty sequences section")
        return []
    if b0 < 128:
        n, i = b0, 1
    elif b0 < 255:
        n, i = ((b0 - 128) << 8) + data[1], 2
    else:
        n, i = data[1] + (data[2] << 8) + 0x7F00, 3
    if i >= len(data):
        raise ZstdError("truncated sequences header")
    modes = data[i]
    i += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    tables = {}
    for kind, shift in zip(_SEQ_KINDS, (6, 4, 2)):
        tables[kind[0]], used = _seq_table((modes >> shift) & 3, data[i:], kind, state)
        i += used
    (ll_sym, ll_nb, ll_base), ll_log = tables["ll"]
    (of_sym, of_nb, of_base), of_log = tables["of"]
    (ml_sym, ml_nb, ml_base), ml_log = tables["ml"]
    bits = _BackwardBits(data[i:])
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    rep = state["rep"]
    r0, r1, r2 = rep
    out = []
    for k in range(n):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31:
            raise ZstdError("offset code above 31")
        ofv = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if ofv > 3:
            off = ofv - 3
            r0, r1, r2 = off, r0, r1
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                off = r0
            elif idx == 1:
                off = r1
                r0, r1 = r1, r0
            elif idx == 2:
                off = r2
                r0, r1, r2 = r2, r0, r1
            else:
                off = r0 - 1
                r0, r1, r2 = off, r0, r1
            if off == 0:
                raise ZstdError("zero offset")
        out.append((ll, off, ml))
        if k + 1 < n:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
    if bits.pos != 0:
        raise ZstdError("sequence bitstream not used up exactly")
    state["rep"] = [r0, r1, r2]
    return out


def _compressed_block(block: bytes, out: bytearray, state: dict) -> None:
    lits, used = _literals(block, state)
    seqs = _sequences(block[used:], state)
    at = 0
    for ll, off, ml in seqs:
        if at + ll > len(lits):
            raise ZstdError("sequence past the literals")
        out += lits[at:at + ll]
        at += ll
        if off > len(out):
            raise ZstdError("match offset before the frame's start")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:
            pattern = bytes(out[start:])
            out += (pattern * (ml // off + 1))[:ml]
    out += lits[at:]


# --- frames ------------------------------------------------------------------


def _frame(data: memoryview, i: int, out: bytearray) -> int:
    """Decodes the frame whose header starts at ``data[i]`` (after its
    magic) onto ``out``; returns the index after it."""
    if i >= len(data):
        raise ZstdError("truncated frame header")
    fhd = data[i]
    i += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    if not single:
        i += 1
    did_size = (0, 1, 2, 4)[did_flag]
    if did_size and int.from_bytes(data[i:i + did_size], "little"):
        raise ZstdError("frames that need a dictionary are not supported")
    i += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fcs_size:
        content = int.from_bytes(data[i:i + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    i += fcs_size
    frame_out = bytearray()
    state = {"rep": [1, 4, 8]}
    while True:
        if i + 3 > len(data):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[i:i + 3], "little")
        i += 3
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if kind == 1:
            if i + 1 > len(data):
                raise ZstdError("truncated RLE block")
            frame_out += bytes([data[i]]) * size
            i += 1
        elif kind == 3:
            raise ZstdError("reserved block type")
        else:
            if i + size > len(data) or size > _BLOCK_MAX:
                raise ZstdError("truncated block")
            block = bytes(data[i:i + size])
            i += size
            if kind == 0:
                frame_out += block
            else:
                _compressed_block(block, frame_out, state)
        if last:
            break
    if content is not None and len(frame_out) != content:
        raise ZstdError(f"frame holds {len(frame_out)} bytes, its header says {content}")
    if checksum:
        if i + 4 > len(data):
            raise ZstdError("truncated content checksum")
        if int.from_bytes(data[i:i + 4], "little") != xxh64(frame_out) & 0xFFFFFFFF:
            raise ZstdError("content checksum mismatch")
        i += 4
    out += frame_out
    return i


def decompress(data) -> bytes:
    """The content of the zstd frames in ``data`` (bytes-like), in order;
    skippable frames are skipped."""
    data = memoryview(bytes(data))
    out = bytearray()
    i = 0
    if len(data) == 0:
        raise ZstdError("no zstd frame")
    while i < len(data):
        if i + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[i:i + 4], "little")
        i += 4
        if magic == _MAGIC:
            i = _frame(data, i, out)
        elif magic & _SKIPPABLE_MASK == _SKIPPABLE:
            if i + 4 > len(data):
                raise ZstdError("truncated skippable frame")
            i += 4 + int.from_bytes(data[i:i + 4], "little")
            if i > len(data):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
    return bytes(out)
