"""A batch of sequences in one packed buffer.

The card lane stages each batch from one buffer, not a sequence at a
time: `PackedSeqs` holds a batch's sequences as one uint8 buffer with
per-pair offsets and lengths, so that encoding, subsetting, reversing and
writing a frame are each a handful of numpy calls per batch: one index
array or mask over every byte for short reads, one slice copy a sequence
for long ones (`ROW_COPY_MIN_MEAN`).

A list of `str` packs only when every element is a `str` and the joined
text is ASCII; `PackedSeqs.of` returns None otherwise, and the caller
keeps its per-pair path. That branch is about input semantics: the
windowed bound compares true characters of non-ASCII text, the banded
lanes a replacing ASCII encode, and pre-encoded arrays are their own raw
characters; each convention stays where it is.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from quicked_tpu_torch import dna


#: The mean sequence length from which a batch's bytes are copied a
#: sequence at a time (one slice copy a sequence, about a microsecond)
#: rather than through one index array or mask over every byte (a few
#: nanoseconds a byte): long reads take the first way, short reads the
#: second.
ROW_COPY_MIN_MEAN = 1024


def _starts(lens: np.ndarray) -> np.ndarray:
    """Exclusive prefix sums of `lens` (int64): where each segment starts
    when the segments are laid end to end."""
    out = np.zeros(len(lens), dtype=np.int64)
    if len(lens) > 1:
        np.cumsum(lens[:-1], out=out[1:])
    return out


def _long(lens: np.ndarray) -> bool:
    """Whether segments of `lens` are copied a segment at a time."""
    return bool(len(lens)) and int(lens.sum()) >= ROW_COPY_MIN_MEAN * len(lens)


def _segments(data: np.ndarray, off: np.ndarray, lens: np.ndarray,
              reverse: bool = False) -> np.ndarray:
    """The segments [off[i], off[i] + lens[i]) of `data` end to end, each
    reversed with `reverse`."""
    if _long(lens):
        step = -1 if reverse else 1
        return np.concatenate([data[o:o + k][::step] for o, k in
                               zip(off.tolist(), lens.tolist())])
    # int32 indices while every one of them (at most twice the buffer's
    # length) fits
    it = np.int32 if len(data) < (1 << 30) else np.int64
    total = int(lens.sum())
    if reverse:
        src = np.repeat((off + lens - 1 + _starts(lens)).astype(it), lens)
        src -= np.arange(total, dtype=it)
    else:
        src = np.repeat((off - _starts(lens)).astype(it), lens)
        src += np.arange(total, dtype=it)
    return data[src]


class SeqViews(Sequence):
    """The segments of a packed buffer as a read-only list of uint8 array
    views, made on access (a host lane that takes one array a pair)."""

    __slots__ = ("_data", "_off", "_len")

    def __init__(self, data: np.ndarray, off: np.ndarray, lens: np.ndarray):
        self._data, self._off, self._len = data, off, lens

    def __len__(self):
        return len(self._len)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        o = int(self._off[i])
        return self._data[o:o + int(self._len[i])]

    def __iter__(self):
        d = self._data
        return (d[o:o + k] for o, k in zip(self._off.tolist(),
                                           self._len.tolist()))


class PackedSeqs:
    """Sequences as one uint8 buffer `buf` with int64 `off` and `len` per
    sequence: sequence i is buf[off[i]:off[i] + len[i]]. Its encoding in
    the 5-letter alphabet is made once (`encoded`) and carried along by
    `take` and `reversed`."""

    __slots__ = ("buf", "off", "len", "_enc", "_mask")

    def __init__(self, buf: np.ndarray, off: np.ndarray, lens: np.ndarray,
                 enc: np.ndarray | None = None):
        self.buf = buf
        self.off = np.asarray(off, dtype=np.int64)
        self.len = np.asarray(lens, dtype=np.int64)
        self._enc = enc         # `buf` encoded, laid out as `buf`
        self._mask = None       # (width, the last whole-length frame mask)

    @classmethod
    def of(cls, seqs) -> PackedSeqs | None:
        """`seqs` packed: a PackedSeqs as it is; a list of `str` whose
        joined text is ASCII in one buffer; anything else None."""
        if isinstance(seqs, PackedSeqs):
            return seqs
        try:
            joined = "".join(seqs)
        except TypeError:               # an element is not a str
            return None
        if not joined.isascii():
            return None
        lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
        return cls(np.frombuffer(joined.encode("ascii"), dtype=np.uint8),
                   _starts(lens), lens)

    @classmethod
    def of_bytes(cls, chunks) -> PackedSeqs:
        """A list of byte strings (or ASCII `str`) laid end to end."""
        chunks = [c.encode("ascii") if isinstance(c, str) else c
                  for c in chunks]
        lens = np.fromiter(map(len, chunks), dtype=np.int64,
                           count=len(chunks))
        return cls(np.frombuffer(b"".join(chunks), dtype=np.uint8),
                   _starts(lens), lens)

    @classmethod
    def concat(cls, n: int, pieces) -> PackedSeqs:
        """n segments from `pieces`, each (idx, buf, off, len): the
        piece's segment j becomes segment idx[j]. Every index in [0, n)
        must be covered once."""
        off = np.zeros(n, dtype=np.int64)
        lens = np.zeros(n, dtype=np.int64)
        bufs, base = [], 0
        for idx, buf, o, ln in pieces:
            off[idx] = np.asarray(o, dtype=np.int64) + base
            lens[idx] = ln
            bufs.append(buf)
            base += len(buf)
        buf = (np.concatenate(bufs) if bufs
               else np.zeros(0, dtype=np.uint8))
        return cls(buf, off, lens)

    def __len__(self):
        return len(self.len)

    def encoded(self) -> np.ndarray:
        """`buf` in the 5-letter alphabet (one table lookup, kept)."""
        if self._enc is None:
            self._enc = dna.encode(self.buf)
        return self._enc

    def _values(self, data: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """The first lens[i] bytes of every segment i of `data` (laid out
        as `buf`), end to end: a view where they lie so already."""
        if len(lens) and np.array_equal(lens, self.len) and \
                np.array_equal(self.off - self.off[0], _starts(lens)):
            o = int(self.off[0])
            return data[o:o + int(lens.sum())]
        return _segments(data, self.off, lens)

    def _subset(self, off, lens, reverse: bool = False) -> PackedSeqs:
        """Segments (off, lens) of `buf`, end to end in a new PackedSeqs
        (each reversed with `reverse`), its encoding too if made."""
        enc = None if self._enc is None else _segments(self._enc, off, lens,
                                                        reverse)
        return PackedSeqs(_segments(self.buf, off, lens, reverse),
                          _starts(lens), lens, enc)

    def take(self, idx) -> PackedSeqs:
        """Sequences `idx` (an index array or list), end to end in a new
        buffer; all of them in order: this one."""
        idx = np.asarray(idx, dtype=np.int64)
        if len(idx) == len(self) and \
                np.array_equal(idx, np.arange(len(idx))):
            return self
        return self._subset(self.off[idx], self.len[idx])

    def reversed(self) -> PackedSeqs:
        """Every sequence reversed, end to end in a new buffer."""
        return self._subset(self.off, self.len, reverse=True)

    def frame(self, width: int, fill, dtype, *, rows: int | None = None,
              upto=None, encoded: bool = False) -> np.ndarray:
        """A pair-major (rows, width) frame of `dtype` (rows: the count of
        sequences by default; rows past it are pad): row i holds sequence
        i's raw bytes, or its encoding with `encoded`, over its first
        min(len[i], upto[i]) columns, `fill` elsewhere: one masked
        assignment, or a slice copy a row for long sequences."""
        n = len(self)
        rows = n if rows is None else rows
        if rows < n:
            raise ValueError(f"frame of {rows} rows for {n} sequences")
        if upto is not None:
            upto = np.asarray(upto, dtype=np.int64)[:n]
            if np.all(upto >= self.len):
                upto = None
        lens = self.len if upto is None else np.minimum(self.len, upto)
        if n and int(lens.max()) > width:
            raise ValueError(f"frame {width} wide for a sequence of "
                             f"{int(lens.max())}")
        out = np.full((rows, width), fill, dtype=dtype)
        data = self.encoded() if encoded else self.buf
        if _long(lens):
            for i, (o, k) in enumerate(zip(self.off.tolist(),
                                           lens.tolist())):
                out[i, :k] = data[o:o + k]
            return out
        if upto is None and self._mask is not None and \
                self._mask[0] == width:
            mask = self._mask[1]
        else:
            mask = np.arange(width)[None, :] < lens[:, None]
            if upto is None:
                self._mask = (width, mask)
        out[:n][mask] = self._values(data, lens)
        return out

    def arrays(self) -> SeqViews:
        """The sequences' encodings as uint8 array views."""
        return SeqViews(self.encoded(), self.off, self.len)

    def raws(self) -> list:
        """The sequences' raw bytes, a `bytes` each."""
        b = self.buf.tobytes()
        return [b[o:o + k] for o, k in zip(self.off.tolist(),
                                           self.len.tolist())]

    def strs(self) -> list:
        """The sequences as `str` (the buffer is ASCII)."""
        s = self.buf.tobytes().decode("ascii")
        return [s[o:o + k] for o, k in zip(self.off.tolist(),
                                           self.len.tolist())]


def pack_pairs(patterns, texts):
    """(PackedSeqs, PackedSeqs) of a batch's patterns and texts, or None
    when either side does not pack (`PackedSeqs.of`): the caller then
    takes its per-pair path for both."""
    pp = PackedSeqs.of(patterns)
    if pp is None:
        return None
    tp = PackedSeqs.of(texts)
    return None if tp is None else (pp, tp)


def lengths(seqs) -> np.ndarray:
    """int64 lengths of a PackedSeqs or a list of sequences."""
    if isinstance(seqs, PackedSeqs):
        return seqs.len
    return np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))


def subset(seqs, idx):
    """Sequences `idx` of a PackedSeqs (`take`) or of a list."""
    if isinstance(seqs, PackedSeqs):
        return seqs.take(idx)
    return [seqs[i] for i in np.asarray(idx).tolist()]


def as_list(seqs) -> list:
    """A list of the sequences: a PackedSeqs as `str`, a list as it is."""
    return seqs.strs() if isinstance(seqs, PackedSeqs) else seqs
