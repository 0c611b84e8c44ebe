"""Sequence-pair I/O: the `.seq` 2-line format and output writers.

The port's copy of quicked_tpu/seqio.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Format semantics from align_benchmark_read_input (align_benchmark.c:73-99):
pattern lines start with '>', text lines with '<'; the leading char is
stripped. The benchmark TSV output formats follow quicked_print_output
(benchmark_utils.c:151-188).
"""

from __future__ import annotations

from typing import Iterator, TextIO


def record_marker(path: str) -> bytes | None:
    """Marker byte starting each RECORD's first line: b'>' normally, but
    b'<' for flipped datasets (length_diff < 1), where generate_dataset
    prints '<long' before '>short' and the parser still takes line 1 as
    the pattern (generate_dataset.c:399-409, align_benchmark.c:88-93).
    Returns None when the first two lines don't carry two DISTINCT
    '>'/'<' markers — record starts then can't be recognized by a local
    byte scan (pair_start_at), so byte-range sharding must not be used."""
    try:
        with open(path, "rb") as f:
            m1 = f.readline()[:1]
            m2 = f.readline()[:1]
    except OSError:
        return None
    if m1 in (b">", b"<") and m2 in (b">", b"<") and m1 != m2:
        return m1
    return None


def pair_start_at(path: str, pos: int, chunk_bytes: int = 4 << 20,
                  marker: bytes = b">") -> int:
    """First byte offset >= pos that starts a pair record: a line whose
    first byte is `marker` (the file's record marker from record_marker;
    '>' for normal '>pattern/<text' files, align_benchmark.c:73-99) at
    the start of the file or immediately after a newline. Returns the
    file size when no boundary follows. The scan is local to pos — it
    never reads from the start of the file — so N processes can align
    their byte-range shards without N full-file passes."""
    import os

    size = os.path.getsize(path)
    if pos <= 0:
        return 0
    if pos >= size:
        return size
    needle = b"\n" + marker
    with open(path, "rb") as f:
        # a marker byte at pos qualifies if the previous byte is a
        # newline, so begin the search one byte early
        scan_from = pos - 1
        f.seek(scan_from)
        carry = b""
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                return size
            data = carry + chunk
            hit = data.find(needle)
            if hit >= 0:
                return scan_from - len(carry) + hit + 1
            scan_from += len(chunk)
            carry = data[-1:]


def read_seq_batches(path: str, batch_size: int,
                     chunk_bytes: int = 32 << 20,
                     start: int = 0, end: int | None = None) -> Iterator[list]:
    """Stream a .seq file as batches of (pattern, text) pairs.

    Uses CPython's text-mode readline — its C-level buffering/decoding
    beat every alternative measured at the 10M-pair scale (a ctypes C
    parser copying lines through an out-buffer: 2.6x slower;
    bytes.split + per-line decode: 2x slower; binary readline: 1.7x).

    start/end bound the byte region to parse (both should be pair
    boundaries from pair_start_at; end=None reads to EOF) — the
    byte-range sharding unit of distributed runs (parallel/distributed.py).
    """
    import io

    raw = open(path, "rb")
    raw.seek(start)
    # newline="\n": no universal-newline translation, so len(line) is
    # the exact byte count (start/end are byte offsets) and a CRLF
    # file keeps its '\r' inside the sequence — both matching the
    # reference's getline parser (align_benchmark.c:84-97)
    f = io.TextIOWrapper(raw, encoding="ascii", errors="replace",
                         newline="\n")
    try:
        remaining = None if end is None else end - start
        batch: list = []
        while remaining is None or remaining > 0:
            line1 = f.readline()
            if not line1:
                break
            line2 = f.readline()
            if not line2:
                break
            batch.append((line1[1:].rstrip("\n"), line2[1:].rstrip("\n")))
            if len(batch) >= batch_size:
                yield batch
                batch = []
            if remaining is not None:
                remaining -= len(line1) + len(line2)
                if remaining <= 0:
                    break
        if batch:
            yield batch
    finally:
        f.close()


def read_seq_pairs(path_or_file) -> Iterator[tuple[str, str]]:
    """Yield (pattern, text) pairs from a .seq file."""
    close = False
    if isinstance(path_or_file, str):
        # same decoding/newline semantics as read_seq_batches, so the
        # distributed sharding modes agree on malformed/CRLF input
        f: TextIO = open(path_or_file, "r", encoding="ascii",
                         errors="replace", newline="\n")
        close = True
    else:
        f = path_or_file
    try:
        while True:
            line1 = f.readline()
            if not line1:
                break
            line2 = f.readline()
            if not line2:
                break
            yield line1[1:].rstrip("\n"), line2[1:].rstrip("\n")
    finally:
        if close:
            f.close()


def write_seq_pairs(path_or_file, pairs) -> None:
    """Write (pattern, text) pairs in the `>pattern\\n<text\\n` format."""
    close = False
    if isinstance(path_or_file, str):
        f: TextIO = open(path_or_file, "w")
        close = True
    else:
        f = path_or_file
    try:
        for pattern, text in pairs:
            f.write(f">{pattern}\n<{text}\n")
    finally:
        if close:
            f.close()


def format_output_lite(score, cigar: str | None) -> str:
    """`score\\tCIGAR` line (benchmark_utils.c:167)."""
    return f"{score}\t{cigar if cigar is not None else '-'}"


def format_output_error(only_score: bool) -> str:
    """Failed-pair row: `ERROR\\t-` when score-only, `ERROR\\tERROR`
    otherwise (quicked_print_output_error, benchmark_utils.c:171-188)."""
    return "ERROR\t-" if only_score else "ERROR\tERROR"


def format_output_full(pattern: str, text: str, score, cigar: str | None) -> str:
    """6-column output (benchmark_utils.c:159-165)."""
    c = cigar if cigar is not None else "-"
    return f"{len(pattern)}\t{len(text)}\t{score}\t{pattern}\t{text}\t{c}"
