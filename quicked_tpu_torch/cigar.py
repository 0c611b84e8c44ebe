"""CIGAR (alignment path) container and utilities.

The port's copy of quicked_tpu/cigar.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Re-expresses the reference CIGAR module semantics
(quicked_utils/src/cigar.c, quicked_utils/include/cigar.h:33-46):
operation strings over {M, X, I, D}, RLE text form, SAM-compliant packed
CIGAR, edit scoring, comparison, correctness checking and pretty printing.

The internal representation is a plain Python `str` of per-base operations
(the reference's `operations` char buffer between begin/end offsets).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

# SAM op codes (cigar.c:30-38)
SAM_CIGAR_MATCH, SAM_CIGAR_INS, SAM_CIGAR_DEL = 0, 1, 2
SAM_CIGAR_N_SKIP, SAM_CIGAR_EQ, SAM_CIGAR_X = 3, 7, 8
_SAM_LUT = {"M": 0, "I": 1, "D": 2, "N": 3, "=": 7, "X": 8}
_SAM_CHARS = "MIDN---=X"

_RLE_RE = re.compile(r"(\d+)([A-Za-z=])")


@dataclasses.dataclass
class Cigar:
    """An alignment path: one char in {M,X,I,D} per aligned base."""

    operations: str = ""
    score: int = 0

    # ---- construction -------------------------------------------------
    @staticmethod
    def from_rle(cigar_str: str) -> "Cigar":
        """Parse an RLE CIGAR text ("5M1X2I...") into per-base operations
        (cigar_to_operations, cigar.c:252-270)."""
        ops = []
        for num, op in _RLE_RE.findall(cigar_str):
            ops.append(op * int(num))
        return Cigar(operations="".join(ops))

    def __len__(self) -> int:
        return len(self.operations)

    def is_null(self) -> bool:
        return len(self.operations) == 0

    # ---- scoring (cigar.c:274-289) ------------------------------------
    def score_edit(self) -> int:
        """Edit score: M=0, X/I/D=1."""
        if not set(self.operations) <= set("MXID"):
            bad = next(op for op in self.operations if op not in "MXID")
            raise ValueError(f"[CIGAR] Unknown operation ({bad})")
        from quicked_tpu_torch import native
        if native.available():
            return native.cigar_score_edit(self.operations)
        return sum(1 for op in self.operations if op != "M")

    # ---- comparison (cigar.c:293-311) ----------------------------------
    def cmp(self, other: "Cigar") -> int:
        la, lb = len(self.operations), len(other.operations)
        if la != lb:
            return la - lb
        for a, b in zip(self.operations, other.operations):
            if a != b:
                return ord(a) - ord(b)
        return 0

    def __eq__(self, other) -> bool:
        if not isinstance(other, Cigar):
            return NotImplemented
        return self.operations == other.operations

    # ---- RLE / SAM text forms ------------------------------------------
    def _runs(self):
        """Iterate (length, op) RLE runs of the operation string."""
        ops = self.operations
        if not ops:
            return
        last, count = ops[0], 1
        for op in ops[1:]:
            if op == last:
                count += 1
            else:
                yield count, last
                last, count = op, 1
        yield count, last

    def sprint(self, print_matches: bool = True) -> str:
        """RLE text form (cigar_sprint, cigar.c:453-488).

        With print_matches=False, 'M' runs are omitted entirely.
        """
        from quicked_tpu_torch import native
        if native.available():
            return native.cigar_sprint(self.operations, print_matches)
        out = []
        for count, op in self._runs():
            if print_matches or op != "M":
                out.append(f"{count}{op}")
        return "".join(out)

    def sam_ops(self, show_mismatches: bool = False) -> list[tuple[int, int]]:
        """SAM-compliant packed ops as (length, opcode) pairs
        (cigar_compute_CIGAR, cigar.c:193-240).

        With show_mismatches=False, X collapses into M; with
        show_mismatches=True, M is emitted as '=' (SAM_CIGAR_EQ).
        """
        if not self.operations:
            return []
        # The reference latches the FIRST op before the X->M mapping
        # (cigar.c:210 last_op = operations[begin_offset]; the mapping
        # runs from begin_offset+1), so a leading mismatch run keeps
        # its own 'X' entry even with show_mismatches=False — reproduce
        # that quirk bit-for-bit.
        ops = self.operations
        if not show_mismatches:
            ops = ops[0] + ops[1:].replace("X", "M")
        packed = []
        for count, op in Cigar(ops)._runs():
            if show_mismatches and op == "M":
                packed.append((count, SAM_CIGAR_EQ))
            else:
                packed.append((count, _SAM_LUT.get(op, 15)))
        return packed

    def sprint_sam(self, show_mismatches: bool = False) -> str:
        """SAM CIGAR text form (cigar_sprint_SAM_CIGAR, cigar.c:504-529)."""
        out = []
        for count, code in self.sam_ops(show_mismatches):
            ch = _SAM_CHARS[code] if code <= 8 else "?"
            out.append(f"{count}{ch}")
        return "".join(out)

    # ---- editing --------------------------------------------------------
    def discover_mismatches(self, pattern: str, text: str) -> "Cigar":
        """Refine M ops into M/X by comparing sequences
        (cigar_discover_mismatches, cigar.c:323-359)."""
        out = []
        p = t = 0
        for op in self.operations:
            if p >= len(pattern) or t >= len(text):
                break
            if op in "MX":
                out.append("M" if pattern[p] == text[t] else "X")
                p += 1
                t += 1
            elif op == "I":
                out.append("I")
                t += 1
            elif op == "D":
                out.append("D")
                p += 1
            else:
                raise ValueError("[CIGAR] Wrong edit operation")
        out.append("D" * (len(pattern) - p))
        out.append("I" * (len(text) - t))
        return Cigar(operations="".join(out), score=self.score)

    # ---- checking (cigar_check_alignment, cigar.c:363-434) --------------
    def check_alignment(self, pattern: str, text: str, verbose: bool = False) -> bool:
        """Replay operations against both sequences; True iff consistent."""
        from quicked_tpu_torch import native
        # Native fast path only for pure-ASCII sequences: the ascii
        # 'replace' encoding collapses distinct non-ASCII characters to
        # '?', which would let an M op validate where the true char
        # compare below rejects.
        if not verbose and native.available() and \
                set(self.operations) <= set("MXID") and \
                pattern.isascii() and text.isascii():
            return native.cigar_check(self.operations,
                                      pattern.encode("ascii", "replace"),
                                      text.encode("ascii", "replace"))
        p = t = 0
        for op in self.operations:
            if op == "M":
                if p >= len(pattern) or t >= len(text) or pattern[p] != text[t]:
                    if verbose:
                        print(
                            f"[AlignCheck] Alignment not matching "
                            f"(pattern[{p}] != text[{t}])"
                        )
                    return False
                p += 1
                t += 1
            elif op == "X":
                if p >= len(pattern) or t >= len(text) or pattern[p] == text[t]:
                    if verbose:
                        print(
                            f"[AlignCheck] Alignment not mismatching "
                            f"(pattern[{p}] == text[{t}])"
                        )
                    return False
                p += 1
                t += 1
            elif op == "I":
                t += 1
            elif op == "D":
                p += 1
            else:
                raise ValueError(f"[AlignCheck] Unknown edit operation '{op}'")
        if p != len(pattern):
            if verbose:
                print(
                    f"[AlignCheck] Alignment incorrect length "
                    f"(pattern-aligned={p},pattern-length={len(pattern)})"
                )
            return False
        if t != len(text):
            if verbose:
                print(
                    f"[AlignCheck] Alignment incorrect length "
                    f"(text-aligned={t},text-length={len(text)})"
                )
            return False
        return True

    # ---- pretty printing (cigar_print_pretty, cigar.c:530-616) ----------
    def print_pretty(self, pattern: str, text: str) -> str:
        pattern_alg, ops_alg, text_alg = [], [], []
        p = t = 0
        for op in self.operations:
            if op == "M":
                match = pattern[p] == text[t]
                pattern_alg.append(pattern[p])
                ops_alg.append("|" if match else "X")
                text_alg.append(text[t])
                p += 1
                t += 1
            elif op == "X":
                match = pattern[p] == text[t]
                pattern_alg.append(pattern[p])
                ops_alg.append("X" if match else " ")
                text_alg.append(text[t])
                p += 1
                t += 1
            elif op == "I":
                pattern_alg.append("-")
                ops_alg.append(" ")
                text_alg.append(text[t])
                t += 1
            elif op == "D":
                pattern_alg.append(pattern[p])
                ops_alg.append(" ")
                text_alg.append("-")
                p += 1
        # trailing residues the CIGAR never consumed (partial CIGARs,
        # e.g. after non-convergence) are flagged with '?' markers
        # (cigar.c:588-598; the reference writes both tails over the
        # same columns)
        pat_tail, txt_tail = pattern[p:], text[t:]
        n_tail = max(len(pat_tail), len(txt_tail))
        if n_tail:
            pattern_alg += list(pat_tail) + [" "] * (n_tail - len(pat_tail))
            ops_alg += ["?"] * n_tail
            text_alg += list(txt_tail) + [" "] * (n_tail - len(txt_tail))
        lines = [
            f"      ALIGNMENT {self.sprint(True)}",
            f"      ETRACE    {self.sprint(False)}",
            f"      CIGAR     {self.sprint_sam(False)}",
            f"      PATTERN    {''.join(pattern_alg)}",
            f"                 {''.join(ops_alg)}",
            f"      TEXT       {''.join(text_alg)}",
        ]
        return "\n".join(lines)


def score_edit_packed(ops: np.ndarray, off, lens) -> np.ndarray:
    """`Cigar.score_edit` of many op strings at once, read where they lie
    in one buffer (`ops` uint8; string i is ops[off[i]:off[i] + lens[i]]):
    each one's count of bytes other than M, as int64. Raises the
    ValueError `score_edit` raises, for the first string in order holding
    a byte outside MXID."""
    ops = np.asarray(ops, dtype=np.uint8)
    off = np.asarray(off, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    if not len(lens):
        return np.zeros(0, dtype=np.int64)
    # reduceat over the (start, end) pairs of the strings in buffer order
    # sums each string's flags at the even rows (the odd rows are the
    # spans between strings, so the pass reads the buffer once); an empty
    # string's row is the element at its start, so it is masked to 0, and
    # a False after the buffer keeps every end in range
    order = np.argsort(off, kind="stable")
    bounds = np.stack([off[order], off[order] + lens[order]], axis=1)

    acc = np.int32 if len(ops) < (1 << 31) else np.int64

    def per_string(flags):
        sums = np.empty(len(lens), dtype=np.int64)
        sums[order] = np.add.reduceat(np.append(flags, False).view(np.uint8),
                                      bounds.ravel(), dtype=acc)[0::2]
        return np.where(lens > 0, sums, 0)

    bad = (ops != ord("M")) & (ops != ord("X")) & (ops != ord("I")) & \
        (ops != ord("D"))
    if bad.any():
        hits = np.flatnonzero(per_string(bad))
        if len(hits):
            o, k = off[hits[0]], lens[hits[0]]
            ch = ops[o:o + k][bad[o:o + k]][0]
            raise ValueError(f"[CIGAR] Unknown operation ({chr(ch)})")
    return per_string(ops != ord("M"))
