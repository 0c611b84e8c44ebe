"""Public aligner API of the port.

The counterpart of quicked_tpu/api.py: `BatchAligner` / `align_batch`
are the batch-first surface, `QuickedAligner` the reference-style
single-pair object (quicked.h:56-67, bindings/cpp/quicked.hpp:47-69),
which goes through the batch path. Every entry takes `device`: "cuda"
(the default) runs the CUDA kernels, or the host C lanes where the venue
router sends a batch (aligner/batch.py), and raises without a card;
"cpu" runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from quicked_tpu_torch.aligner.batch import BatchResult, align_batch_full
from quicked_tpu_torch.cigar import Cigar
from quicked_tpu_torch.ops import myers_np
from quicked_tpu_torch.params import (
    QuickedAlgo,
    QuickedException,
    QuickedParams,
    QuickedStatus,
    check_error,
)


def _align_one_np(pattern: str, text: str, params: QuickedParams):
    """Single-pair alignment through the exact numpy semantic model (a
    copy of quicked_tpu/api.py:_align_one_np; the `use_kernels=False`
    route). Returns (status, score, cigar_str or None).
    """
    plen, tlen = len(pattern), len(text)
    if plen == 0 or tlen == 0:
        return QuickedStatus.QUICKED_EMPTY_SEQUENCE, -1, None
    max_len = max(plen, tlen)
    algo = params.algo
    if algo == QuickedAlgo.BANDED:
        cutoff = max_len * params.bandwidth // 100
        score, ops = myers_np.banded_align(pattern, text, cutoff,
                                           only_score=params.only_score)
        status = QuickedStatus.QUICKED_WIP
    elif algo == QuickedAlgo.WINDOWED:
        score, ops, _ = myers_np.windowed_compute(
            pattern, text, 0, params.window_size, params.overlap_size,
            score_only=params.only_score)
        status = QuickedStatus.QUICKED_WIP
    elif algo == QuickedAlgo.HIRSCHBERG:
        cutoff = max_len * params.bandwidth // 100
        status, ops = myers_np.hirschberg(text, pattern, cutoff)
        score = None
    elif algo == QuickedAlgo.QUICKED:
        status, ops = myers_np.quicked_align(
            pattern, text, bandwidth=params.bandwidth,
            window_size=params.window_size, overlap_size=params.overlap_size,
            hew_threshold=params.hew_threshold,
            hew_percentage=params.hew_percentage)
        # run_quicked ignores the Hirschberg status and returns WIP
        # (quicked.c:290-305); the partial CIGAR is extracted as usual
        status = QuickedStatus.QUICKED_WIP
        score = None
    else:
        return QuickedStatus.QUICKED_UNKNOWN_ALGO, -1, None

    if check_error(status):
        # extract_results still runs on failure (quicked.c:154-157,
        # run_hirschberg): report the partial right-side CIGAR and its
        # score alongside the error status
        cigar = Cigar(operations=ops or "")
        return status, cigar.score_edit(), (cigar.sprint(True) if ops
                                            else None)
    # extract_results semantics (quicked.c:34-56): only_score keeps the
    # cigar NULL for EVERY algorithm (the score is the precomputed
    # cigar->score, == the ops' edit score when ops were computed).
    if params.only_score:
        if ops is None:
            return status, score, None
        return status, Cigar(operations=ops).score_edit(), None
    cigar = Cigar(operations=ops or "")
    return status, cigar.score_edit(), cigar.sprint(True) if ops else None


def align_batch(pairs, params: QuickedParams | None = None,
                device="cuda", timers=None) -> BatchResult:
    """Align a batch of (pattern, text) pairs."""
    return align_batch_full(pairs, params or QuickedParams(), device=device,
                            timers=timers)


def align_pair(pattern: str, text: str, params: QuickedParams | None = None,
               device="cuda"):
    """Align one pair. Returns (status, score, cigar_str|None)."""
    res = align_batch([(pattern, text)], params, device=device)
    return res.status[0], res.score[0], res.cigar[0]


class BatchAligner:
    """Batch-first aligner: align(pairs) -> BatchResult."""

    def __init__(self, params: QuickedParams | None = None, device="cuda"):
        self.params = params or QuickedParams()
        self.device = device

    def align(self, pairs: list[tuple[str, str]], timers=None) -> BatchResult:
        return align_batch(pairs, self.params, device=self.device,
                           timers=timers)


class QuickedAligner:
    """Single-pair convenience aligner (reference API parity)."""

    def __init__(self, params: QuickedParams | None = None, device="cuda"):
        self.params = params or QuickedParams()
        self.device = device
        self.score: int = -1
        self.cigar: str | None = None
        self.status: QuickedStatus = QuickedStatus.QUICKED_OK

    # Setter parity with bindings/cpp/quicked.hpp:54-63.
    def set_algorithm(self, algo: QuickedAlgo):
        self.params.algo = QuickedAlgo(algo)

    def set_only_score(self, only_score: bool):
        self.params.only_score = only_score

    def set_bandwidth(self, bandwidth: int):
        self.params.bandwidth = bandwidth

    def set_window_size(self, window_size: int):
        self.params.window_size = window_size

    def set_overlap_size(self, overlap_size: int):
        self.params.overlap_size = overlap_size

    def set_force_scalar(self, force_scalar: bool):
        self.params.force_scalar = force_scalar

    def set_hew_threshold(self, hew_threshold: int):
        self.params.hew_threshold = (hew_threshold,) * 2

    def set_hew_percentage(self, hew_percentage: int):
        self.params.hew_percentage = (hew_percentage,) * 2

    # CamelCase aliases matching the pybind11 module surface
    # (bindings/python/quicked.cpp:33-45).
    setAlgorithm = set_algorithm
    setOnlyScore = set_only_score
    setBandwidth = set_bandwidth
    setWindowSize = set_window_size
    setOverlapSize = set_overlap_size
    setForceScalar = set_force_scalar
    setHEWThreshold = set_hew_threshold
    setHEWPercentage = set_hew_percentage

    def align(self, pattern: str, text: str) -> QuickedStatus:
        status, score, cigar = align_pair(pattern, text, self.params,
                                          device=self.device)
        # results are updated before raising, as the reference binding
        # runs extract_results before throwing (quicked.cpp:30-42)
        self.status = status
        self.score = score
        self.cigar = cigar
        if check_error(status):
            raise QuickedException(status)
        return status

    def get_score(self) -> int:
        return self.score

    def get_cigar(self) -> str:
        return self.cigar if self.cigar is not None else "NULL"

    getScore = get_score
    getCigar = get_cigar
