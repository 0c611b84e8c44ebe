"""Host-side batch preparation for the banded kernels.

The port's copy of quicked_tpu/ops/batch_prep.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Packs a heterogeneous batch of pairs into fixed-shape device arrays:
per-pair band geometry (banded_matrix_allocate semantics,
bpm_banded.c:112-135) is carried as lane vectors, and the PEQ is laid out
in the *shifted band frame*: row k of the shifted PEQ holds pattern block
(k - prolog_p), so the kernel's block index k = column_block + band_block
is uniform across lanes (no per-lane gathers on TPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from quicked_tpu_torch import dna
from quicked_tpu_torch.ops.myers_np import band_geometries, div_ceil, W
from quicked_tpu_torch.ops.packed import PackedSeqs, pack_pairs

TOPBIT_HI = np.uint32(0x80000000)


def _pack_peq_words(enc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pattern -> PEQ bit-words. Returns (lo, hi) of shape (num_words, 5)
    uint32, with the tail padded to all-ones (bpm_banded.c:77-86)."""
    n = len(enc)
    num_words = max(div_ceil(n, W), 1)
    bits = np.zeros((num_words * W, 5), dtype=bool)
    bits[np.arange(n), enc] = True
    bits[n:, :] = True  # tail padding: match everything
    bits = bits.reshape(num_words, 2, 32, 5)
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))[None, :, None]
    lo = (bits[:, 0].astype(np.uint64) * weights).sum(axis=1).astype(np.uint32)
    hi = (bits[:, 1].astype(np.uint64) * weights).sum(axis=1).astype(np.uint32)
    return lo, hi


_BIT_W = (np.uint32(1) << np.arange(32, dtype=np.uint32))


def _peq_words(seqs, num_words: int) -> np.ndarray:
    """(5, B, num_words, 2) little-endian u32 PEQ words of a batch: encoded
    patterns as a list of arrays or a PackedSeqs, tails padded to ones."""
    B = len(seqs)
    L = num_words * W
    if isinstance(seqs, PackedSeqs):
        # 5 = beyond-tail marker; one masked assignment for the batch
        mat = seqs.frame(L, 5, np.uint8, encoded=True)
    else:
        mat = np.full((B, L), 5, dtype=np.uint8)
        for b, e in enumerate(seqs):
            mat[b, :len(e)] = e
    # one-hot over the 5-letter alphabet; tail rows match everything
    oh = mat[None, :, :] == np.arange(5, dtype=np.uint8)[:, None, None]
    oh |= (mat == 5)[None, :, :]               # (5, B, L)
    packed = np.packbits(oh, axis=-1, bitorder="little")  # (5, B, L/8) u8
    return packed.view("<u4").reshape(5, B, num_words, 2)


def pack_peq_batch(seqs, num_words: int):
    """Vectorised batch PEQ packing: encoded patterns (a list of arrays,
    or a PackedSeqs) -> (lo, hi) of shape (num_words, 5, B) uint32, tails
    padded to ones.

    The per-pair Python loop is the host-prep bottleneck at production
    batch sizes; this packs the whole batch in a handful of numpy ops.
    """
    words = _peq_words(seqs, num_words)
    # (5, B, num_words) -> (num_words, 5, B)
    return (np.ascontiguousarray(words[..., 0].transpose(2, 0, 1)),
            np.ascontiguousarray(words[..., 1].transpose(2, 0, 1)))


def pack_peq_pair_major(seqs, num_words: int):
    """`pack_peq_batch` laid out pair-major: (lo, hi) of shape
    (B, num_words, 5) uint32."""
    words = _peq_words(seqs, num_words)
    return (np.ascontiguousarray(words[..., 0].transpose(1, 2, 0)),
            np.ascontiguousarray(words[..., 1].transpose(1, 2, 0)))


#: Device-plane fields built lazily on first access (see BandedBatch).
_PLANE_FIELDS = frozenset((
    "peq_lo", "peq_hi", "lm_lo", "lm_hi", "text", "init_scores"))
_threading = __import__("threading")


@dataclasses.dataclass
class BandedBatch:
    """Fixed-shape arrays for one kernel invocation (one bucket).

    The device planes (PEQ, level masks, text, init scores) build
    LAZILY on first attribute access via `plane_builder`: score batches
    that the venue router sends to the host C kernel never touch them and
    skip the packing. Venue decisions size the upload with the analytic
    `upload_bytes()`, not the arrays."""

    # static shape params
    B: int
    EBB: int          # static band blocks (max over batch)
    NB: int           # number of 64-column blocks
    K: int            # shifted-frame rows = NB + EBB
    full: bool        # full-matrix (traceback) variant?
    cutoff: np.ndarray       # (B,) i32
    prolog: np.ndarray
    nbr: np.ndarray          # pattern num-block-rows
    finish_v: np.ndarray
    tfinish: np.ndarray
    first0: np.ndarray
    last0: np.ndarray
    plen: np.ndarray
    tlen: np.ndarray
    # device arrays (numpy here; moved to device by the caller) —
    # None until first access when plane_builder is set
    peq_lo: np.ndarray | None = None   # (K, 5, B) u32
    peq_hi: np.ndarray | None = None
    lm_lo: np.ndarray | None = None    # (K, B) u32
    lm_hi: np.ndarray | None = None
    text: np.ndarray | None = None     # (NB*64, B) i32, a view of a
                                       # pair-major (B, NB*64) array
    init_scores: np.ndarray | None = None  # (EBB+1, B) i32
    # original encoded sequences (host references, not device data) —
    # consumed by the host C kernel (native.run_banded_native)
    enc_patterns: list | None = None
    enc_texts: list | None = None
    plane_builder: object = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        # per-instance lock: a warmup background compile and the
        # foreground call can race to the first plane access on the
        # SAME batch; unrelated batches must not serialize on it
        object.__setattr__(self, "_plane_lock", _threading.Lock())

    def __getattribute__(self, name):
        if name in _PLANE_FIELDS and \
                object.__getattribute__(self, name) is None and \
                object.__getattribute__(self, "plane_builder") is not None:
            with object.__getattribute__(self, "_plane_lock"):
                builder = object.__getattribute__(self, "plane_builder")
                if builder is not None:
                    for k, v in builder().items():
                        object.__setattr__(self, k, v)
                    object.__setattr__(self, "plane_builder", None)
        return object.__getattribute__(self, name)

    def upload_bytes(self, packed_text: bool = True) -> int:
        """Analytic staged-upload size of a score pass (PEQ lo+hi, level
        masks lo+hi, text); reading the arrays' .nbytes would trigger the
        lazy build. packed_text: one byte a character (the port stages
        every family's text as uint8); False counts 4."""
        text_b = self.NB * W * self.B * (1 if packed_text else 4)
        return self.K * self.B * 4 * (5 * 2 + 2) + text_b


def prepare_banded_batch(patterns, texts, cutoffs, *, full: bool,
                         text_finish=None, pad_to_b: int | None = None,
                         min_nb: int | None = None,
                         min_ebb: int | None = None) -> BandedBatch:
    """Build a BandedBatch from python-level pairs.

    patterns/texts: lists of str or encoded uint8 arrays, or PackedSeqs.
    A batch that packs (`packed.pack_pairs`) is encoded and framed a
    handful of numpy calls per batch; any other takes the per-pair path.
    cutoffs: per-pair cutoff scores (before the >=65 floor).
    text_finish: per-pair processed-column counts (Hirschberg midpoints);
    defaults to the full text length.
    """
    n = len(patterns)
    assert len(texts) == n and len(cutoffs) == n
    pk = pack_pairs(patterns, texts)
    if pk is not None:
        enc_p, enc_t = pk[0].arrays(), pk[1].arrays()
        plen = pk[0].len.astype(np.int32)
        tlen = pk[1].len.astype(np.int32)
    else:
        enc_p = [p if isinstance(p, np.ndarray) else dna.encode(p)
                 for p in patterns]
        enc_t = [t if isinstance(t, np.ndarray) else dna.encode(t)
                 for t in texts]
        plen = np.array([len(p) for p in enc_p], dtype=np.int32)
        tlen = np.array([len(t) for t in enc_t], dtype=np.int32)
    if text_finish is None:
        text_finish = tlen.copy()
    text_finish = np.asarray(text_finish, dtype=np.int32)

    geo = band_geometries(plen, tlen, cutoffs)
    if full:
        ebb_p = geo.ebb.astype(np.int32)
    else:
        # score-only kernel derives its own width (bpm_banded.c:801-803)
        ebb_p = (div_ceil(geo.cutoff, W) + 1).astype(np.int32)
    prolog = geo.prolog.astype(np.int32)
    cutoff = geo.cutoff.astype(np.int32)
    finish_v = (geo.prolog * W + geo.diff).astype(np.int32)
    nbr = np.maximum(div_ceil(plen, W), 1).astype(np.int32)

    B = pad_to_b or n
    assert B >= n
    EBB = int(ebb_p.max())
    if min_ebb:
        EBB = max(EBB, min_ebb)
    NB = max(div_ceil(int(text_finish.max()), W), 1)
    if min_nb:
        NB = max(NB, min_nb)
    K = NB + EBB

    def build_planes():
        # ---- PEQ + level masks, vectorised across the batch ----
        # (the per-pair packing loop is the host-prep bottleneck at
        # production batch sizes). Runs lazily on first plane access:
        # host-C-routed score batches never pay it.
        max_nw = max(div_ceil(int(plen.max()), W), 1) if n else 1
        K_ext = K + max_nw + 1
        peq_lo = np.full((K_ext, 5, B), 0xFFFFFFFF, dtype=np.uint32)
        peq_hi = np.full((K_ext, 5, B), 0xFFFFFFFF, dtype=np.uint32)
        packed_lo, packed_hi = pack_peq_batch(   # (max_nw, 5, n)
            pk[0] if pk is not None else enc_p, max_nw)
        rows = prolog[:n][None, :] + np.arange(max_nw, dtype=np.int64)[:, None]
        idx = np.broadcast_to(rows[:, None, :], (max_nw, 5, n))
        np.put_along_axis(peq_lo[:, :, :n], idx, packed_lo, axis=0)
        np.put_along_axis(peq_hi[:, :, :n], idx, packed_hi, axis=0)
        peq_lo_c = np.ascontiguousarray(peq_lo[:K])
        peq_hi_c = np.ascontiguousarray(peq_hi[:K])

        # level masks (bpm_banded.c:88-102): top bit everywhere except the
        # final pattern block when the length is not a multiple of 64
        lm_lo = np.zeros((K_ext, B), dtype=np.uint32)
        lm_hi = np.full((K_ext, B), TOPBIT_HI, dtype=np.uint32)
        nw_arr = np.maximum((plen.astype(np.int64) + W - 1) // W, 1)
        mod = plen.astype(np.int64) % W
        top = prolog[:n].astype(np.int64) + nw_arr - 1
        sel = np.nonzero(mod > 0)[0]
        if len(sel):
            m = mod[sel]
            lo_val = np.where(m <= 32,
                              np.left_shift(np.uint64(1),
                                            np.clip(m - 1, 0, 31).astype(np.uint64)),
                              0).astype(np.uint32)
            hi_val = np.where(m > 32,
                              np.left_shift(np.uint64(1),
                                            np.clip(m - 33, 0, 31).astype(np.uint64)),
                              0).astype(np.uint32)
            lm_lo[top[sel], sel] = lo_val
            lm_hi[top[sel], sel] = hi_val
        lm_lo_c = np.ascontiguousarray(lm_lo[:K])
        lm_hi_c = np.ascontiguousarray(lm_hi[:K])

        # pair-major on the host (`stage_banded` uploads it so and
        # transposes on the card); `text` is its (NB*64, B) view
        if pk is not None:
            text_pm = pk[1].frame(NB * W, 0, np.int32, rows=B,
                                  upto=text_finish, encoded=True)
        else:
            text_pm = np.zeros((B, NB * W), dtype=np.int32)
            for b in range(n):
                tl = int(text_finish[b])
                text_pm[b, :tl] = enc_t[b][:tl]
        text = text_pm.T

        # Initial scores window covers shifted rows k in [0, EBB+1):
        # value (k - prolog + 1) * 64 (bpm_reset_search,
        # bpm_banded.c:180-197; rows not in [prolog, prolog+ebb) are
        # don't-cares / fallback inits).
        k_idx = np.arange(EBB + 1, dtype=np.int32)[:, None]
        init_scores = ((k_idx - prolog[None, :n] + 1) * W).astype(np.int32)
        init_full = np.zeros((EBB + 1, B), dtype=np.int32)
        init_full[:, :n] = init_scores
        return dict(peq_lo=peq_lo_c, peq_hi=peq_hi_c,
                    lm_lo=lm_lo_c, lm_hi=lm_hi_c, text=text,
                    init_scores=init_full)

    def vec(x, fill=0):
        out = np.full(B, fill, dtype=np.int32)
        out[:n] = x
        return out

    return BandedBatch(
        B=B, EBB=EBB, NB=NB, K=K, full=full,
        plane_builder=build_planes,
        cutoff=vec(cutoff, fill=65), prolog=vec(prolog),
        nbr=vec(nbr, fill=1), finish_v=vec(finish_v),
        # pad lanes carry an EMPTY live band range [EBB-1, 0] (their
        # tfinish=0 keeps maintenance off): kernels that bound work by
        # min(first)/max(last) over the lane tile (banded_pallas) must
        # not have dead lanes pin the lower bound to row 0
        tfinish=vec(text_finish), first0=vec(prolog, fill=EBB - 1),
        last0=vec(ebb_p - 1, fill=0), plen=vec(plen, fill=1),
        tlen=vec(tlen, fill=1), enc_patterns=enc_p, enc_texts=enc_t,
    )


def extract_final_scores(batch: BandedBatch, scores_by_k: np.ndarray) -> np.ndarray:
    """Final-cell score per pair (bpm_banded.c:952-960).

    scores_by_k: (K+1, B) scores indexed by shifted row k.
    """
    plen = batch.plen.astype(np.int64)
    mod = plen % W
    final_block = np.where(mod != 0, plen // W, (plen - 1) // W)
    final_k = (final_block + batch.prolog).astype(np.int64)
    # Midpoint-stopped lanes (Hirschberg half-passes) may not reach the
    # pattern's final block row; their "final score" is meaningless and
    # unread (hirschberg_split consumes the band state instead) — clamp
    # so the gather stays in range.
    final_k = np.clip(final_k, 0, scores_by_k.shape[0] - 1)
    vals = np.take_along_axis(np.asarray(scores_by_k), final_k[None, :], axis=0)[0]
    return (vals - np.where(mod != 0, W - mod, 0)).astype(np.int64)
