"""Entry points for a one-device check and a multi-device dry run.

The counterpart of the repository's `__graft_entry__.py`. `entry()`
returns the flagship kernel step (the batched banded score fill) with a
staged example batch; `dryrun_multichip()` builds a mesh of n devices and
runs every stage of the engine sharded over it on small shapes, each
held to the one-device run.
"""

from __future__ import annotations

import numpy as np


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _example_banded_batch(n_pairs=8, length=192, seed=3):
    from quicked_tpu_torch import generate
    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch

    pairs = list(generate.generate_pairs(n_pairs, length, error=0.1,
                                         seed=seed))
    cutoffs = [max(len(p), len(t)) * 40 // 100 for p, t in pairs]
    return prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                                cutoffs, full=False, pad_to_b=n_pairs)


def entry(device="cuda"):
    """(fn, args): one batched banded score-only fill (the BandEd DP) and
    its example batch staged on `device`; fn(*args) returns the fill's
    output dict there."""
    from quicked_tpu_torch.ops.banded_cuda import fill_staged, stage_banded

    return fill_staged, (stage_banded(_example_banded_batch(), device),)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Build a mesh of n devices (every one a card, cuda:0 .. n-1, or n
    shards on the CPU for device="cpu") and run the full step sharded
    over it on small shapes: the banded score, the windowed bound (at
    least the banded score), the full fill with its band planes, the
    complete QuickEd cascade under `use_mesh` and the Hirschberg driver
    with real split levels (a 16 KiB budget), the last two equal to the
    one-device run. Raises RuntimeError on any mismatch."""
    from quicked_tpu_torch import generate
    from quicked_tpu_torch.aligner import hirschberg as hmod
    from quicked_tpu_torch.aligner.cascade import quicked_cascade_batch
    from quicked_tpu_torch.device import resolve_device
    from quicked_tpu_torch.ops.batch_prep import (extract_final_scores,
                                                  prepare_banded_batch)
    from quicked_tpu_torch.ops.windowed_cuda import prepare_windowed_batch
    from quicked_tpu_torch.params import QuickedParams
    from quicked_tpu_torch.parallel.mesh import (make_mesh,
                                                 run_banded_sharded,
                                                 run_windowed_sharded,
                                                 use_mesh)

    dev = resolve_device(device)
    mesh = (make_mesh(devices=[dev] * n_devices) if dev.type == "cpu"
            else make_mesh(n_devices))
    n_pairs = 2 * n_devices
    pairs = list(generate.generate_pairs(n_pairs, 160, error=0.1, seed=5))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * 40 // 100 for p, t in pairs]

    batch = prepare_banded_batch(pats, txts, cutoffs, full=False,
                                 pad_to_b=n_pairs)
    out = run_banded_sharded(batch, mesh)
    scores = extract_final_scores(batch, out["scores_by_k"][:, :n_pairs])
    _check(np.all(scores >= 0), f"banded scores {scores}")

    wbatch = prepare_windowed_batch(pats, txts, window_size=2,
                                    pad_to_b=n_pairs)
    wscore, _ = run_windowed_sharded(wbatch, 40, 2, 1, mesh)
    # the windowed score is an upper bound of the exact banded score
    _check(np.all(wscore[:n_pairs] >= scores),
           f"windowed bound {wscore} below the banded score {scores}")

    # the full fill: the traceback's band planes sharded on lanes
    fbatch = prepare_banded_batch(pats[:n_devices], txts[:n_devices],
                                  cutoffs[:n_devices], full=True,
                                  pad_to_b=n_devices)
    fout = run_banded_sharded(fbatch, mesh)
    _check("mat_pv_lo" in fout and fout["mat_pv_lo"].shape[-1] == n_devices,
           "the sharded full fill returned no band planes")

    # the complete pipeline under the mesh: the cascade (windowed bounds,
    # banded scores, full fills and tracebacks) and the Hirschberg
    # driver's split levels, bit-exact with one device
    base = quicked_cascade_batch(pairs, QuickedParams(), device=dev)
    with use_mesh(mesh):
        meshed = quicked_cascade_batch(pairs, QuickedParams(), device=dev)
    _check([int(s) for s in base.status] == [int(s) for s in meshed.status]
           and np.array_equal(base.score, meshed.score)
           and base.cigar == meshed.cigar,
           "the cascade under the mesh differs from one device")

    hpairs = list(generate.generate_pairs(3, 600, error=0.12, seed=9))
    hcut = [max(len(p), len(t)) * 15 // 100 for p, t in hpairs]
    saved = hmod.HIRSCHBERG_BUFFER_SIZE
    hmod.HIRSCHBERG_BUFFER_SIZE = 1 << 14   # force real split levels
    try:
        hbase = hmod.hirschberg_batch([t for _, t in hpairs],
                                      [p for p, _ in hpairs], hcut,
                                      device=dev)
        with use_mesh(mesh):
            hmesh = hmod.hirschberg_batch([t for _, t in hpairs],
                                          [p for p, _ in hpairs], hcut,
                                          device=dev)
    finally:
        hmod.HIRSCHBERG_BUFFER_SIZE = saved
    _check(hbase == hmesh and any(ops for _, ops in hbase),
           "the Hirschberg driver under the mesh differs from one device")
