"""The full alignment pipeline on a device mesh: inside use_mesh every
batched kernel call the engine makes (windowed bounds, banded score
passes, full fills and tracebacks) runs sharded over the mesh's cards,
bit-exact with one card (no reference counterpart: the reference's
scale-out is OpenMP threads over pairs, align_benchmark.c:232-306). Also
shows the kernels launched under the mesh and the memory report (the
mm_allocator occupancy analogue, mm_allocator.c:573-604). `--device cpu`
shards over eight CPU shards instead."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quicked_tpu_torch import generate
from quicked_tpu_torch.aligner.cascade import quicked_cascade_batch
from quicked_tpu_torch.ops import (banded_cscan_cuda, banded_cuda,
                                   banded_sysband_cuda, banded_traceback_cuda,
                                   hirschberg_split_cuda, windowed_cuda)
from quicked_tpu_torch.params import QuickedParams
from quicked_tpu_torch.parallel.mesh import make_mesh, use_mesh
from quicked_tpu_torch.utils import memreport

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (the default) or cpu (the plain PyTorch versions)")
args = ap.parse_args()

pairs = list(generate.generate_pairs(12, 400, error=0.08, seed=21))

single = quicked_cascade_batch(pairs, QuickedParams(), device=args.device)

mesh = (make_mesh(devices=["cpu"] * 8) if args.device == "cpu"
        else make_mesh())
kernels = [banded_cuda.FILL, banded_traceback_cuda.TRACEBACK,
           windowed_cuda.WINDOWED, windowed_cuda.WINDOWED_FULL,
           banded_cscan_cuda.CSCAN, banded_sysband_cuda.SYSBAND,
           hirschberg_split_cuda.HSPLIT]     # the kernels count launches
before = {k.symbol: k.launches for k in kernels}
with use_mesh(mesh):
    meshed = quicked_cascade_batch(pairs, QuickedParams(),
                                   device=args.device)
launched = {k.symbol: k.launches - before[k.symbol] for k in kernels
            if k.launches > before[k.symbol]}

assert list(single.score) == list(meshed.score)
assert single.cigar == meshed.cigar
print(f"devices: {mesh.size}; kernel launches under the mesh: {launched}")
print(f"scores: {meshed.score[:6].tolist()}... (bit-exact vs one device)")
memreport.print_report(sys.stdout)
