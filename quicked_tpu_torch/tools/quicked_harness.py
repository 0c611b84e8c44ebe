"""Test harness (tests/quicked_harness.c parity).

    python -m quicked_tpu_torch.tools.quicked_harness <pattern> <text> [<expected score>]

The port's counterpart of tools/quicked_harness. Aligns with default
(QUICKED) params, prints the score; with an expected score, exits
non-zero on mismatch. Error statuses print the reference message to
stderr and exit non-zero (e.g. the empty-sequence case,
quicked.c:411-414). The device comes from QUICKED_HARNESS_DEVICE
("cuda" by default; "cpu" runs the kernels' plain PyTorch versions).
"""

import os
import sys

from quicked_tpu_torch.api import align_pair
from quicked_tpu_torch.params import check_error, status_msg


def main(argv) -> int:
    if len(argv) < 3:
        print("Usage: quicked_harness <pattern> <text> [<expected score>]",
              file=sys.stderr)
        return 1
    device = os.environ.get("QUICKED_HARNESS_DEVICE", "cuda")
    status, score, _ = align_pair(argv[1], argv[2], device=device)
    if check_error(status):
        sys.stderr.write(status_msg(status))
        return 1
    print(f"Got score: {score}")
    if len(argv) == 4:
        expected = int(argv[3])
        # no trailing newline on success (quicked_harness.c:58-63)
        sys.stdout.write(f"Expected score: {expected}")
        if score != expected:
            sys.stdout.write("<FAIL>\n")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
