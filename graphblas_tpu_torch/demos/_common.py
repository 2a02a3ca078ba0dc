"""What every demo shares: the ``--device`` option."""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple


def demo_args(argv: Optional[List[str]] = None) -> Tuple[object, List[str]]:
    """(device, the other arguments) of a demo's command line: ``--device
    DEV`` (or ``--device=DEV``) may stand anywhere; without it the
    device is None, which means the card."""
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    rest = []
    k = 0
    while k < len(args):
        a = args[k]
        if a == "--device":
            if k + 1 == len(args):
                raise SystemExit("--device needs a value, such as cpu")
            device = args[k + 1]
            k += 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        k += 1
    return device, rest
