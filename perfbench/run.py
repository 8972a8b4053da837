"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>
    python3 -m perfbench.run ...            (the same)

Run from the root of a checkout.  The cell, its configuration, its traffic
mix, its lane and its metrics are found by name (``BENCHMARK.json`` and
the files under ``perfbench/``); ``src`` is put on the path here.  The run
sets up, warms the cell's own shapes, measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line as the last line of standard output (``perfbench.harness``).
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import os
import sys
import time

#: the host clock at the top of this file: the fallback for the process's
#: own start (``perfbench.harness.process_start``)
T_IMPORT = time.time()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    library that could pull JAX in."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    _environment()
    from perfbench import harness

    return harness.main(argv, t_import=T_IMPORT)


if __name__ == "__main__":
    sys.exit(main())
