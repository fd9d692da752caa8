"""``calibrate.py`` with the mesh pool read from the checkout's cache, as
``run.py`` reads it (``common.CACHE / "pool"``, built and kept there the
first time), in place of meshed anew for every seed: the same arguments,
rows and output, a few seconds a seed less. The limits of
``train.mgn.fp32`` were read so.

    python3 perfbench/calibrate_cached.py --workload <cell> --seeds 1 2 3 ... [--controls 3]
        [--faults 3] [--out chiprun_out/calibrate_<cell>.jsonl]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import calibrate  # noqa: E402
from perfbench.harness import common, train  # noqa: E402
from perfbench.inputs.pool import PoolBuilder  # noqa: E402

_make_inputs = train.make_inputs


def make_inputs(cfg: dict, traffic: dict, seed: int, workers: int | None = None,
                pool: PoolBuilder | None = None) -> dict:
    """``harness/train.make_inputs`` over the cached pool, unless given one."""
    pool = pool or PoolBuilder(traffic["pool"], workers, cache=common.CACHE / "pool")
    try:
        return _make_inputs(cfg, traffic, seed, workers, pool)
    finally:
        pool.close()


if __name__ == "__main__":
    train.make_inputs = make_inputs  # what calibration_rows calls
    sys.exit(calibrate.main())
