"""Run one cell of the port's benchmark; see ``portbench/harness.py``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""
import time

_T = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (the kernel's
    record of it, to 10 ms), or this script's first line."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start_ticks / os.sysconf("SC_CLK_TCK")
        return _T - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _T


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.harness import main
    raise SystemExit(main(sys.argv[1:], _process_start()))
