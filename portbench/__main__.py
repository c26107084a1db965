"""``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``"""

import os
import time


def _process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (Linux's ``/proc``, to its 10 ms ticks); now, where that is unreadable."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as stat, open("/proc/uptime") as uptime:
            ticks = int(stat.read().rsplit(")", 1)[1].split()[19])
            up = float(uptime.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))


STARTED = _process_start()

from portbench.run import main  # noqa: E402  (the clock starts before the imports)

main(started=STARTED)
