"""emi_roofline: the least bytes of the profiled steps' EMI solves
(``roofline/emi.py``, from their iteration counts) over the card's
peak bandwidth, as a share (%) of the device time of the operations
launched inside step/emi (the union of their intervals, torch.profiler).
Nothing where the profile holds no device time.  Moves ms_per_step."""

from perfbench import trace
from perfbench.roofline.common import PEAK_BYTES_PER_S


def read(rec):
    ev = rec.get("phase_events", {}).get("step/emi")
    busy = trace.union_us(ev) * 1e-6 if ev else 0.0
    if busy <= 0:
        return None
    count = rec["roofline"]["emi"]
    its = rec["emi_iters_profiled"]
    least = sum(count(i) for i in its)
    return 100.0 * least / PEAK_BYTES_PER_S / busy
