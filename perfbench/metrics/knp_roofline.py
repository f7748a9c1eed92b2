"""knp_roofline: the least bytes of the profiled steps' KNP solves
(``roofline/knp.py``, from their iteration counts) over the card's
peak bandwidth, as a share (%) of the device time of the operations
launched inside step/knp (the union of their intervals, torch.profiler).
Nothing where the profile holds no device time.  Moves ms_per_step."""

from perfbench import trace
from perfbench.roofline.common import PEAK_BYTES_PER_S


def read(rec):
    ev = rec.get("phase_events", {}).get("step/knp")
    busy = trace.union_us(ev) * 1e-6 if ev else 0.0
    if busy <= 0:
        return None
    count = rec["roofline"]["knp"]
    its = rec["knp_iters_profiled"]
    least = sum(count(i) for i in its)
    return 100.0 * least / PEAK_BYTES_PER_S / busy
