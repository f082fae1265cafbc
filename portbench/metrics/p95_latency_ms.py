"""p95_latency_ms: the nearest-rank 95th percentile of the latencies of
every request due in the window, each timed from its due time on the
open-loop schedule to the moment its result was in the client's hands.
A failed, refused or lost request is a miss above every success; where
the percentile lands on one, it reads as the longest wait the run
allowed."""
import math

from portbench import clients
from portbench.harness import GIVE_UP_S


def read(run):
    lat = run.outcome.latencies_s
    if not lat:
        return None
    p95 = clients.percentile(lat, 0.95)
    if math.isinf(p95):
        p95 = run.seconds + GIVE_UP_S
    return p95 * 1e3
