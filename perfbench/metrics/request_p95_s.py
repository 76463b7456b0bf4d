"""95th percentile (nearest rank) of the latency of every request due in the
window, from its due time to its answer; a failed or unanswered request
counts as answered at the end of the wait, past any limit the wait shows."""
from harness.drive import latencies
from harness.stats import percentile


def read(run):
    return percentile(latencies(run["requests"], run["window"][2]), 0.95)
