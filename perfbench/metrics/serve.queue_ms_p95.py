"""95th percentile of a request's wait for the lock and the device thread (latency from due time less forward_s and transfer_s), in milliseconds."""

from perfbench.harness import readers


def read(r):
    return readers.served_ms(r, "queue_s", 95)
