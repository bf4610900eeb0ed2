"""Median, over the traced waves' requests, of the time a request waited
from its submit to its admission into a wave (``WaveStats.queue_wait_ms``,
the program's ``admit_ts - submit_ts``)."""
from portbench.spans import request_median


def read(run):
    return request_median(run, "queue_wait_ms")
