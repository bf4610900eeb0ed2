"""Median, over the traced waves' requests, of the time from a request's
submit to its first token on the host's clock
(``WaveStats.first_token_ms``: the host saw the wave's last event done,
less the device time from the first token's event to that one)."""
from portbench.spans import request_median


def read(run):
    return request_median(run, "first_token_ms")
