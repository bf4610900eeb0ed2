"""Generated tokens of the requests answered in the window, over the
window (host clock from the first request sent to the last answer)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.total("tokens") / run.window_s
