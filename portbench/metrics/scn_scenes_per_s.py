"""Scenes whose logits reached the host, over the window (host clock from
the first request sent to the last answer)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.total("scenes") / run.window_s
