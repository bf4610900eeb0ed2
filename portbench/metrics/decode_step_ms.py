"""Device ms of one decode step: the summed device time of the kernels
that CUDA-graph replays ran in the traced window (each shares its
correlation id with a ``cudaGraphLaunch``), over the replays."""


def read(run):
    tr = run.trace
    if tr is None or not tr.graph_launches:
        return None
    ids = tr.graph_launches
    busy = sum(e - s for _, s, e, c in tr.device if c in ids)
    if not busy:
        return None
    return busy / 1e6 / len(ids)
