"""Host ms a scene of the scene engine's plan stage in the traced waves
(``WaveStats.plan_ms``, the program's host clock around its plan-cache
lookups)."""


def read(run):
    scenes = run.total("scenes", traced=True)
    if not run.traced_stats or not scenes:
        return None
    return sum(w.plan_ms for w in run.traced_stats) / scenes
