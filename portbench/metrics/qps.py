"""qps: queries completed in the window over its wall time, results
returned to the caller as SearchResult lists."""


def read(run):
    return run.queries / run.wall_s if run.wall_s > 0 else None
